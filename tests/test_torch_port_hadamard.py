"""The Hadamard-rotation quantizer path of the port against the JAX package,
on the CPU.

Kernels: inputs made with numpy from a seed go through the Pallas kernels in
interpret mode and through the port's wrappers on CPU tensors, which run the
plain versions: the K-blocked int4 DRQ matmul (pallas_qmatmul.py:882) bit
for bit; the weight-only (:199) and blockwise (:461) packed matmuls
within `int_weights_tolerance` (f32 sums in another order).

Executor: one packed int4 FC of each kind (blockwise, DRQ with K > 8192,
weight-only) run by both executors on the CPU, where the port used to raise.

Algorithms and ops: OCTAV clipping, the Hadamard rotation, the MSE,
dequantized-weight-recovery and float-casting parameters, the
HADAMARD_ROTATION op and the decomposed rotation's BATCH_MATMUL at bf16.

Slice: the toy serving graph at F 16384 quantized by each package's own
Quantizer under gemma_mixed48_hr and served by each package's DecodeServer:
the rotation before each down FC keeps the MLP unfused, so the down FC
(K 16384) takes the K-blocked kernel. The JAX side runs with AEQT_INT4_DRQ=1
and its int8 dispatchers patched to interpret-mode Pallas, as in
tests/test_torch_port_int_qmatmul.py.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fixtures
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu import qtyping as jax_qtyping
from ai_edge_quantizer_tpu.algorithms.nonlinear import (
    float_casting as jax_float_casting)
from ai_edge_quantizer_tpu.algorithms.uniform import (
    dequant_recovery as jax_dequant_recovery)
from ai_edge_quantizer_tpu.algorithms.uniform import hadamard as jax_hadamard
from ai_edge_quantizer_tpu.algorithms.uniform import mse as jax_mse
from ai_edge_quantizer_tpu.algorithms.uniform import octav as jax_octav
from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.ops import impl as jax_impl
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu.recipe import recipe as jax_recipe
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.nonlinear import float_casting
from ai_edge_quantizer_tpu_torch.algorithms.uniform import dequant_recovery
from ai_edge_quantizer_tpu_torch.algorithms.uniform import hadamard
from ai_edge_quantizer_tpu_torch.algorithms.uniform import mse
from ai_edge_quantizer_tpu_torch.algorithms.uniform import octav
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import head
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.ops import impl
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_int_qmatmul import _fusion_units
from test_torch_port_int_qmatmul import _interpreted_dispatchers
from test_torch_port_quantizer import to_port_graph
from test_torch_port_serving import BENCH_KW, SERVE_CFG, SLOTS
from test_torch_port_serving import _finished, _metrics, _serve, _trace
from test_torch_port_serving import _track
from test_torch_port_slice import JAX_SERVING_ENV

KBLOCK = pq.qmatmul_int4_packed_drq_kblock
WO = pq.qmatmul_int4_packed
BLOCKWISE = pq.qmatmul_int4_packed_blockwise
_BF16_EPS = 2.0**-8  # unit roundoff of bf16


def _packed_inputs(seed, m, n, k, scale_shape, bias):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w = rng.integers(-8, 8, (n, k)).astype(np.int8)
  s = (rng.random(scale_shape) * 0.01 + 0.001).astype(np.float32)
  b = rng.standard_normal(n).astype(np.float32) if bias else None
  packed = np.asarray(pallas_qmatmul.pack_int4_split(jnp.asarray(w)))
  return x, packed, s, b


def _t(a):
  return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
  return None if a is None else jnp.asarray(a)


def _as_f32(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- the K-blocked int4 DRQ kernel (pallas_qmatmul.py:882) --------------------


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kblock_matches_pallas_bit_for_bit(dtype, bias):
  """M 1, 7 and 64; K 16384 (the down projection, bk 4096: two K steps) and
  K 512 with bk 128 (four K steps of 64 packed bytes). Without a bias every
  output equals the Pallas kernel's bit for bit. With a bias, XLA's CPU
  backend contracts the kernel's `y * s + b` into one FMA; the Pallas source
  rounds the product first, as the CUDA kernel and the plain version do:
  the port equals the kernel without the bias plus the bias (rounded once
  more to bf16 for bf16 x) bit for bit, and the kernel with the bias to the
  FMA's one rounding (f32) or one bf16 ulp."""
  for m, k, bk in ((1, 16384, 4096), (7, 16384, 4096), (64, 16384, 4096),
                   (7, 512, 128), (64, 512, 128)):
    x, w, s, b = _packed_inputs(m + k, m, 128, k, (128,), bias)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(_as_f32(jx)).to(getattr(torch, dtype))

    def pallas(x_in, bias_arr):
      return _as_f32(pallas_qmatmul.qmatmul_pallas_int4_packed_drq_kblock(
          x_in, _j(w), _j(s), _j(bias_arr), bk=bk, interpret=True))

    before = (KBLOCK.launches, KBLOCK.plain_calls)
    got = KBLOCK(tx, _t(w), _t(s), _t(b))
    assert (KBLOCK.launches, KBLOCK.plain_calls) == (before[0],
                                                     before[1] + 1)
    assert got.dtype == tx.dtype and got.shape == (m, 128)
    got = got.float().numpy()
    if not bias:
      np.testing.assert_array_equal(got.view(np.int32),
                                    pallas(jx, None).view(np.int32))
      continue
    # The f32 product (acc * xs) * s of the same codes: x widened to f32
    # quantizes to the same codes and scales.
    product = pallas(jx.astype(jnp.float32), None)
    want = product + b
    if dtype == 'bfloat16':
      want = want.astype(ml_dtypes.bfloat16).astype(np.float32)
      bound = _BF16_EPS * np.abs(want)
    else:
      bound = 2.0**-23 * (np.abs(product) + np.abs(b))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.all(np.abs(got - pallas(jx, b)) <= bound)


def near_tie_rows(seed, rows=64, k=256):
  """f32 rows whose codes lie within two ulps of a half step: absmax 1, so
  xs = f32(1/127), and the other values (j + 0.5) * xs nudged by up to two
  ulps either way. rint(x / xs) and rint(x * (1 / xs)) differ on many."""
  rng = np.random.default_rng(seed)
  step = np.float64(np.float32(1.0 / 127.0))
  x = ((rng.integers(-126, 126, (rows, k - 1)) + 0.5) * step).astype(
      np.float32)
  for _ in range(2):
    nudge = rng.integers(-1, 2, x.shape)
    x = np.where(nudge > 0, np.nextafter(x, np.float32(np.inf)),
                 np.where(nudge < 0, np.nextafter(x, np.float32(-np.inf)),
                          x)).astype(np.float32)
  return np.concatenate([np.ones((rows, 1), np.float32), x], axis=1)


def test_kblock_quantizes_by_division():
  """The K-blocked kernel's codes are rint(x / xs), not the non-blocked
  kernel's rint(x * (1 / xs)): on rows near the half steps, where the two
  differ, the port gives the division's codes, and the matmul equals the
  Pallas function's bit for bit."""
  x = near_tie_rows(11)
  xq, xs = pq.quantize_rows_drq_div(torch.from_numpy(x))
  xs_np = np.maximum(np.abs(x).max(axis=1, keepdims=True),
                     np.float32(1e-9)) * np.float32(1.0 / 127.0)
  np.testing.assert_array_equal(xs.numpy(), xs_np)
  np.testing.assert_array_equal(xq.numpy(),
                                np.rint(x / xs_np).astype(np.int8))
  by_reciprocal = pq.quantize_rows_drq(torch.from_numpy(x))[0]
  assert int(torch.sum(xq != by_reciprocal)) > 100
  _, w, s, _ = _packed_inputs(12, 1, 128, 256, (128,), False)
  want = _as_f32(pallas_qmatmul.qmatmul_pallas_int4_packed_drq_kblock(
      jnp.asarray(x), _j(w), _j(s), interpret=True))
  got = KBLOCK(torch.from_numpy(x), _t(w), _t(s)).numpy()
  np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the weight-only and blockwise packed kernels: plain versions -------------


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_weight_only_packed_matches_pallas(dtype, bias):
  """qmatmul_pallas_int4_packed (:199): f32 sums of the two halves in
  another order, so within int_weights_tolerance of max |y| (plus one bf16
  rounding of |y| for bf16 x, whose output is stored in bf16)."""
  k, n = 1024, 256
  x, w, s, b = _packed_inputs(21, 12, n, k, (n,), bias)
  jx = jnp.asarray(x, dtype)
  want = _as_f32(pallas_qmatmul.qmatmul_pallas_int4_packed(
      jx, _j(w), _j(s), _j(b), interpret=True))
  tx = torch.from_numpy(_as_f32(jx)).to(getattr(torch, dtype))
  before = WO.plain_calls
  got = WO(tx, _t(w), _t(s), _t(b))
  assert WO.plain_calls == before + 1 and got.dtype == tx.dtype
  got = got.float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, 0, float(np.abs(want).max()))
  if dtype == 'bfloat16':
    tol = tol + _BF16_EPS * np.abs(want)
  assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('block_size', [128, 256])
def test_blockwise_packed_matches_pallas(block_size, bias):
  """qmatmul_pallas_int4_packed_blockwise (:461) with [N, K/bs] scales:
  within int_weights_tolerance of max |y|, at f32 and at bf16 x (an f32
  output cast to bf16: one more bf16 rounding). A high-nibble block's scale
  doubled moves y far beyond the tolerance, so the pairing of blocks and
  scale columns is checked."""
  k, n = 1024, 256
  x, w, s, b = _packed_inputs(31 + block_size, 10, n, k,
                              (n, k // block_size), bias)
  for dtype in ('float32', 'bfloat16'):
    jx = jnp.asarray(x, dtype)
    want = _as_f32(pallas_qmatmul.qmatmul_pallas_int4_packed_blockwise(
        jx, _j(w), _j(s), _j(b), block_size=block_size, interpret=True))
    tx = torch.from_numpy(_as_f32(jx)).to(getattr(torch, dtype))
    before = BLOCKWISE.plain_calls
    got = BLOCKWISE(tx, _t(w), _t(s), _t(b))
    assert BLOCKWISE.plain_calls == before + 1 and got.dtype == tx.dtype
    got = got.float().numpy()
    tol = int_qmatmul.int_weights_tolerance(k, block_size,
                                            float(np.abs(want).max()))
    if dtype == 'bfloat16':
      tol = tol + _BF16_EPS * np.abs(want)
    else:
      want32, tol32 = want, tol
    assert np.all(np.abs(got - want) <= tol)
  s2 = s.copy()
  s2[:, k // block_size // 2] *= 2  # the first high-nibble block
  bad = BLOCKWISE(torch.from_numpy(x), _t(w), _t(s2), _t(b)).numpy()
  assert np.abs(bad - want32).max() > 100 * tol32


# -- the packed-FC branch of the executor on the CPU --------------------------


def _recipe_4bit(granularity):
  entries = jax_recipe.dynamic_wi4_afp32()
  for e in entries:
    e['op_config']['weight_tensor_config']['granularity'] = granularity
  return entries


# kind -> (recipe, K, N, bias inside the kernel, DRQ, kernel wrapper)
FC_KINDS = {
    'blockwise': (_recipe_4bit('BLOCKWISE_128'), 1024, 256, True, True,
                  BLOCKWISE),
    # N 128 pads to 512: the bias is added after the kernel, as in JAX.
    'drq_kblock': (_recipe_4bit('CHANNELWISE'), 16384, 128, False, True,
                   KBLOCK),
    'weight_only': (_recipe_4bit('CHANNELWISE'), 1024, 256, True, False,
                    WO),
}


@pytest.mark.parametrize('kind', sorted(FC_KINDS))
def test_packed_fc_branch_runs_on_cpu(kind, monkeypatch):
  """One packed int4 FC through both executors on the CPU (f32
  activations): the route the JAX executor takes off its accelerator, the
  plain version the port's wrapper runs, the same result (the K-blocked
  DRQ FC bit for bit, the others within int_weights_tolerance)."""
  recipe, k, n, _, drq, fn = FC_KINDS[kind]
  monkeypatch.setenv('AEQT_INT4_DRQ', '1' if drq else '0')
  jgraph = fixtures.single_fc(seed=5, in_dim=k, out_dim=n, batch=3)
  tgraph = to_port_graph(jgraph)
  jq = JaxQuantizer(jgraph, recipe).quantize().quantized_model
  tq = Quantizer(tgraph, recipe).quantize().quantized_model
  jex = jax_executor.GraphExecutor(jq)
  jex.prepare_serving_weights(min_weight_params=0)
  tex = executor.GraphExecutor(tq, device='cpu', activation_dtype='float32',
                               int4_drq=drq)
  tex.prepare_serving_weights(min_weight_params=0)
  assert tex._packed_int4_keys == jex._packed_int4_keys != set()
  assert tex._packed_block_size == jex._packed_block_size
  x = np.random.default_rng(6).standard_normal((3, k)).astype(np.float32)
  want = {name: np.asarray(v) for name, v in jex({'x': x}).items()}
  before = fn.plain_calls
  got = {name: v.numpy() for name, v in tex({'x': _t(x)}).items()}
  assert fn.plain_calls == before + 1
  assert got.keys() == want.keys()
  for name in want:
    if kind == 'drq_kblock':
      np.testing.assert_array_equal(got[name], want[name])
    else:
      bs = 128 if kind == 'blockwise' else 0
      tol = int_qmatmul.int_weights_tolerance(
          k, bs, float(np.abs(want[name]).max()))
      assert np.abs(got[name] - want[name]).max() <= tol


# -- the algorithms ------------------------------------------------------------


@pytest.mark.parametrize('num_bits', [4, 8])
def test_octav_clipping_matches_jax(num_bits):
  rng = np.random.default_rng(num_bits)
  w = (rng.standard_t(3, (64, 256)) * 0.05).astype(np.float32)
  for axes in ((1,), 1, (0,), None, (2,)):
    data = w.reshape(64, 4, 64) if axes == (2,) else w
    got = octav.compute_clipping_octav(data, num_bits, axes)
    want = jax_octav.compute_clipping_octav(data, num_bits, axes)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_hadamard_rotation_matches_jax():
  rng = np.random.default_rng(3)
  for size in (1, 2, 8, 512):
    np.testing.assert_array_equal(hadamard.normalized_hadamard(size),
                                  jax_hadamard.normalized_hadamard(size))
  for dim, cap in ((2048, 512), (16384, 512), (96, 512), (256, 64)):
    assert hadamard.pick_hadamard_size(dim, cap) == \
        jax_hadamard.pick_hadamard_size(dim, cap)
  data = rng.standard_normal((16, 2048)).astype(np.float32)
  for size in (32, 512):
    got = hadamard.rotate_last_dim(data, size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got,
                                  jax_hadamard.rotate_last_dim(data, size))
  with pytest.raises(ValueError, match='power of 2'):
    hadamard.normalized_hadamard(12)


def _op_info(mod, qt, op_name, w_cfg):
  """An OpInfo of a weight-bearing op with weight config w_cfg."""
  op = mod.Op(opcode=op_name, inputs=[0], outputs=[0])
  return qt.OpInfo(op=op, op_name=qt.OpName(op_name), subgraph_op_index=0,
                   op_quant_config=qt.OpQuantizationConfig(
                       weight_tensor_config=w_cfg))


def _params_record(p):
  if p is None:
    return None
  return {f.name: (np.asarray(v).dtype.str, np.asarray(v).shape,
                   np.asarray(v).tobytes())
          if isinstance(v, np.ndarray) else repr(v)
          for f in dataclasses.fields(p) for v in (getattr(p, f.name),)}


def _config(qt, bits, granularity, dtype='INT'):
  return qt.TensorQuantizationConfig(
      num_bits=bits, symmetric=True,
      granularity=qt.QuantGranularity(granularity),
      dtype=qt.TensorDataType(dtype))


@pytest.mark.parametrize('algorithm', ['octav', 'mse', 'dequant_recovery',
                                       'float_casting'])
def test_weight_params_match_jax(algorithm):
  """Each algorithm's weight parameters (scales, zero points, quantized
  data) equal the JAX package's bit for bit: channelwise, tensorwise and,
  where the algorithm takes it, blockwise; an activation (no content, a
  calibrated min and max) falls back as in JAX."""
  rng = np.random.default_rng(7)
  w = (rng.standard_normal((32, 256)) * 0.1).astype(np.float32)
  port_mod, jax_mod = {
      'octav': (octav, jax_octav), 'mse': (mse, jax_mse),
      'dequant_recovery': (dequant_recovery, jax_dequant_recovery),
      'float_casting': (float_casting, jax_float_casting)}[algorithm]
  cases = [(8, 'CHANNELWISE'), (4, 'CHANNELWISE'), (4, 'TENSORWISE')]
  if algorithm in ('octav', 'dequant_recovery'):
    cases.append((4, 'BLOCKWISE_32'))
  if algorithm == 'dequant_recovery':
    # A weight on a 4-bit grid, as a QAT export leaves it.
    w = (rng.integers(-8, 8, (32, 256)) * np.float32(0.0125)).astype(
        np.float32)
  if algorithm == 'float_casting':
    cases = [(16, 'TENSORWISE')]
  for bits, gran in cases:
    dtype = 'FLOAT' if algorithm == 'float_casting' else 'INT'
    records = []
    for mod, qt, irm in ((port_mod, qtyping, ir),
                         (jax_mod, jax_qtyping, jax_ir)):
      cfg = _config(qt, bits, gran, dtype)
      info = _op_info(irm, qt, 'FULLY_CONNECTED', cfg)
      act = qt.TensorQuantizationConfig(num_bits=8, symmetric=False)
      qsv = {'min': np.array([-1.5], np.float32),
             'max': np.array([2.5], np.float32)}
      records.append((_params_record(mod.get_tensor_quant_params(
          info, cfg, np.array(w))), _params_record(
              mod.get_tensor_quant_params(info, act, None, qsv))))
    assert records[0] == records[1], (bits, gran)


# -- the ops the rotation inserts ----------------------------------------------


def _op_pair(opcode, attrs, out_shape):
  out = []
  for mod, implm in ((jax_ir, jax_impl), (ir, impl)):
    sg = mod.Subgraph(name='main')
    sg.tensors.append(mod.Tensor(name='out', shape=out_shape,
                                 dtype='float32'))
    op = mod.Op(opcode=opcode, inputs=[], outputs=[0], attrs=dict(attrs))
    out.append(implm.OpContext(op=op, subgraph=sg, graph=mod.Graph()))
  return out


@pytest.mark.parametrize('decomposed', [False, True])
def test_rotation_ops_match_jax_at_bf16(decomposed):
  """The HADAMARD_ROTATION op and the decomposed rotation's BATCH_MATMUL
  (bf16 x [..., K/h, h] against the f32 Hadamard constant, as the serving
  executor feeds it) at bf16 activations: f32 sums in another order, then
  one bf16 rounding, so each output is within one bf16 ulp of JAX's and
  nearly all are equal; at f32 within a few f32 ulps."""
  rng = np.random.default_rng(9)
  x = rng.standard_normal((4, 2, 2048)).astype(np.float32)
  h = hadamard.normalized_hadamard(512)
  for dtype in ('bfloat16', 'float32'):
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(_as_f32(jx)).to(getattr(torch, dtype))
    if decomposed:
      jctx, tctx = _op_pair('BATCH_MATMUL', {}, (4, 2, 4, 512))
      want = jax_impl.OPS['BATCH_MATMUL'](jctx, jx.reshape(4, 2, 4, 512),
                                          jnp.asarray(h))
      got = impl.OPS['BATCH_MATMUL'](tctx, tx.reshape(4, 2, 4, 512),
                                     torch.from_numpy(h))
    else:
      jctx, tctx = _op_pair('HADAMARD_ROTATION', {'hadamard_size': 512},
                            x.shape)
      want = jax_impl.OPS['HADAMARD_ROTATION'](jctx, jx)
      got = impl.OPS['HADAMARD_ROTATION'](tctx, tx)
    assert str(got.dtype).split('.')[-1] == str(want.dtype) == dtype
    got, want = got.float().numpy(), _as_f32(want)
    diff = np.abs(got - want)
    if dtype == 'bfloat16':
      assert np.all(diff <= _BF16_EPS * 2 * np.abs(want))
      assert np.mean(diff > 0) < 0.01
    else:
      np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


# -- the slice: gemma_mixed48_hr, quantize, serve, same tokens -----------------

HR_CFG = dict(SERVE_CFG, ffn_dim=16384)  # the down FC's K > 8192


@pytest.fixture(scope='module')
def hr_servers():
  """One JAX and one port server over the toy serving graph at F 16384,
  each quantized by its own package under gemma_mixed48_hr (f32
  activations), shared by this file's server tests."""
  with pytest.MonkeyPatch.context() as mp:
    for var, val in JAX_SERVING_ENV + (('AEQT_ATTN_WRITEBACK', '1'),):
      mp.setenv(var, val)
    _interpreted_dispatchers(mp)
    jcfg = jax_gemma.DecoderConfig(**HR_CFG)
    tcfg = gemma.DecoderConfig(**HR_CFG)
    jgraph = jax_gemma.build_serving_decoder(jcfg, batch_slots=SLOTS,
                                             **BENCH_KW)
    tgraph = gemma.build_serving_decoder(tcfg, batch_slots=SLOTS, **BENCH_KW)
    jax_gemma.stamp_int8_kv_cache(jgraph)
    gemma.stamp_int8_kv_cache(tgraph)
    jq = JaxQuantizer(jgraph, 'gemma_mixed48_hr').quantize().quantized_model
    tq = Quantizer(tgraph, 'gemma_mixed48_hr').quantize().quantized_model
    tserver = batching.DecodeServer(tq, tcfg, SLOTS, pack_weights=True,
                                    activation_dtype='float32', device='cpu',
                                    starvation_age_s=None)
    tserver._executor.mlp_bf = 128
    tserver._executor.prepare_serving_weights(min_weight_params=0)
    jserver = jax_batching.DecodeServer(jq, jcfg, SLOTS, pack_weights=True,
                                        activation_dtype='float32',
                                        starvation_age_s=None)
    jserver._executor.prepare_serving_weights(min_weight_params=0)
    for server in (tserver, jserver):
      _track(server)
    yield jserver, tserver, tcfg


class _CallCounter:
  """Stands in for a port server's executor: counts its calls by
  signature."""

  def __init__(self, inner):
    self.inner = inner
    self.calls = {}

  def __call__(self, inputs, signature_key='serving_default'):
    self.calls[signature_key] = self.calls.get(signature_key, 0) + 1
    return self.inner(inputs, signature_key)

  def __getattr__(self, name):
    return getattr(self.inner, name)


HR_KERNELS = {
    'kblock': KBLOCK, 'int4_drq': pq.qmatmul_int4_packed_drq,
    'int8_drq': int_qmatmul.qmatmul_int8_drq, 'head': head.head_argmax,
    'mlp': mlp.mlp_int4_packed, 'weight_only': WO, 'blockwise': BLOCKWISE,
    'int_weights': int_qmatmul.qmatmul_int_weights}


def test_hr_graph_keeps_the_mlp_unfused(hr_servers):
  """The decomposed rotation (RESHAPE -> BATCH_MATMUL -> RESHAPE) sits
  between the GeGLU MUL and each down FC, so neither package's MLP finder
  takes the chain; the head fuses in every signature; every 4-bit FC is
  packed, the down FCs at K 16384."""
  jserver, tserver, cfg = hr_servers
  units = _fusion_units(tserver._executor)
  assert units == _fusion_units(jserver._executor)
  graph = tserver._executor.graph
  assert units == {('head', i): 1 for i in range(len(graph.subgraphs))}
  ex = tserver._executor
  assert ex._packed_int4_keys == jserver._executor._packed_int4_keys
  down = [(i, op) for i, sg in enumerate(graph.subgraphs) for op in sg.ops
          if op.opcode == 'FULLY_CONNECTED'
          and sg.tensors[op.inputs[1]].shape == (cfg.embed_dim, cfg.ffn_dim)]
  assert len(down) == cfg.num_layers * len(graph.subgraphs)
  for sg_idx, op in down:
    sg = graph.subgraphs[sg_idx]
    assert (sg_idx, op.inputs[1]) in ex._packed_int4_keys
    producer = {t: o for o in sg.ops for t in o.outputs}
    chain = [producer[op.inputs[0]]]
    for _ in range(3):
      chain.append(producer[chain[-1].inputs[0]])
    assert [o.opcode for o in chain] == ['RESHAPE', 'BATCH_MATMUL',
                                         'RESHAPE', 'MUL']


@pytest.mark.parametrize('chunk', [0, 4])
def test_hr_server_tokens_match_jax(chunk, hr_servers):
  """The same trace through both servers: the same tokens, statuses and
  metrics; each decode tick and prefill pass runs, per layer, one K-blocked
  down FC, one non-blocked int4 DRQ gate/up FC and two int8 DRQ attention
  FCs, and one fused head; the MLP kernel and the weight-only and
  blockwise packed matmuls never run."""
  jserver, tserver, cfg = hr_servers
  trace = _trace(cfg, seed=chunk)[:5]
  before = {name: f.plain_calls for name, f in HR_KERNELS.items()}
  since = (_metrics(jserver), _metrics(tserver))
  counter = tserver._executor = _CallCounter(tserver._executor)
  try:
    jids = _serve(jserver, trace, chunk)
    tids = _serve(tserver, trace, chunk)
  finally:
    tserver._executor = counter.inner
  assert tids == jids
  got, want = _finished(tserver, tids), _finished(jserver, jids)
  assert got == want
  assert all(status == 'done' for status, _ in got.values())
  assert _metrics(tserver, since[1]) == _metrics(jserver, since[0])
  ticks = counter.calls.pop('decode', 0)
  passes = sum(counter.calls.values())
  assert ticks > 0 and passes > 0
  calls, layers = ticks + passes, cfg.num_layers
  ran = {name: f.plain_calls - before[name] for name, f in HR_KERNELS.items()}
  assert ran == {'kblock': layers * calls, 'int4_drq': layers * calls,
                 'int8_drq': 2 * layers * calls, 'head': calls, 'mlp': 0,
                 'weight_only': 0, 'blockwise': 0, 'int_weights': 0}
