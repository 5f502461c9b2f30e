"""The port's integer-weight matmuls (int8 DRQ, weight-only blockwise and
channelwise) and the quantized serving slice against the JAX package, on
the CPU.

Kernels: inputs made with numpy from a seed go through the Pallas kernels
in interpret mode and through the port's wrappers on CPU tensors, which run
the plain versions. The int8 DRQ kernel is held bit for bit; the
weight-only kernel to `int_qmatmul.int_weights_tolerance` (f32 sums within
a block in another order).

Slice: the toy serving graph, quantized by each package's own Quantizer
under gemma_mixed48 and gemma_mixed48_b32, served by each package's
DecodeServer. The JAX executor off its accelerator runs the XLA
references; here its dispatchers `drq_matmul` and `qmatmul` are patched
(in this test only) to call the Pallas kernels in interpret mode under the
gates of its accelerator, which the port applies on every device.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.kernels import qmatmul as jax_qmm
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.kernels import head
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import qmatmul
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_serving import BENCH_KW, SERVE_CFG, SLOTS
from test_torch_port_serving import _finished, _metrics, _serve, _trace
from test_torch_port_serving import _track
from test_torch_port_slice import JAX_SERVING_ENV

DRQ = int_qmatmul.qmatmul_int8_drq
WO = int_qmatmul.qmatmul_int_weights


def _inputs(seed, m, n, k, wmax, scale_shape, bias):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w = rng.integers(-wmax, wmax + 1, (n, k)).astype(np.int8)
  s = (rng.random(scale_shape) * 0.01 + 0.001).astype(np.float32)
  b = rng.standard_normal(n).astype(np.float32) if bias else None
  return x, w, s, b


def _t(a):
  return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
  return None if a is None else jnp.asarray(a)


# -- the int8 DRQ kernel (pallas_qmatmul.py:553) ------------------------------


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_drq_matches_pallas_bit_for_bit(dtype, bias):
  x, w, s, b = _inputs(3, 20, 256, 512, 127, (256,), bias)
  jx = jnp.asarray(x, dtype)
  tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
      getattr(torch, dtype))
  before = (DRQ.launches, DRQ.plain_calls)
  got = DRQ(tx, _t(w), _t(s), _t(b))
  assert (DRQ.launches, DRQ.plain_calls) == (before[0], before[1] + 1)
  assert got.dtype == tx.dtype and got.shape == (20, 256)
  got = got.float().numpy()

  def pallas(bias_arr):
    return np.asarray(pallas_qmatmul.qmatmul_pallas_int8_drq(
        jx, _j(w), _j(s), _j(bias_arr), interpret=True).astype(jnp.float32))

  if bias and dtype == 'float32':
    # XLA's CPU backend contracts the kernel's `y * s + b` into one FMA;
    # the Pallas source rounds the product first, as the CUDA kernel and
    # the plain version do. Bit for bit against the kernel without the
    # bias plus the bias, and within the FMA's one rounding of it.
    product = pallas(None)
    want = product + b
    fma_bound = 2.0**-23 * (np.abs(product) + np.abs(b))
    assert np.all(np.abs(got - pallas(b)) <= fma_bound)
  else:
    want = pallas(b)
  np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_int8_drq_codes_and_sums_are_exact():
  """The plain version's int32 sums equal an int64 matmul of its codes,
  and its codes the Pallas formula rint(x * (1 / xs))."""
  x, w, s, _ = _inputs(4, 8, 128, 2048, 127, (128,), False)
  xq, xs = packed_qmatmul.quantize_rows_drq(torch.from_numpy(x))
  xs_np = np.maximum(np.abs(x).max(axis=1, keepdims=True),
                     np.float32(1e-9)) * np.float32(1.0 / 127.0)
  np.testing.assert_array_equal(xs.numpy(), xs_np)
  np.testing.assert_array_equal(
      xq.numpy(), np.rint(x * (np.float32(1) / xs_np)).astype(np.int8))
  acc = qmatmul.int_matmul_exact(xq, torch.from_numpy(w)).numpy()
  np.testing.assert_array_equal(
      acc, xq.numpy().astype(np.int64) @ w.T.astype(np.int64))


# -- the weight-only kernel (pallas_qmatmul.py:753) ---------------------------


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('block_size', [0, 32, 64])
def test_int_weights_matches_pallas(block_size, bias):
  k, n = 512, 256
  shape = (n, k // block_size) if block_size else (n,)
  x, w, s, b = _inputs(5 + block_size, 12, n, k, 7, shape, bias)
  want = np.asarray(pallas_qmatmul.qmatmul_pallas(
      _j(x), _j(w), _j(s), _j(b), block_size=block_size, interpret=True))
  before = WO.plain_calls
  got = WO(_t(x), _t(w), _t(s), _t(b), block_size=block_size).numpy()
  assert WO.plain_calls == before + 1
  ymax = float(np.abs(want).max())
  tol = int_qmatmul.int_weights_tolerance(k, block_size, ymax)
  assert np.abs(got - want).max() <= tol
  # The tolerance sees a wrong block scale: one block's scale doubled.
  if block_size:
    s2 = s.copy()
    s2[:, 1] *= 2
    bad = WO(_t(x), _t(w), _t(s2), _t(b), block_size=block_size).numpy()
    assert np.abs(bad - want).max() > 100 * tol


def test_int_weights_bf16_x_uses_f32_operands():
  """bf16 x: the Pallas kernel widens x to f32 (qmatmul_ref would multiply
  bf16 operands); the result is stored in x's dtype."""
  x, w, s, _ = _inputs(6, 4, 128, 256, 7, (128, 8), False)
  jx = jnp.asarray(x, jnp.bfloat16)
  want = np.asarray(pallas_qmatmul.qmatmul_pallas(
      jx, _j(w), _j(s), block_size=32, interpret=True).astype(jnp.float32))
  tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
  got = WO(tx, _t(w), _t(s), block_size=32)
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize('case,kernel', [
    ('drq aligned', DRQ), ('drq int4 values', DRQ), ('drq k % 256', None),
    ('drq n % 128', None), ('drq per-tensor scale', None),
    ('drq 16-bit activations', None),
    ('wo blockwise', WO), ('wo channelwise', WO), ('wo zero point', None),
    ('wo k % 256', None)])
def test_dispatchers_take_the_jax_gates(case, kernel):
  """drq_matmul and qmatmul call the kernel wrapper exactly where the JAX
  dispatchers call their Pallas kernel on the TPU, else the reference."""
  n, k = (128, 384) if 'k %' in case else (96, 256) if 'n %' in case else (
      128, 256)
  x, w, _, _ = _inputs(7, 3, n, k, 7 if 'int4' in case else 127, (1,),
                       False)
  x, w = _t(x), _t(w)
  counts = {f: f.plain_calls for f in (DRQ, WO)}
  if case.startswith('drq'):
    s = torch.full((1 if 'per-tensor' in case else n,), 0.01)
    bits = 16 if '16-bit' in case else 8
    y = qmatmul.drq_matmul(x, w, s, act_num_bits=bits)
    ref = qmatmul.drq_matmul_ref(x, w, s, act_num_bits=bits)
  else:
    bs = 32 if 'blockwise' in case else 0
    s = torch.full((n, k // 32) if bs else (n,), 0.01)
    zp = torch.ones(n, dtype=torch.int32) if 'zero' in case else None
    y = qmatmul.qmatmul(x, w, s, zero_point=zp, block_size=bs)
    ref = qmatmul.qmatmul_ref(x, w, s, zero_point=zp, block_size=bs)
  ran = {f: f.plain_calls - c for f, c in counts.items()}
  assert ran == {f: int(f is kernel) for f in (DRQ, WO)}
  if kernel is None:
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
  else:
    assert y.shape == ref.shape and y.dtype == ref.dtype


# -- the slice: quantize, serve, same tokens ----------------------------------


def _interpreted_dispatchers(monkeypatch):
  """The JAX dispatchers with their accelerator's gates, the Pallas
  kernels in interpret mode (the JAX package itself is not changed)."""
  drq_ref, q_ref = jax_qmm.drq_matmul_ref, jax_qmm.qmatmul_ref

  def drq_matmul(x, w_q, w_scale, bias=None, act_num_bits=8,
                 prefer_pallas=True):
    n, k = w_q.shape
    if (prefer_pallas and act_num_bits == 8 and w_q.dtype == jnp.int8
        and k % 256 == 0 and n % 128 == 0):
      return pallas_qmatmul.qmatmul_pallas_int8_drq(
          x, w_q, w_scale, bias=bias, interpret=True)
    return drq_ref(x, w_q, w_scale, bias=bias, act_num_bits=act_num_bits)

  def qmatmul_(x, w_q, scale, zero_point=None, bias=None, block_size=0,
               prefer_pallas=True):
    n, k = w_q.shape
    if (prefer_pallas and zero_point is None and k % 256 == 0
        and n % 128 == 0):
      return pallas_qmatmul.qmatmul_pallas(
          x, w_q, scale, bias=bias, block_size=block_size, interpret=True)
    return q_ref(x, w_q, scale, zero_point, bias, block_size)

  monkeypatch.setattr(jax_qmm, 'drq_matmul', drq_matmul)
  monkeypatch.setattr(jax_qmm, 'qmatmul', qmatmul_)


def _fusion_units(executor):
  """{(kind, subgraph index): count} of the MLP, head and block units."""
  out = {}
  for kind, units in (('mlp', executor._mlp_fusions),
                      ('head', executor._head_fusions),
                      ('block', executor._block_fusions)):
    for sg_idx, _ in units:
      out[kind, sg_idx] = out.get((kind, sg_idx), 0) + 1
  return out


@pytest.mark.parametrize('recipe', ['gemma_mixed48', 'gemma_mixed48_b32'])
def test_quantized_server_tokens_match_jax(recipe, monkeypatch):
  """Quantize the toy serving graph on each side, serve the same trace:
  the same tokens and metrics, the same fusion units per subgraph as the
  JAX finders (gemma_mixed48: every layer's MLP and the head fuse in every
  signature; _b32: blockwise-32 FCs do not pack, so nothing fuses), and
  the new kernels' plain versions ran: the int8 DRQ kernel for the int8
  attention FCs of both recipes, the weight-only kernel for the
  blockwise FFN and head FCs of _b32."""
  for var, val in JAX_SERVING_ENV + (('AEQT_ATTN_WRITEBACK', '1'),):
    monkeypatch.setenv(var, val)
  _interpreted_dispatchers(monkeypatch)
  jcfg = jax_gemma.DecoderConfig(**SERVE_CFG)
  tcfg = gemma.DecoderConfig(**SERVE_CFG)
  jgraph = jax_gemma.build_serving_decoder(jcfg, batch_slots=SLOTS,
                                           **BENCH_KW)
  tgraph = gemma.build_serving_decoder(tcfg, batch_slots=SLOTS, **BENCH_KW)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  jq = JaxQuantizer(jgraph, recipe).quantize().quantized_model
  tq = Quantizer(tgraph, recipe).quantize().quantized_model

  tserver = batching.DecodeServer(tq, tcfg, SLOTS, pack_weights=True,
                                  activation_dtype='float32', device='cpu',
                                  starvation_age_s=None)
  tserver._executor.mlp_bf = 128
  tserver._executor.prepare_serving_weights(min_weight_params=0)
  jserver = jax_batching.DecodeServer(jq, jcfg, SLOTS, pack_weights=True,
                                      activation_dtype='float32',
                                      starvation_age_s=None)
  jserver._executor.prepare_serving_weights(min_weight_params=0)
  units = _fusion_units(tserver._executor)
  assert units == _fusion_units(jserver._executor)
  subgraphs = range(len(tq.subgraphs))
  if recipe == 'gemma_mixed48':
    assert units == {
        **{('mlp', i): tcfg.num_layers for i in subgraphs},
        **{('head', i): 1 for i in subgraphs}}
  else:
    assert units == {}

  for server in (tserver, jserver):
    _track(server)
  trace = _trace(tcfg)[:5]
  before = {f: f.plain_calls for f in (DRQ, WO, mlp.mlp_int4_packed,
                                       head.head_argmax)}
  jids = _serve(jserver, trace, 4)
  tids = _serve(tserver, trace, 4)
  assert tids == jids
  got, want = _finished(tserver, tids), _finished(jserver, jids)
  assert got == want
  assert all(status == 'done' for status, _ in got.values())
  assert _metrics(tserver) == _metrics(jserver)
  ran = {f: f.plain_calls - c for f, c in before.items()}
  assert ran[DRQ] > 0
  if recipe == 'gemma_mixed48':
    assert ran[WO] == 0 and ran[mlp.mlp_int4_packed] > 0
    assert ran[head.head_argmax] > 0
  else:
    assert ran[WO] > 0 and ran[mlp.mlp_int4_packed] == 0
    assert ran[head.head_argmax] == 0
