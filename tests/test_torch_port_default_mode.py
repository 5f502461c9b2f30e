"""The JAX package's default serving mode in the port, on the CPU.

With no AEQT_* variable set the JAX executor serves packed int4 FCs
weight-only (AEQT_INT4_DRQ=0: qmatmul_pallas_int4_packed, the MLP's and
the head's bf16 branches) and attends at decode with the additive-mask
kernel (AEQT_ATTN_LENGTHS=0: decode_attention_int8_masked). The port
serves that mode with `DecodeServer(..., executor_options=
executor.JAX_DEFAULT_OPTIONS)`.

Kernels: inputs made with numpy from a seed go through the Pallas kernels
in interpret mode and through the port's wrappers on CPU tensors, which
run the plain versions: the masked decode attention (pallas_attention.py:
1085) and the MLP's bf16 branch at the path's group width (bf 512) with
bf16 and f32 x. The weight-only matmul (:199) and the head's bf16 branch
are held in tests/test_torch_port_hadamard.py and
tests/test_torch_port_kernels.py.

Servers: examples/serve_gemma.py's quantization (`add_dynamic_config('.*',
'FULLY_CONNECTED', 4)`: every FC int4 channelwise) of the toy serving
graph, each package quantizing its own copy (the graphs are equal), served
by the JAX DecodeServer with no AEQT_* variable set and by the port's with
JAX_DEFAULT_OPTIONS: the same tokens, and per signature call the kernel
wrappers the JAX executor's defaults pick.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu.kernels import pallas_mlp
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import head
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_hadamard import _CallCounter
from test_torch_port_int_qmatmul import _fusion_units
from test_torch_port_serving import BENCH_KW, SERVE_CFG, SLOTS
from test_torch_port_serving import _finished, _metrics, _serve, _trace
from test_torch_port_serving import _track

MASKED = attention.decode_attention_int8_masked


def _t(a):
  return torch.from_numpy(np.array(a))


def _j(a):
  return jnp.asarray(np.asarray(a))


# -- the additive-mask decode attention (#17) ----------------------------------


def _masks(kind, b, g, s, rng):
  """An additive mask of `kind`: 'prefix' [B, 1, G, S] (0 up to a length,
  -1e9 after; one row sees a single column), 'nonprefix' [B, 1, G, S]
  (random holes that differ by query row, -inf among them; one row hidden
  by -1e9 everywhere) or 'row' [B, 1, 1, S] (a prefix broadcast over the
  query rows, as the serving graph's device mask is)."""
  if kind == 'nonprefix':
    hidden = rng.random((b, 1, g, s)) < 0.4
    mask = np.where(hidden, -1e9, 0.0).astype(np.float32)
    mask[..., 3] = -np.inf
    mask[0, 0, 1] = -1e9  # every column hidden: uniform weights
    return mask
  lengths = rng.integers(1, s + 1, size=b)
  lengths[0] = 1
  rows = np.where(np.arange(s)[None, :] < lengths[:, None], 0.0, -1e9)
  rows = rows.astype(np.float32).reshape(b, 1, 1, s)
  return rows if kind == 'row' else np.broadcast_to(
      rows, (b, 1, g, s)).copy()


@pytest.mark.parametrize('kind', ['prefix', 'nonprefix', 'row'])
@pytest.mark.parametrize('nk', [1, 2])
def test_masked_attention_matches_pallas(nk, kind):
  """The plain version against pallas_attention.decode_attention_int8_
  masked(compute='f32') in interpret mode at G 8, H 256, S 256, non-zero
  zero points: f32 sums in another order, so within 2e-5 of the largest
  output (read: up to 2.6e-6)."""
  b, g, h, s = 3, 8, 256, 256
  rng = np.random.default_rng(nk * 10 + len(kind))
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  k_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  v_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  mask = _masks(kind, b, g, s, rng)
  args = (0.05, 0.03)
  zps = dict(k_zero_point=3.0, v_zero_point=-2.0)
  want = np.asarray(pallas_attention.decode_attention_int8_masked(
      _j(q), _j(k_cache), _j(v_cache), *args, _j(mask), compute='f32',
      interpret=True, **zps))
  before = (MASKED.launches, MASKED.plain_calls)
  got = MASKED(_t(q), _t(k_cache), _t(v_cache), *args, _t(mask), **zps)
  assert (MASKED.launches, MASKED.plain_calls) == (before[0], before[1] + 1)
  assert got.dtype == torch.float32 and got.shape == (b, nk, g, h)
  got = got.numpy()
  assert np.all(np.isfinite(want))
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=2e-5 * float(np.max(np.abs(want))))
  if kind == 'nonprefix':
    # The fully hidden row weighs every cache row 1/S.
    mean_v = v_cache[0, :].astype(np.float64).mean(axis=1)  # [NK, H]
    np.testing.assert_allclose(got[0, :, 1], (mean_v - (-2.0)) * 0.03,
                               atol=1e-4)


@pytest.mark.parametrize('compute', ['bf16', 'int8'])
def test_masked_attention_ports_f32_only(compute):
  """The TPU kernel's bf16 and int8 compute modes are not ported: the
  wrapper raises on the CPU as on the card, and runs nothing."""
  before = MASKED.plain_calls
  with pytest.raises(NotImplementedError, match='f32'):
    MASKED(torch.zeros((1, 1, 8, 128)), torch.zeros((1, 1, 128, 128),
                                                   dtype=torch.int8),
           torch.zeros((1, 1, 128, 128), dtype=torch.int8), 1.0, 1.0,
           torch.zeros((1, 1, 8, 128)), compute=compute)
  assert MASKED.plain_calls == before


# -- the MLP's bf16 branch (#3, drq=False) at the path's group width ----------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_mlp_bf16_branch_matches_pallas_at_bf512(dtype):
  """mlp_pallas_int4_packed(drq=False) at bf 512 (AEQT_MLP_BF's default,
  two F-groups) against the port's bf16 branch, counted under
  mlp_int4_packed_bf16 and not under the DRQ branch's name. At f32 x:
  f32 sums in another order, within 1e-5 of max |y|. At bf16 x: the
  hidden values are rounded to bf16, so a sum that differs in its last
  f32 place can round one of them one bf16 step the other way, and the
  output is stored in bf16: within 4e-3 of max |y| (read: 1.4e-3 at one
  output in a thousand, a bf16 step of a large output)."""
  m, d, f, bf = 8, 256, 1024, 512
  rng = np.random.default_rng(512)
  x = rng.standard_normal((m, d)).astype(np.float32)
  wgu = rng.integers(-8, 8, size=(2 * f, d)).astype(np.int8)
  wd = rng.integers(-8, 8, size=(d, f)).astype(np.int8)
  s_gu = (rng.uniform(0.5, 2.0, size=2 * f) * 0.02).astype(np.float32)
  s_d = (rng.uniform(0.5, 2.0, size=d) * 0.02).astype(np.float32)
  wgu_p = np.asarray(pallas_qmatmul.pack_int4_split(_j(wgu)))
  wd_g = np.asarray(pallas_mlp.pack_int4_split_grouped(_j(wd), bf))
  jx = jnp.asarray(x, dtype)
  want = np.asarray(pallas_mlp.mlp_pallas_int4_packed(
      jx, _j(wgu_p), _j(s_gu), _j(wd_g), _j(s_d), act='gelu', drq=False,
      bf=bf, interpret=True).astype(jnp.float32))
  tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
      getattr(torch, dtype))
  before = (mlp.mlp_int4_packed.plain_calls,
            mlp.mlp_int4_packed_bf16.plain_calls)
  got = mlp.mlp_int4_packed(tx, _t(wgu_p), _t(s_gu), _t(wd_g), _t(s_d),
                            act='gelu', drq=False, bf=bf)
  assert (mlp.mlp_int4_packed.plain_calls,
          mlp.mlp_int4_packed_bf16.plain_calls) == (before[0], before[1] + 1)
  assert got.dtype == tx.dtype
  got = got.float().numpy()
  ymax = float(np.max(np.abs(want)))
  tol = 1e-5 if dtype == 'float32' else 4e-3
  assert np.max(np.abs(got - want)) <= tol * ymax


def test_head_bf16_branch_counts_under_its_own_name():
  """head_argmax(drq=False) runs the weight-only branch, head_argmax_bf16,
  with the plain version's ids (held against Pallas in
  test_torch_port_kernels.py); the DRQ branch's counts do not move."""
  rng = np.random.default_rng(3)
  x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
  w = pq.pack_int4_split(torch.from_numpy(
      rng.integers(-8, 8, size=(512, 256)).astype(np.int8)))
  s = torch.full((512,), 0.01)
  before = (head.head_argmax.plain_calls, head.head_argmax_bf16.plain_calls)
  ids = head.head_argmax(x, w, s, packed=True, true_n=500, drq=False)
  assert (head.head_argmax.plain_calls,
          head.head_argmax_bf16.plain_calls) == (before[0], before[1] + 1)
  want = head.head_argmax_plain(x, w, s, packed=True, true_n=500, drq=False)
  assert torch.equal(ids, want) and int(ids.max()) < 500


# -- the servers: serve_gemma's quantization, the JAX default mode -------------

# The serving test config with F 1024: at the default bf 512 the MLP has
# the two F-groups the fusion finders ask for.
DEFAULT_CFG = dict(SERVE_CFG, ffn_dim=1024)
WRAPPERS = {
    'weight_only': pq.qmatmul_int4_packed,
    'mlp_bf16': mlp.mlp_int4_packed_bf16, 'head_bf16': head.head_argmax_bf16,
    'masked': MASKED, 'flash': attention.flash_attention_int8_masked,
    'int4_drq': pq.qmatmul_int4_packed_drq, 'mlp_drq': mlp.mlp_int4_packed,
    'head_drq': head.head_argmax,
    'lengths': attention.decode_attention_int8_lengths,
    'stale': attention.decode_attention_int8_lengths_stale,
    'kblock': pq.qmatmul_int4_packed_drq_kblock,
    'int8_drq': int_qmatmul.qmatmul_int8_drq,
    'int_weights': int_qmatmul.qmatmul_int_weights}


def _quantized(gemma_mod, quantizer_cls, cfg):
  """examples/serve_gemma.py's quantization of the toy serving graph."""
  graph = gemma_mod.build_serving_decoder(cfg, batch_slots=SLOTS,
                                          **BENCH_KW)
  gemma_mod.stamp_int8_kv_cache(graph)
  qt = quantizer_cls(graph)
  qt.add_dynamic_config('.*', 'FULLY_CONNECTED', 4)
  return qt.quantize().quantized_model


@pytest.fixture(scope='module')
def default_servers():
  """One JAX server with no AEQT_* variable set and one port server with
  JAX_DEFAULT_OPTIONS over serve_gemma's quantization of the toy serving
  graph (f32 activations, every int4 FC packed), shared by this file's
  server tests."""
  with pytest.MonkeyPatch.context() as mp:
    for var in [v for v in os.environ if v.startswith('AEQT_')]:
      mp.delenv(var)
    jcfg = jax_gemma.DecoderConfig(**DEFAULT_CFG)
    tcfg = gemma.DecoderConfig(**DEFAULT_CFG)
    jq = _quantized(jax_gemma, JaxQuantizer, jcfg)
    tq = _quantized(gemma, Quantizer, tcfg)
    assert len(jq.buffers) == len(tq.buffers)
    for jb, tb in zip(jq.buffers, tq.buffers):
      assert (jb.data is None) == (tb.data is None)
      if jb.data is not None:
        np.testing.assert_array_equal(np.asarray(tb.data),
                                      np.asarray(jb.data))
    tserver = batching.DecodeServer(
        tq, tcfg, SLOTS, pack_weights=True, activation_dtype='float32',
        device='cpu', starvation_age_s=None,
        executor_options=executor.JAX_DEFAULT_OPTIONS)
    # Toy weights are below the packing threshold: pack them all.
    tserver._executor.prepare_serving_weights(min_weight_params=0)
    jserver = jax_batching.DecodeServer(jq, jcfg, SLOTS, pack_weights=True,
                                        activation_dtype='float32',
                                        starvation_age_s=None)
    jserver._executor.prepare_serving_weights(min_weight_params=0)
    for server in (tserver, jserver):
      _track(server)
    yield jserver, tserver, tcfg


def test_server_options_reach_the_executor(default_servers):
  """executor_options reach the port's executor; without them the server
  keeps the executor's defaults (bench.py's options). Both servers find
  the same units: the MLP and the head fused in every signature, the
  attention chain of every layer, every FC packed."""
  jserver, tserver, cfg = default_servers
  ex = tserver._executor
  for key, value in executor.JAX_DEFAULT_OPTIONS.items():
    assert getattr(ex, key) == value, key
  bench = batching.DecodeServer(tserver.graph, cfg, SLOTS, device='cpu')
  assert (bench._executor.int4_drq, bench._executor.attn_lengths,
          bench._executor.attn_writeback, bench._executor.mlp_bf,
          bench._executor.decode_block) == (True, True, 'stale', 2048, True)
  units = _fusion_units(ex)
  assert units == _fusion_units(jserver._executor)
  subgraphs = range(len(ex.graph.subgraphs))
  assert units == {**{('mlp', i): cfg.num_layers for i in subgraphs},
                   **{('head', i): 1 for i in subgraphs}}
  assert ex._packed_int4_keys == jserver._executor._packed_int4_keys
  assert len(ex._attn_fusions) == len(jserver._executor._attn_fusions) == (
      cfg.num_layers * len(ex.graph.subgraphs))


@pytest.mark.parametrize('chunk', [0, 4])
def test_default_mode_server_tokens_match_jax(chunk, default_servers):
  """The same trace through both servers: the same tokens, statuses and
  metrics. Per decode tick the port runs, per layer, two weight-only
  packed FCs (QKV and out-projection), one MLP in its bf16 branch and one
  masked decode attention, then one head in its bf16 branch; per prefill
  pass the same with the flash attention in place of the masked one; no
  DRQ kernel, no lengths or stale attention."""
  jserver, tserver, cfg = default_servers
  trace = _trace(cfg, seed=chunk)
  before = {name: f.plain_calls for name, f in WRAPPERS.items()}
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
  for rid, (_, n) in zip(tids, trace):
    assert got[rid][0] == 'done' and len(got[rid][1]) == n
  assert _metrics(tserver, since[1]) == _metrics(jserver, since[0])
  ticks = counter.calls.pop('decode', 0)
  passes = sum(counter.calls.values())
  assert ticks > 0 and passes > 0
  calls, layers = ticks + passes, cfg.num_layers
  ran = {name: f.plain_calls - before[name] for name, f in WRAPPERS.items()}
  want_ran = dict.fromkeys(WRAPPERS, 0)
  want_ran.update(weight_only=2 * layers * calls, mlp_bf16=layers * calls,
                  head_bf16=calls, masked=layers * ticks,
                  flash=layers * passes)
  assert ran == want_ran
