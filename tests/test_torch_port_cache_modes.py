"""Blockwise int4 serving and the opt-in KV-cache modes of the port, on the
CPU.

Kernels: inputs made with numpy from a seed go through the Pallas kernels
in interpret mode and through the port's wrappers on CPU tensors, which
run the plain versions:
  * the blockwise packed int4 matmul (pallas_qmatmul.py:461) at block sizes
    128 and 256, f32 and bf16 x, with and without a bias, within
    `int_weights_tolerance` (f32 sums in another order; one bf16 rounding
    more for bf16 x);
  * the splice attention (pallas_attention.py:850): the context within
    1e-5 (the lengths tests' tolerance), both caches bit for bit, at pos 0,
    31, 32 and S - 1, and with pos clipped;
  * the in-place row write (pallas_cache.py:105) bit for bit, clipped
    starts included, and its shape gate;
  * the live-prefix attention (pallas_attention.py:1018) at chunk 128,
    with a zero-length row beside long rows in one row block and lengths
    that are no multiple of the chunk: rtol 1e-5, atol 1e-5 (f32 sums in
    another order; the zero-length row's mean over its block's chunks
    included).

Executor: bench.py's decode graph (test_torch_port_serving's MQA config:
D 256, head dim 128, 2 layers) against the JAX executor under the matching
AEQT_* variables: splice, in-place writes and the live-prefix attention
(off the TPU the JAX executor writes the caches with XLA's DUS and
attends with its XLA twin: the TPU gates at executor.py:1686, 1915 and
2056), logits and caches. The blockwise-128 quantization of the toy serving graph: the
.aeqg bytes of both packages, then a JAX server with AEQT_ATTN_DYNLEN=1
against the port's with `{**JAX_DEFAULT_OPTIONS, 'attn_dynlen': True}`.

Donation: with the options off the step's inputs are unchanged; with
splice or in-place writes the output pools are the input tensors and
hold the functional result.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu.kernels import pallas_cache
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import cache
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_hadamard import _CallCounter
from test_torch_port_serving import BENCH_KW, SERVE_CFG, SLOTS
from test_torch_port_serving import _finished, _metrics, _serve, _trace
from test_torch_port_serving import _track
from test_torch_port_slice import JAX_SERVING_ENV, shared_weights

BLOCKWISE = pq.qmatmul_int4_packed_blockwise
WRITEBACK = attention.decode_attention_int8_lengths_writeback
DYNLEN = attention.decode_attention_int8_dynlen
ROW_WRITE = cache.dus_row_inplace
_BF16_EPS = 2.0**-8  # unit roundoff of bf16


def _t(a):
  return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
  return None if a is None else jnp.asarray(np.asarray(a))


def _as_f32(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- #13: the blockwise packed int4 matmul -------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('block_size', [128, 256])
def test_blockwise_matches_pallas(block_size, bias, dtype):
  """M 3, N 384, K 2048 (8 and 4 byte blocks): within int_weights_tolerance
  of max |y| at f32 x, one bf16 rounding more at bf16 x. At f32 x, a
  low-nibble block's scale doubled moves y far beyond the tolerance."""
  m, n, k = 3, 384, 2048
  rng = np.random.default_rng(block_size + 2 * bias)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w = np.asarray(pallas_qmatmul.pack_int4_split(
      jnp.asarray(rng.integers(-8, 8, (n, k)).astype(np.int8))))
  s = (rng.random((n, k // block_size)) * 0.01 + 0.001).astype(np.float32)
  b = rng.standard_normal(n).astype(np.float32) if bias else None
  jx = jnp.asarray(x, dtype)
  want = _as_f32(pallas_qmatmul.qmatmul_pallas_int4_packed_blockwise(
      jx, _j(w), _j(s), _j(b), block_size=block_size, interpret=True))
  tx = _t(_as_f32(jx)).to(getattr(torch, dtype))
  before = (BLOCKWISE.plain_calls, BLOCKWISE.launches)
  got = BLOCKWISE(tx, _t(w), _t(s), _t(b))
  assert (BLOCKWISE.plain_calls, BLOCKWISE.launches) == (before[0] + 1,
                                                          before[1])
  assert got.dtype == tx.dtype and got.shape == (m, n)
  got = got.float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, block_size,
                                          float(np.abs(want).max()))
  if dtype == 'bfloat16':
    tol = tol + _BF16_EPS * np.abs(want)
  assert np.all(np.abs(got - want) <= tol)
  if dtype == 'float32':
    s2 = s.copy()
    s2[:, 1] *= 2
    bad = BLOCKWISE(torch.from_numpy(x), _t(w), _t(s2), _t(b)).numpy()
    assert np.abs(bad - want).max() > 100 * tol


# -- #8: the splice attention ----------------------------------------------------


def _splice_case(seed, b=3, nk=2, g=4, h=128, s=128):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kq = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vq = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  kn = rng.integers(-127, 128, (b, nk, 1, h)).astype(np.int8)
  vn = rng.integers(-127, 128, (b, nk, 1, h)).astype(np.int8)
  return q, kq, vq, kn, vn


@pytest.mark.parametrize('pos', [0, 31, 32, 127, 300, -5])
def test_splice_matches_pallas(pos):
  """Row pos replaced by the new rows (pos clipped to [0, S - 1]), the
  context within 1e-5 and both caches bit for bit; the caches written are
  the tensors given. Lengths: the new row's, a shorter prefix, and 0 (all
  S rows at 1/S, the spliced one among them)."""
  s = 128
  q, kq, vq, kn, vn = _splice_case(pos % 7, s=s)
  p = min(max(pos, 0), s - 1)
  lengths = np.array([p + 1, max(p - 20, 1), 0], np.int32)
  kw = dict(k_zero_point=1.5, v_zero_point=-0.5)
  ctx, k_out, v_out = pallas_attention.decode_attention_int8_lengths_writeback(
      _j(q), _j(kq), _j(vq), 0.05, 0.02, _j(lengths), _j(kn), _j(vn),
      jnp.int32(pos), batch_block=2, interpret=True, **kw)
  tk, tv = _t(kq), _t(vq)
  before = WRITEBACK.plain_calls
  got, gk, gv = WRITEBACK(_t(q), tk, tv, 0.05, 0.02, _t(lengths), _t(kn),
                          _t(vn), pos, **kw)
  assert WRITEBACK.plain_calls == before + 1
  assert gk is tk and gv is tv
  np.testing.assert_array_equal(tk.numpy(), np.asarray(k_out))
  np.testing.assert_array_equal(tv.numpy(), np.asarray(v_out))
  np.testing.assert_allclose(got.numpy(), np.asarray(ctx), rtol=0, atol=1e-5)


def test_splice_refuses_unaligned_cache():
  """The TPU kernel writes whole 32-row tiles: S % 32 != 0 raises on both
  sides."""
  q, kq, vq, kn, vn = _splice_case(0, s=48)
  lengths = np.array([5, 5, 5], np.int32)
  with pytest.raises(ValueError):
    pallas_attention.decode_attention_int8_lengths_writeback(
        _j(q), _j(kq), _j(vq), 0.05, 0.02, _j(lengths), _j(kn), _j(vn),
        jnp.int32(4), interpret=True)
  with pytest.raises(ValueError):
    WRITEBACK(_t(q), _t(kq), _t(vq), 0.05, 0.02, _t(lengths), _t(kn),
              _t(vn), 4)


# -- #11: the in-place row write ---------------------------------------------


@pytest.mark.parametrize('cache_shape,starts', [
    ((4, 1, 64, 128), (0, 0, 7, 0)),
    ((4, 1, 64, 128), (0, 0, 0, 0)),
    ((4, 1, 64, 128), (0, 0, 63, 0)),
    ((4, 1, 64, 128), (0, 0, 1000, 0)),  # clipped to the last row
    ((4, 1, 64, 128), (0, 0, -3, 0)),    # clipped to the first row
    ((4, 1, 64, 128), (2, 1, 32, 9)),    # full-extent starts clip to 0
    ((8, 32, 128), (0, 9, 0)),
    ((64, 256), (13, 0)),
])
@pytest.mark.parametrize('dtype', ['int8', 'float32'])
def test_row_write_matches_pallas(cache_shape, starts, dtype):
  rng = np.random.default_rng(len(cache_shape) + starts[-2] % 11)
  upd_shape = cache_shape[:-2] + (1,) + cache_shape[-1:]
  if dtype == 'int8':
    c = rng.integers(-128, 128, cache_shape).astype(np.int8)
    u = rng.integers(-128, 128, upd_shape).astype(np.int8)
  else:
    c = rng.standard_normal(cache_shape).astype(np.float32)
    u = rng.standard_normal(upd_shape).astype(np.float32)
  st = np.asarray(starts, np.int32)
  want = np.asarray(pallas_cache.dus_row_inplace_pallas(
      _j(c), _j(u), _j(st), interpret=True))
  operand = _t(c)
  before = ROW_WRITE.plain_calls
  got = ROW_WRITE(operand, _t(u), _t(st))
  assert ROW_WRITE.plain_calls == before + 1
  assert got is operand
  np.testing.assert_array_equal(operand.numpy(), want)


@pytest.mark.parametrize('operand,update,dtype,want', [
    ((256, 1, 1024, 256), (256, 1, 1, 256), 'int8', True),
    ((256, 1, 1024, 256), (256, 1, 2, 256), 'int8', False),
    ((256, 1, 1024, 256), (128, 1, 1, 256), 'int8', False),
    ((4, 1, 24, 256), (4, 1, 1, 256), 'int8', False),
    ((4, 1, 64, 64), (4, 1, 1, 64), 'int8', False),
    ((4, 1, 24, 128), (4, 1, 1, 128), 'float32', True),
    ((4, 1, 16, 128), (4, 1, 1, 128), 'bfloat16', True),
])
def test_row_write_gate_matches_jax(operand, update, dtype, want):
  """The JAX gate's shape rules, row tiles included."""
  assert pallas_cache.supports(operand, update, jnp.dtype(dtype)) == want
  assert cache.supports(operand, update, getattr(torch, dtype)) == want


def test_row_write_gate_has_no_vmem_budget():
  """The one rule dropped: the TPU's 8 MiB scratch budget (the CUDA kernel
  moves one row per prefix row, whatever the size)."""
  shape, upd = (4096, 1, 1024, 2048), (4096, 1, 1, 2048)
  assert not pallas_cache.supports(shape, upd, jnp.int8)
  assert cache.supports(shape, upd, torch.int8)


def test_row_write_refuses_unsupported_shape():
  with pytest.raises(ValueError):
    ROW_WRITE(torch.zeros((4, 1, 64, 64), dtype=torch.int8),
              torch.zeros((4, 1, 1, 64), dtype=torch.int8),
              torch.zeros((4,), dtype=torch.int32))


# -- #18: the live-prefix attention ------------------------------------------


@pytest.mark.parametrize('lengths,nk', [
    ((0, 300, 65, 512), 1),   # a zero-length row beside long rows
    ((200, 0, 129, 1), 2),    # two KV heads: rows 2b, 2b + 1
    ((0, 0, 0, 0), 1),        # every row idle: one chunk each
    ((513, 7, 128, 256), 1),  # a length past S
])
def test_dynlen_matches_pallas(lengths, nk):
  """Chunk 128 over S 512, row blocks of 4 (rb 8 halved to divide the
  rows): rtol 1e-5, atol 1e-5 against the interpret-mode kernel. A
  zero-length row's context is the mean of its block's n_chunks * 128 V
  rows, a count set by the longest row of its block."""
  b, g, h, s = 4, 8, 128, 512
  rng = np.random.default_rng(sum(lengths) + nk)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kq = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vq = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  lens = np.asarray(lengths, np.int32)
  kw = dict(k_zero_point=2.0, v_zero_point=-1.0)
  want = np.asarray(pallas_attention.decode_attention_int8_dynlen(
      _j(q), _j(kq), _j(vq), 0.04, 0.03, _j(lens), chunk=128,
      interpret=True, **kw))
  before = DYNLEN.plain_calls
  got = DYNLEN(_t(q), _t(kq), _t(vq), 0.04, 0.03, _t(lens), chunk=128, **kw)
  assert DYNLEN.plain_calls == before + 1 and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
  if lengths[0] == 0 and nk == 1:
    # The zero-length row: uniform weights over the block's chunks.
    n = min(max(-(-max(lengths) // 128), 1), s // 128) * 128
    mean = (vq[0, 0, :n].astype(np.float64).mean(0) + 1.0) * 0.03
    np.testing.assert_allclose(got.numpy()[0, 0], np.broadcast_to(
        mean, (g, h)), rtol=1e-5, atol=1e-5)


def test_dynlen_blocking_matches_the_tpu_wrapper():
  """c = min(chunk, S) halved until it divides S; rb halved until it
  divides the rows, then while 4 * rb * c * H passes 8 MiB."""
  assert attention.dynlen_blocking(64, 1024, 256) == (256, 8)
  assert attention.dynlen_blocking(12, 384, 128) == (128, 4)
  assert attention.dynlen_blocking(4, 96, 128, chunk=64) == (32, 4)
  assert attention.dynlen_blocking(64, 4096, 4096, chunk=256) == (256, 2)


# -- the executor against the JAX executor ------------------------------------

BATCH = 4
STEPS = 3


def _decode_pair(monkeypatch, env, options, cfg_kw=None):
  """bench.py's decode graph (logits head) on both executors: the JAX one
  under JAX_SERVING_ENV with `env` on top, the port's with the same
  options and `options` on top; one weight draw (shared_weights)."""
  cfg_kw = dict(SERVE_CFG, **(cfg_kw or {}))
  jcfg, tcfg = jax_gemma.DecoderConfig(**cfg_kw), gemma.DecoderConfig(**cfg_kw)
  kw = dict(batch=BATCH, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=False)
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  tgraph = gemma.build_decoder(tcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  jweights, tweights = shared_weights(jgraph, tgraph)
  for var, val in JAX_SERVING_ENV + tuple(env.items()):
    monkeypatch.setenv(var, val)
  jex = jax_executor.GraphExecutor(jgraph, activation_dtype='float32')
  jex._weights = dict(jweights)
  jex.prepare_serving_weights(min_weight_params=0)
  topts = dict(int4_drq=True, attn_lengths=True, attn_writeback='stale',
               mlp_bf=128, decode_block=False)
  topts.update(options)
  tex = executor.GraphExecutor(tgraph, device='cpu',
                               activation_dtype='float32', **topts)
  tex.load_weights(tweights)
  tex.prepare_serving_weights(min_weight_params=0)
  return jcfg, jgraph, jex, tex


def _random_caches(cfg, seed):
  rng = np.random.default_rng(seed)
  shape = (BATCH, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
  return {f'layer_{li}_{kind}_cache_in':
          rng.integers(-127, 128, shape).astype(np.int8)
          for li in range(cfg.num_layers) for kind in 'kv'}


def _inputs(cfg, pos, lengths, seed):
  """One decode step at position pos (the row written), each batch row's
  prefix mask of its own length (0: hidden everywhere)."""
  rng = np.random.default_rng(seed)
  g = cfg.num_query_heads // cfg.num_kv_heads
  mask = np.full((BATCH, 1, g, cfg.max_seq_len), -1e9, np.float32)
  for r, n in enumerate(lengths):
    mask[r, ..., :n] = 0.0
  return {'tokens': rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(
              np.int32),
          'positions': np.full((BATCH, 1), pos, np.int32),
          'mask': mask, 'cache_pos': np.array([0, 0, pos, 0], np.int32)}


def _steps(cfg, jgraph, jex, tex, lengths_of=None):
  """STEPS decode steps from position 37 over random caches; both sides
  take the JAX side's output caches as the next inputs. Yields (step, JAX
  outputs, port outputs, the port's input caches)."""
  sig = jgraph.signature_by_key('decode')
  caches = _random_caches(cfg, 1)
  for step in range(STEPS):
    pos = 37 + step
    lengths = lengths_of(pos) if lengths_of else [pos + 1] * BATCH
    feed = dict(caches, **_inputs(cfg, pos, lengths, step))
    jout = jex._run_signature(sig.subgraph_index, 'decode', False,
                              jex._weights,
                              {k: jnp.asarray(v) for k, v in feed.items()})
    tin = {k: torch.from_numpy(np.array(v)) for k, v in feed.items()}
    tout = tex(tin, 'decode')
    yield step, jout, tout, tin
    caches = {f'{k}_in': np.asarray(jout[k]) for k in jout
              if k.endswith('_cache')}


def _assert_step_matches(jout, tout, step, rows=slice(None)):
  """Logits within rtol 1e-4, atol 1e-4, int8 cache codes within one
  rounding step, of the batch rows `rows`."""
  np.testing.assert_allclose(tout['logits'].numpy()[rows],
                             np.asarray(jout['logits'])[rows], rtol=1e-4,
                             atol=1e-4, err_msg=f'step {step}')
  for key, val in tout.items():
    if key.endswith('_cache'):
      diff = np.abs(val.numpy()[rows].astype(np.int32)
                    - np.asarray(jout[key])[rows].astype(np.int32))
      assert diff.max() <= 1, (key, step)


def test_splice_decode_matches_jax(monkeypatch):
  """attn_writeback='splice' against AEQT_ATTN_WRITEBACK_MODE=splice (the
  JAX executor writes and attends unfused off the TPU): logits and caches;
  one splice call a layer a step, each writing into the step's input
  pools, which are the output pools."""
  cfg, jgraph, jex, tex = _decode_pair(
      monkeypatch, {'AEQT_ATTN_WRITEBACK': '1',
                    'AEQT_ATTN_WRITEBACK_MODE': 'splice'},
      {'attn_writeback': 'splice'})
  assert all('writeback' in f for f in tex._attn_fusions.values())
  before = WRITEBACK.plain_calls
  for step, jout, tout, tin in _steps(cfg, jgraph, jex, tex):
    _assert_step_matches(jout, tout, step)
    for li in range(cfg.num_layers):
      for kind in 'kv':
        key = f'layer_{li}_{kind}_cache'
        assert tout[key] is tin[f'{key}_in']
  assert WRITEBACK.plain_calls - before == STEPS * cfg.num_layers


def test_inplace_row_write_decode_matches_jax(monkeypatch):
  """cache_write_inplace with the writeback off against
  AEQT_CACHE_WRITE_PALLAS=1: logits and caches; two row writes a layer a
  step (the lengths attention reads their outputs), each into its input
  pool."""
  cfg, jgraph, jex, tex = _decode_pair(
      monkeypatch, {'AEQT_ATTN_WRITEBACK': '0',
                    'AEQT_CACHE_WRITE_PALLAS': '1'},
      {'attn_writeback': None, 'cache_write_inplace': True})
  before = (ROW_WRITE.plain_calls, attention.decode_attention_int8_lengths
            .plain_calls)
  for step, jout, tout, tin in _steps(cfg, jgraph, jex, tex):
    _assert_step_matches(jout, tout, step)
    for key in [k for k in tout if k.endswith('_cache')]:
      assert tout[key] is tin[f'{key}_in']
  layers = cfg.num_layers
  assert (ROW_WRITE.plain_calls - before[0],
          attention.decode_attention_int8_lengths.plain_calls - before[1]) == (
              2 * STEPS * layers, STEPS * layers)


# Head-input DRQ codes that may flip by one step in a dynlen step (of 3
# active rows * 256): an ulp of the final RMS_NORM's output moves a row's
# absmax, and a code at x / xs = n + 0.5 rounds the other way (ROADMAP
# Queue 3; read: one flip at step 2, batch row 2, column 135, code 15 in
# JAX, 16 in the port, the element itself equal on both sides).
HEAD_FLIPS = 2


def _record_head_inputs(monkeypatch, jex, tex, logits_tid):
  """Both executors' logits-FC input of the latest step, and the port's
  dequantized head weight: {'jax': ..., 'port': ..., 'w': [V, D]}."""
  seen = {}
  for side, ex in (('jax', jex), ('port', tex)):
    def eval_op(sg_idx, sg, op, env, _orig=ex._eval_op, _side=side):
      _orig(sg_idx, sg, op, env)
      if op.opcode == 'FULLY_CONNECTED' and op.outputs[0] == logits_tid:
        seen[_side] = env[op.inputs[0]]
        if _side == 'port':
          seen['w'] = tex._dequant_view(sg, op.inputs[1], env)
    monkeypatch.setattr(ex, '_eval_op', eval_op)
  return seen


def _assert_logits_up_to_head_flips(jout, tout, seen, step, rows):
  """The logits of `rows` within rtol 1e-4, atol 1e-4, but where the head's
  input DRQ codes (pq.quantize_rows_drq, the int8 FC's) flipped: codes
  within one step and at most HEAD_FLIPS a step, and a row with a flip
  within that tolerance plus its flipped codes' own steps, xs * |w[:, k]|
  summed over them (the flip-count rule of test_torch_port_attn_block /
  test_torch_port_block)."""
  jx = torch.from_numpy(np.array(seen['jax'], dtype=np.float32))
  tx = seen['port'].to(torch.float32)
  jq, _ = pq.quantize_rows_drq(jx.reshape(BATCH, -1)[rows])
  tq, txs = pq.quantize_rows_drq(tx.reshape(BATCH, -1)[rows])
  flips = (tq.to(torch.int32) - jq.to(torch.int32)).abs()
  assert int(flips.max()) <= 1, step
  assert int(torch.count_nonzero(flips)) <= HEAD_FLIPS, step
  moved = torch.matmul(flips.to(torch.float32) * txs,
                       seen['w'].to(torch.float32).abs().T).numpy()
  want = np.asarray(jout['logits'])[rows].reshape(moved.shape)
  got = tout['logits'].numpy()[rows].reshape(moved.shape)
  off = np.abs(got - want) - (1e-4 + 1e-4 * np.abs(want))
  assert np.all(off <= moved), (step, float(off.max()))


def test_dynlen_decode_matches_jax_on_active_rows(monkeypatch):
  """attn_dynlen with attn_lengths off against AEQT_ATTN_DYNLEN=1 (the JAX
  executor's XLA twin off the TPU), at S 512 (two chunks of 256, one row
  block of 4): the caches of the rows with a visible prefix within one
  code, their logits within rtol 1e-4, atol 1e-4 (test_kernels.py's
  dynlen tolerance) but for flipped head-input codes
  (_assert_logits_up_to_head_flips). Row 0 is an idle slot (mask hidden
  everywhere): the twin spreads it over all S rows, the kernel over its
  block's chunks, so its logits and its second layer's cache rows are not
  compared."""
  cfg, jgraph, jex, tex = _decode_pair(
      monkeypatch, {'AEQT_ATTN_WRITEBACK': '0', 'AEQT_ATTN_LENGTHS': '0',
                    'AEQT_ATTN_DYNLEN': '1'},
      {'attn_writeback': None, 'attn_lengths': False, 'attn_dynlen': True},
      cfg_kw={'max_seq_len': 512})
  seen = _record_head_inputs(
      monkeypatch, jex, tex, jgraph.signature_by_key('decode').outputs['logits'])
  before = DYNLEN.plain_calls
  active = slice(1, None)
  for step, jout, tout, _ in _steps(
      cfg, jgraph, jex, tex, lambda pos: [0, pos + 1, 300, 200 + pos]):
    _assert_logits_up_to_head_flips(jout, tout, seen, step, active)
    for key, val in tout.items():
      if key.endswith('_cache'):
        diff = np.abs(val.numpy()[active].astype(np.int32)
                      - np.asarray(jout[key])[active].astype(np.int32))
        assert diff.max() <= 1, (key, step)
  assert DYNLEN.plain_calls - before == STEPS * cfg.num_layers


# -- donation ---------------------------------------------------------------


@pytest.mark.parametrize('options', [
    {},
    {'attn_writeback': None},
    {'attn_writeback': 'stale', 'decode_block': True},
])
def test_options_off_leave_the_inputs_unchanged(options):
  """Splice and in-place writes off: every input pool keeps its bytes and
  every output pool is another tensor."""
  cfg = gemma.DecoderConfig(**SERVE_CFG)
  graph = gemma.build_decoder(cfg, batch=BATCH, signatures=('decode',),
                              materialize_weights=False,
                              fused_projections=True, greedy_head=True)
  gemma.stamp_int8_kv_cache(graph)
  tex = executor.GraphExecutor(graph, device='cpu',
                               activation_dtype='float32',
                               **dict(dict(decode_block=False), **options))
  tex.load_weights(gemma.device_materialize_quantized(graph, device='cpu'))
  tex.prepare_serving_weights(min_weight_params=0)
  tin = {k: torch.from_numpy(v) for k, v in dict(
      _random_caches(cfg, 2), **_inputs(cfg, 40, [41] * BATCH, 2)).items()}
  kept = {k: v.clone() for k, v in tin.items()}
  tout = tex(tin, 'decode')
  for key, val in tin.items():
    assert torch.equal(val, kept[key]), key
  for key in [k for k in tout if k.endswith('_cache')]:
    assert tout[key].data_ptr() != tin[f'{key}_in'].data_ptr()


@pytest.mark.parametrize('options', [
    {'attn_writeback': 'splice'},
    {'attn_writeback': None, 'cache_write_inplace': True},
])
def test_options_on_donate_the_input_pools(options):
  """Splice or in-place writes: each output pool is its input tensor
  (data_ptr equal) and holds what the functional route (stale writeback,
  every input unchanged) returns, bit for bit; the logits agree to 1e-5."""
  cfg = gemma.DecoderConfig(**SERVE_CFG)
  graph = gemma.build_decoder(cfg, batch=BATCH, signatures=('decode',),
                              materialize_weights=False,
                              fused_projections=True, greedy_head=False)
  gemma.stamp_int8_kv_cache(graph)
  weights = gemma.device_materialize_quantized(graph, device='cpu')
  feed = dict(_random_caches(cfg, 3), **_inputs(cfg, 40, [41] * BATCH, 3))
  outs = {}
  for name, opts in (('functional', {}), ('donating', options)):
    tex = executor.GraphExecutor(graph, device='cpu',
                                 activation_dtype='float32',
                                 decode_block=False, **opts)
    tex.load_weights(weights)
    tex.prepare_serving_weights(min_weight_params=0)
    tin = {k: torch.from_numpy(np.array(v)) for k, v in feed.items()}
    ptrs = {k: v.data_ptr() for k, v in tin.items()}
    outs[name] = (tex(tin, 'decode'), ptrs)
  (want, _), (got, ptrs) = outs['functional'], outs['donating']
  for key in [k for k in got if k.endswith('_cache')]:
    assert got[key].data_ptr() == ptrs[f'{key}_in'], key
    assert torch.equal(got[key], want[key]), key
  np.testing.assert_allclose(got['logits'].numpy(), want['logits'].numpy(),
                             rtol=1e-5, atol=1e-5)


# -- the blockwise-128 server ----------------------------------------------------

BLOCKWISE_CFG = dict(SERVE_CFG)
WRAPPERS = {
    'blockwise': BLOCKWISE, 'dynlen': DYNLEN,
    'flash': attention.flash_attention_int8_masked,
    'masked': attention.decode_attention_int8_masked,
    'lengths': attention.decode_attention_int8_lengths,
    'weight_only': pq.qmatmul_int4_packed,
    'int4_drq': pq.qmatmul_int4_packed_drq,
    'int_weights': int_qmatmul.qmatmul_int_weights}


def _blockwise_quantized(gemma_mod, quantizer_cls, cfg):
  """The serving graph with every FC int4 in blocks of 128
  (add_dynamic_config's granularity, recipe_manager.py:156-161)."""
  graph = gemma_mod.build_serving_decoder(cfg, batch_slots=SLOTS,
                                          **BENCH_KW)
  gemma_mod.stamp_int8_kv_cache(graph)
  qt = quantizer_cls(graph)
  qt.add_dynamic_config('.*', 'FULLY_CONNECTED', 4,
                        granularity='BLOCKWISE_128')
  return qt.quantize()


@pytest.fixture(scope='module')
def blockwise_servers(tmp_path_factory):
  """Both packages' blockwise-128 quantization of the toy serving graph
  (their .aeqg files compared byte for byte), served by a JAX server with
  only AEQT_ATTN_DYNLEN=1 set and by the port's with JAX_DEFAULT_OPTIONS
  plus attn_dynlen, every FC packed."""
  tmp = tmp_path_factory.mktemp('blockwise')
  with pytest.MonkeyPatch.context() as mp:
    for var in [v for v in os.environ if v.startswith('AEQT_')]:
      mp.delenv(var)
    mp.setenv('AEQT_ATTN_DYNLEN', '1')
    jcfg = jax_gemma.DecoderConfig(**BLOCKWISE_CFG)
    tcfg = gemma.DecoderConfig(**BLOCKWISE_CFG)
    jres = _blockwise_quantized(jax_gemma, JaxQuantizer, jcfg)
    tres = _blockwise_quantized(gemma, Quantizer, tcfg)
    paths = (str(tmp / 'jax.aeqg'), str(tmp / 'port.aeqg'))
    jres.export_model(paths[0])
    tres.export_model(paths[1])
    with open(paths[0], 'rb') as f0, open(paths[1], 'rb') as f1:
      same_bytes = f0.read() == f1.read()
    tserver = batching.DecodeServer(
        tres.quantized_model, tcfg, SLOTS, pack_weights=True,
        activation_dtype='float32', device='cpu', starvation_age_s=None,
        executor_options={**executor.JAX_DEFAULT_OPTIONS,
                          'attn_dynlen': True})
    tserver._executor.prepare_serving_weights(min_weight_params=0)
    jserver = jax_batching.DecodeServer(jres.quantized_model, jcfg, SLOTS,
                                        pack_weights=True,
                                        activation_dtype='float32',
                                        starvation_age_s=None)
    jserver._executor.prepare_serving_weights(min_weight_params=0)
    for server in (tserver, jserver):
      _track(server)
    yield jserver, tserver, tcfg, same_bytes, tres.quantized_model


def test_blockwise_aeqg_matches_jax(blockwise_servers):
  """The same .aeqg bytes; every FC weight int4 in blocks of 128, and
  every one packed by both executors, with the block size kept."""
  jserver, tserver, cfg, same_bytes, graph = blockwise_servers
  assert same_bytes
  ex = tserver._executor
  fc_weights = {(i, op.inputs[1]) for i, sg in enumerate(graph.subgraphs)
                for op in sg.ops if op.opcode == 'FULLY_CONNECTED'}
  for i, tid in fc_weights:
    q = graph.subgraphs[i].tensors[tid].quantization
    assert q.block_size == 128 and graph.subgraphs[i].tensors[tid].dtype == (
        'int4')
  assert ex._packed_int4_keys == fc_weights == (
      jserver._executor._packed_int4_keys)
  assert set(ex._packed_block_size.values()) == {128}
  assert not ex._mlp_fusions and not ex._head_fusions
  assert ex.attn_dynlen and not ex.attn_lengths


@pytest.mark.parametrize('chunk', [0, 4])
def test_blockwise_server_tokens_match_jax(chunk, blockwise_servers):
  """The same trace through both servers: the same tokens (the active
  slots' ids), statuses and metrics. Per tick, per layer, four blockwise
  FCs (QKV, out-projection, gate/up, down) and one live-prefix attention,
  then the blockwise head; per prefill pass the FCs and the flash
  attention; nothing else."""
  jserver, tserver, cfg, _, _ = blockwise_servers
  trace = _trace(cfg, seed=3 + chunk)
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
  layers = cfg.num_layers
  ran = {name: f.plain_calls - before[name] for name, f in WRAPPERS.items()}
  want_ran = dict.fromkeys(WRAPPERS, 0)
  want_ran.update(blockwise=(4 * layers + 1) * (ticks + passes),
                  dynlen=layers * ticks, flash=layers * passes)
  assert ran == want_ran
