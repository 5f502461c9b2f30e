"""The attention compute modes of the port (`attn_compute`), on the CPU.

The JAX executor's AEQT_ATTN_COMPUTE ('f32', 'bf16', 'int8') is the port's
`GraphExecutor(attn_compute=...)`. Inputs made with numpy from a seed go
through the Pallas kernels in interpret mode, compiled with XLA's excess
precision off (`_exact`: XLA on the CPU otherwise drops the kernels' bf16
roundings), and through the port's wrappers on CPU tensors, which run the
plain versions.

Kernels, in bf16 and int8, G 8, H 128 and 256, S 256, zero points 3 and
-2: the stale attention (#2, `_ctx_prefix_len_cur`), the lengths
attention (#7, `_ctx_prefix_len`) and the decode block (#5, its attention
in the mode). int8 K/V values and bf16 q are exact in bf16 and their
products exact in f32, and the int8 mode's dots are integer sums (exact
in f32 below 2^24), so the port and the reference differ only in the
order of f32 sums (the zero-point sum, the softmax, the bf16 mode's dots):
a context row (one query row's H values) within MODE_FINE of
max(max |ctx|, 1), except a row where a probability's operand rounded the
other way (a bf16 step, or an int8 code of 1/127): at most MODE_ROWS_OFF
rows, each within MODE_FLIP_STEPS steps of the V span (the block's ctx
within its f32 tolerance, 5e-5, on the same terms; its int8 codes and
pools equal, x_ffn within 2e-6).

Slice (tests/test_torch_port_attn_compute_serving.py, which reuses this
file's helpers): bench.py's decode graph at test_torch_port_block's narrow
3-layer width with the decode block, and the serving graph's DecodeServer,
under each mode, against the JAX executor with AEQT_ATTN_COMPUTE set. Two
differences of the JAX executor off a TPU are named there, not hidden:
  * it runs the decode block in interpret mode in the mode
    (executor.py:589), as the port's plain version does: the same;
  * it runs the stale attention (executor.py:1916, layer 0 of the decode
    step) and the lengths attention (executor.py:2047, the server's ticks)
    on its f32 XLA twin whatever the mode, where the port runs them in
    the mode. With those two wrappers held to f32 the port equals the JAX
    executor (ids and caches); run in the mode, their contexts differ from
    f32 on the same inputs by at most MODE_VS_F32 of the largest
    magnitude, and by more than nothing.
The splice, masked and epilogue attentions in the modes are held in
tests/test_torch_port_attn_modes_{kernels,servers,decode}.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention, pallas_block
from ai_edge_quantizer_tpu.kernels import pallas_mlp, pallas_qmatmul
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention, block
from ai_edge_quantizer_tpu_torch.kernels import mlp, packed_qmatmul

from test_torch_port_attn_block import _exact
from test_torch_port_attn_block import _graphs as attn_block_graphs
from test_torch_port_attn_block import _inputs as attn_block_inputs
from test_torch_port_attn_block import _random_caches

MODES = ('bf16', 'int8')
MODE_FINE = 1e-5
MODE_ROWS_OFF = 1
MODE_FLIP_STEPS = 2
# A mode's context against f32 on the same inputs, relative to the largest
# magnitude. bf16: q and the probabilities rounded to 8 bits (2^-9
# relative each); int8: q to 1/254 of its absmax and each probability to
# 1/127, every probability below 1/254 to 0, so a flat softmax over many
# rows loses most of its weight (read: bf16 1.6e-3 at the decode step's
# layer 0, 3.5e-3 over the server's ticks; int8 0.108 and 0.011).
MODE_VS_F32 = {'bf16': 2e-2, 'int8': 2e-1}
ZP_K, ZP_V, K_SCALE, V_SCALE = 3.0, -2.0, 0.05, 0.03


def _t(a):
  return torch.from_numpy(np.array(a))


def _j(a):
  return jnp.asarray(np.asarray(a))


def _flip_step(mode, v_scale, zp_v):
  """One probability operand's flip: a bf16 step (2^-8 of p <= 1) or an
  int8 code (1/127 with p_sum about 127), times the V span."""
  span = (127.0 + abs(zp_v)) * v_scale
  return span * 2.0**-8 if mode == 'bf16' else 2.0 * span / 127.0


def _check_ctx(got, want, mode, v_scale, zp_v, fine=MODE_FINE):
  """The module docstring's rule; returns the rows beyond fine."""
  h = want.shape[-1]
  g, w = np.asarray(got, np.float64).reshape(-1, h), np.asarray(
      want, np.float64).reshape(-1, h)
  tol = fine * max(np.abs(w).max(), 1.0)
  rows = np.max(np.abs(g - w), axis=1)
  off = int(np.sum(rows > tol))
  assert off <= MODE_ROWS_OFF, (off, rows.max(), tol)
  assert rows.max() <= tol + MODE_FLIP_STEPS * _flip_step(
      mode, v_scale, zp_v), rows.max()
  return off


def _attn_case(seed, b, nk, h, s=256, g=8):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal((b, nk, g, h)).astype(np.float32),
          rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8),
          rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8),
          rng.integers(-127, 128, (b, nk, 1, h)).astype(np.int8),
          rng.integers(-127, 128, (b, nk, 1, h)).astype(np.int8))


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('nk,h', [(1, 128), (1, 256), (2, 128)])
@pytest.mark.parametrize('mode', MODES)
def test_stale_attention_mode_matches_pallas(mode, nk, h, out_dtype):
  """#2: lengths 1 (the new row only), a middle prefix and S (the stale
  rows < lengths - 1)."""
  q, kc, vc, kn, vn = _attn_case(h + nk, 3, nk, h)
  s = kc.shape[2]
  lengths = np.array([1, 97, s], np.int32)
  fn = _exact(pallas_attention.decode_attention_int8_lengths_stale)
  want = np.asarray(fn(
      _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lengths), _j(kn), _j(vn),
      k_zero_point=ZP_K, v_zero_point=ZP_V, compute=mode, batch_block=1,
      out_dtype=getattr(jnp, out_dtype), interpret=True).astype(jnp.float32))
  wrapper = attention.decode_attention_int8_lengths_stale
  before = (wrapper.plain_calls, wrapper.launches)
  got = wrapper(_t(q), _t(kc), _t(vc), K_SCALE, V_SCALE, _t(lengths),
                _t(kn), _t(vn), k_zero_point=ZP_K, v_zero_point=ZP_V,
                compute=mode, out_dtype=getattr(torch, out_dtype))
  assert (wrapper.plain_calls, wrapper.launches) == (before[0] + 1,
                                                     before[1])
  assert got.dtype == getattr(torch, out_dtype)
  fine = MODE_FINE if out_dtype == 'float32' else 2.0**-8
  _check_ctx(got.float().numpy(), want, mode, V_SCALE, ZP_V, fine)


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('nk,h', [(1, 128), (1, 256), (2, 128)])
@pytest.mark.parametrize('mode', MODES)
def test_lengths_attention_mode_matches_pallas(mode, nk, h, out_dtype):
  """#7: lengths 0 (every row weighs 1/S), 1, a middle prefix and S."""
  q, kc, vc, _, _ = _attn_case(h + nk + 7, 4, nk, h)
  s = kc.shape[2]
  lengths = np.array([0, 1, 97, s], np.int32)
  fn = _exact(pallas_attention.decode_attention_int8_lengths)
  want = np.asarray(fn(
      _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lengths),
      k_zero_point=ZP_K, v_zero_point=ZP_V, compute=mode, batch_block=1,
      out_dtype=getattr(jnp, out_dtype), interpret=True).astype(jnp.float32))
  got = attention.decode_attention_int8_lengths(
      _t(q), _t(kc), _t(vc), K_SCALE, V_SCALE, _t(lengths),
      k_zero_point=ZP_K, v_zero_point=ZP_V, compute=mode,
      out_dtype=getattr(torch, out_dtype))
  fine = MODE_FINE if out_dtype == 'float32' else 2.0**-8
  _check_ctx(got.float().numpy(), want, mode, V_SCALE, ZP_V, fine)


@pytest.mark.parametrize('mode', MODES)
def test_lengths_mode_reads_the_int8_codes_exactly(mode):
  """In int8 the context is (sum of codes times V) / p_sum: with one live
  row (its probability 1, code 127) the output is that row's V exactly;
  in bf16 likewise (probability 1 is exact in bf16)."""
  q, kc, vc, _, _ = _attn_case(11, 2, 1, 128)
  lengths = np.array([1, 1], np.int32)
  got = attention.decode_attention_int8_lengths(
      _t(q), _t(kc), _t(vc), K_SCALE, V_SCALE, _t(lengths),
      k_zero_point=ZP_K, v_zero_point=ZP_V, compute=mode).numpy()
  want = (vc[:, :, :1].astype(np.float32) - np.float32(ZP_V)) * np.float32(
      V_SCALE)
  np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))


def test_unknown_compute_mode_raises():
  q, kc, vc, kn, vn = _attn_case(12, 1, 1, 128)
  lengths = np.array([5], np.int32)
  with pytest.raises(ValueError, match='compute'):
    attention.decode_attention_int8_lengths(
        _t(q), _t(kc), _t(vc), 1.0, 1.0, _t(lengths), compute='fp8')
  with pytest.raises(ValueError, match='compute'):
    attention.decode_attention_int8_lengths_stale(
        _t(q), _t(kc), _t(vc), 1.0, 1.0, _t(lengths), _t(kn), _t(vn),
        compute='fp8')
  assert attention.compute_code('int8') == 2
  with pytest.raises(ValueError):
    attention.compute_code('f16')


# -- #5: the decode block in a compute mode --------------------------------------

BB, BD, BF_, BF, BNQ, BH, BS = 16, 256, 512, 256, 4, 128, 64
BKS, BVS, BKQ, BVQ = 0.061, 0.059, 0.061, 0.059


@pytest.fixture(scope='module')
def block_weights():
  rng = np.random.default_rng(10)
  return dict(
      x=rng.standard_normal((BB, BD)).astype(np.float32) * 0.5,
      g1=(rng.random(BD) * 0.2 + 0.9).astype(np.float32),
      g2=(rng.random(BD) * 0.2 + 0.9).astype(np.float32),
      wgu=rng.integers(-7, 8, (2 * BF_, BD)).astype(np.int8),
      sgu=(rng.random(2 * BF_) * 0.01 + 0.005).astype(np.float32),
      wd=rng.integers(-7, 8, (BD, BF_)).astype(np.int8),
      sd=(rng.random(BD) * 0.01 + 0.005).astype(np.float32),
      wqkv=rng.integers(-7, 8, ((BNQ + 2) * BH, BD)).astype(np.int8),
      sqkv=(rng.random((BNQ + 2) * BH) * 0.01 + 0.005).astype(np.float32),
      kc=rng.integers(-127, 128, (BB, BS, BH)).astype(np.int8),
      vc=rng.integers(-127, 128, (BB, BS, BH)).astype(np.int8))


def _rope(pos):
  half = BH // 2
  freqs = 10000.0 ** (-np.arange(0, half, dtype=np.float32) / half)
  ang = np.float32(pos) * freqs
  return (np.broadcast_to(np.cos(ang), (BB, half)).astype(np.float32),
          np.broadcast_to(np.sin(ang), (BB, half)).astype(np.float32))


@pytest.mark.parametrize('pos', [31, BS - 1])
@pytest.mark.parametrize('mode', MODES)
def test_block_mode_matches_pallas(mode, pos, block_weights):
  w = block_weights
  rng = np.random.default_rng(pos)
  lengths = rng.integers(1, pos + 2, BB).astype(np.int32)
  lengths[0] = pos + 1
  cos, sin = _rope(pos)
  fn = _exact(pallas_block.fused_mlp_qkv_attention)
  ctx, x_ffn, k_new, v_new, _, _ = fn(
      _j(w['x']), _j(w['g1']),
      pallas_qmatmul.pack_int4_split(_j(w['wgu'])), _j(w['sgu']),
      pallas_mlp.pack_int4_split_grouped(_j(w['wd']), BF), _j(w['sd']),
      _j(w['g2']), pallas_qmatmul.pack_int4_split(_j(w['wqkv'])),
      _j(w['sqkv']), _j(cos), _j(sin), _j(w['kc']), _j(w['vc']),
      _j(lengths), jnp.int32(pos), BKS, BVS, BKQ, BVQ, BNQ, act='gelu',
      eps=1e-6, compute=mode, bf=BF, bb=4, ring=2, writeback=False,
      interpret=True)
  t = torch.from_numpy
  kp, vp = t(w['kc'].copy()), t(w['vc'].copy())
  wrapper = block.fused_mlp_qkv_attention
  before = (wrapper.plain_calls, wrapper.launches)
  got = wrapper(
      t(w['x']), t(w['g1']), packed_qmatmul.pack_int4_split(t(w['wgu'])),
      t(w['sgu']), mlp.pack_int4_split_grouped(t(w['wd']), BF), t(w['sd']),
      t(w['g2']), packed_qmatmul.pack_int4_split(t(w['wqkv'])),
      t(w['sqkv']), t(cos), t(sin), kp, vp, t(lengths), pos, BKS, BVS, BKQ,
      BVQ, BNQ, eps=1e-6, bf=BF, compute=mode)
  assert (wrapper.plain_calls, wrapper.launches) == (before[0] + 1,
                                                     before[1])
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(k_new))
  np.testing.assert_array_equal(got[3].numpy(), np.asarray(v_new))
  np.testing.assert_array_equal(kp.numpy()[:, pos], np.asarray(k_new))
  xw = np.asarray(x_ffn.astype(jnp.float32))
  np.testing.assert_allclose(got[1].numpy(), xw, rtol=0,
                             atol=2e-6 * np.abs(xw).max())
  _check_ctx(got[0].numpy(), np.asarray(ctx), mode, BVS, 0.0, fine=5e-5)
  # The mode ran: the f32 block's ctx differs.
  f32 = block.fused_mlp_qkv_attention_plain(
      t(w['x']), t(w['g1']), packed_qmatmul.pack_int4_split(t(w['wgu'])),
      t(w['sgu']), mlp.pack_int4_split_grouped(t(w['wd']), BF), t(w['sd']),
      t(w['g2']), packed_qmatmul.pack_int4_split(t(w['wqkv'])),
      t(w['sqkv']), t(cos), t(sin), t(w['kc'].copy()), t(w['vc'].copy()),
      t(lengths), pos, BKS, BVS, BKQ, BVQ, BNQ, eps=1e-6, bf=BF)
  assert not torch.equal(f32[0], got[0])


# -- the recorder the slice's tests patch in ---------------------------------------


class _Recorder:
  """Wraps an attention wrapper: records, per call, the mode it was asked
  for, the output in that mode and the f32 output on the same inputs (its
  plain version; a tuple output, the splice's, by its first element);
  with `as_jax`, returns the f32 output (the JAX executor's XLA twin off
  a TPU)."""

  def __init__(self, fn, plain, as_jax=False):
    self.fn, self.plain, self.as_jax = fn, plain, as_jax
    self.pairs, self.modes = [], []
    self.calls = 0

  # The wrapper counts its runs under its module name, which is this
  # recorder while it is patched in: forward the two counters.
  plain_calls = property(lambda self: self.fn.plain_calls,
                         lambda self, v: setattr(self.fn, 'plain_calls', v))
  launches = property(lambda self: self.fn.launches,
                      lambda self, v: setattr(self.fn, 'launches', v))

  def __call__(self, *args, **kw):
    self.calls += 1
    self.modes.append(kw.get('compute'))
    f32 = self.plain(*args, **dict(kw, compute='f32'))
    if self.as_jax:
      return f32
    out = self.fn(*args, **kw)
    first = (lambda o: o[0] if isinstance(o, tuple) else o)
    self.pairs.append((first(out).float(), first(f32).float()))
    return out

  def largest_rel_diff(self):
    return max(float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
               for a, b in self.pairs)


# -- the routes that take no mode ----------------------------------------------


def test_live_prefix_route_takes_no_mode():
  """The live-prefix (dynlen) attention has no compute mode in the JAX
  executor either: the same step in every mode."""
  jcfg, _, tgraph, (_, tweights) = attn_block_graphs('mqa128', True)
  feed = dict(_random_caches(jcfg, 2), **attn_block_inputs(jcfg, 37, 1))
  outs = []
  for compute in ('f32',) + MODES:
    tex = executor.GraphExecutor(
        tgraph, device='cpu', activation_dtype='float32',
        **dict(executor.JAX_DEFAULT_OPTIONS, attn_dynlen=True,
               attn_compute=compute))
    tex.load_weights(tweights)
    tex.prepare_serving_weights(min_weight_params=0)
    outs.append(tex({k: torch.from_numpy(np.array(v))
                     for k, v in feed.items()}, 'decode'))
  for out in outs[1:]:
    for key in out:
      torch.testing.assert_close(out[key], outs[0][key], rtol=0, atol=0)


def test_executor_refuses_an_unknown_mode():
  _, _, tgraph, _ = attn_block_graphs('mqa128', True)
  with pytest.raises(ValueError, match='attn_compute'):
    executor.GraphExecutor(tgraph, device='cpu', attn_compute='fp8')
  assert executor.GraphExecutor(tgraph, device='cpu').attn_compute == 'f32'
