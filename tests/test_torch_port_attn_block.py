"""The norm fusion and the attention-block fusions of the port, on the CPU.

Kernels: inputs made with numpy from a seed go through the Pallas kernels
in interpret mode and through the port's wrappers on CPU tensors, which
run the plain versions:
  * `qmatmul_int4_packed_rmsnorm` (pallas_qmatmul.py:297): f32 and bf16 x,
    with and without a bias, and with N padded (the executor slices the
    true N off and adds the bias after): within
    `int_weights_tolerance` of max |y| (f32 sums in another order), one
    bf16 ulp more at bf16 x;
  * `qkv_rope` (pallas_qkv.py:177): f32 and bf16 x, DRQ on and off, MQA and
    GQA (nk 2): DRQ within 1e-6 of max |y| (the JAX norm takes an f32
    mean, the port an f64 sum of squares: an ulp of r moves xs and the
    codes' scale by an ulp, see ops/impl.py `rms_inverse`), weight-only
    within `int_weights_tolerance`; bf16 outputs one bf16 ulp beyond those;
  * `decode_attention_oproj` (pallas_attention.py:1268): f32 and bf16
    x_res, DRQ on and off, lengths 0 and S among random ones: the plain
    version given the Pallas kernel's own context (its attention repeated
    in JAX) bit for bit with DRQ at bf16, at f32 within the FMA that XLA
    on the CPU makes of the residual add; against the Pallas kernel end to
    end a
    row may differ beyond 1e-5 of max |y| only by whole DRQ code steps of
    its context (the two attentions sum in f32 in other orders), at most
    two codes a row, in at most ROWS_OFF rows;
  * at Gemma-2B's width (D 2048, 256 rows) `qkv_rope`'s norm codes against
    the Pallas formula's: at most NORM_FLIPS flips of one step.

XLA on the CPU drops a bf16 rounding of an intermediate that it can keep
in f32 (`xla_allow_excess_precision`, on by default): the Pallas kernels'
bf16 roundings then do not happen in interpret mode. The references here
are compiled with it off (`_exact`), so that they round where the kernels'
source says, as the TPU does.

Executor: bench.py's decode graph (fused projections; MQA at
test_torch_port_slice's widths, its head dim 128 variant SERVE_CFG, and
TOY_DECODER, whose two KV heads take only the prologue) on the port's
executor with norm_fusion / attn_block (attn_qkv, attn_oproj) against the
JAX executor with the matching AEQT_* variables over bench.py's other
settings: the same units; then two decode steps over random int8 caches
with DRQ on and off at f32 and bf16 activations, logits, caches and ids.
With the options off (the port's defaults and JAX_DEFAULT_OPTIONS) no
unit of the three forms.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu.kernels import pallas_qkv
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
from ai_edge_quantizer_tpu_torch.kernels import qkv
from ai_edge_quantizer_tpu_torch.models import gemma

from test_torch_port_serving import SERVE_CFG
from test_torch_port_slice import JAX_SERVING_ENV, MQA, shared_weights

RMSNORM = pq.qmatmul_int4_packed_rmsnorm
QKV = qkv.qkv_rope
OPROJ = attention.decode_attention_oproj
_BF16_EPS = 2.0**-8  # unit roundoff of bf16
ROWS_OFF = 2         # rows of the epilogue test that may carry a code flip
NORM_FLIPS = 16      # of 256 * 2048 norm codes at Gemma-2B's width


def _t(a):
  return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
  return None if a is None else jnp.asarray(np.asarray(a))


def _as_f32(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _exact(fn):
  """fn with XLA's excess precision off: its array arguments traced, the
  others fixed, one compilation per shape and argument."""
  cache = {}

  def call(*args, **kw):
    pos = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]
    key = (tuple((i, args[i].shape, str(args[i].dtype)) for i in pos),
           tuple(repr(a) for i, a in enumerate(args) if i not in pos),
           tuple(sorted((k, repr(v)) for k, v in kw.items())))
    if key not in cache:
      def traced(*arrays):
        full = list(args)
        for i, a in zip(pos, arrays):
          full[i] = a
        return fn(*full, **kw)
      cache[key] = jax.jit(traced).lower(*[args[i] for i in pos]).compile(
          compiler_options={'xla_allow_excess_precision': False})
    return cache[key](*[args[i] for i in pos])

  return call


def _bf16_ulp(a):
  """One bf16 ulp of each entry of an f32 array."""
  return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126))) - 7)


def _within(got, want, tol, bf16):
  """|got - want| <= tol, plus one bf16 ulp of want at bf16."""
  if bf16:
    tol = tol + _bf16_ulp(want)
  return np.all(np.abs(got - want) <= tol)


# -- #14: RMS norm + packed int4 weight-only matmul ---------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', ['plain', 'bias', 'padded'])
def test_rmsnorm_qmatmul_matches_pallas(case, dtype):
  """M 5, K 512, N 256 (padded: 384 rows of which 320 are true, the bias
  added after the slice, as the executor does)."""
  m, k = 5, 512
  n, true_n = (384, 320) if case == 'padded' else (256, None)
  rng = np.random.default_rng(len(case) + len(dtype))
  x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
  g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
  w_q = rng.integers(-8, 8, (n, k)).astype(np.int8)
  if true_n:
    w_q[true_n:] = 0
  w = np.asarray(pallas_qmatmul.pack_int4_split(jnp.asarray(w_q)))
  s = (rng.random(n) * 0.01 + 0.005).astype(np.float32)
  b = (rng.standard_normal(true_n or n).astype(np.float32)
       if case != 'plain' else None)
  jx = jnp.asarray(x, dtype)
  kb = None if true_n else b
  want = _as_f32(_exact(pallas_qmatmul.qmatmul_pallas_int4_packed_rmsnorm)(
      jx, _j(g), _j(w), _j(s), _j(kb), interpret=True))
  tx = _t(_as_f32(jx)).to(getattr(torch, dtype))
  before = (RMSNORM.plain_calls, RMSNORM.launches)
  got = RMSNORM(tx, _t(g), _t(w), _t(s), _t(kb))
  assert (RMSNORM.plain_calls, RMSNORM.launches) == (before[0] + 1, before[1])
  assert got.dtype == tx.dtype and got.shape == (m, n)
  got = got.float().numpy()
  if true_n:
    want = want[:, :true_n] + b
    got = got[:, :true_n] + b
  tol = int_qmatmul.int_weights_tolerance(k, 0, float(np.abs(want).max()))
  assert _within(got, want, tol, dtype == 'bfloat16')
  # gamma matters: without it the outputs leave the tolerance.
  bad = RMSNORM(tx, torch.ones(k), _t(w), _t(s), _t(kb)).float().numpy()
  if true_n:
    bad = bad[:, :true_n] + b
  assert np.abs(bad - want).max() > 100 * tol


# -- #20: norm + QKV + RoPE ------------------------------------------------------


def _qkv_case(seed, m, d, nq, nk, h, scale_x=1.0):
  rng = np.random.default_rng(seed)
  n = (nq + 2 * nk) * h
  x = (rng.standard_normal((m, d)) * scale_x).astype(np.float32)
  g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
  w = np.asarray(pallas_qmatmul.pack_int4_split(
      jnp.asarray(rng.integers(-8, 8, (n, d)).astype(np.int8))))
  s = (rng.random(n) * 0.01 + 0.005).astype(np.float32)
  cos, sin = pallas_qkv.rope_cos_sin(jnp.asarray(rng.integers(0, 900, m)),
                                     h, 10000.0)
  return x, g, w, s, np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('drq', [True, False])
@pytest.mark.parametrize('nk', [1, 2])
def test_qkv_rope_matches_pallas(nk, drq, dtype):
  """M 6, D 256, 4 query heads of 64: q, k and v. The same cos/sin feed
  both sides (torch.cos and jnp.cos differ by an ulp)."""
  nq, h, d = 4, 64, 256
  x, g, w, s, cos, sin = _qkv_case(nk + 2 * drq, 6, d, nq, nk, h)
  jx = jnp.asarray(x, dtype)
  want = _exact(pallas_qkv.qkv_rope_pallas)(
      jx, _j(g), _j(w), _j(s), _j(cos), _j(sin), nq=nq, nk=nk, h=h, drq=drq,
      interpret=True)
  tx = _t(_as_f32(jx)).to(getattr(torch, dtype))
  before = QKV.plain_calls
  got = QKV(tx, _t(g), _t(w), _t(s), _t(cos), _t(sin), nq=nq, nk=nk, h=h,
            drq=drq)
  assert QKV.plain_calls == before + 1
  for name, a, b, width in zip('qkv', got, want, (nq, nk, nk)):
    assert a.dtype == tx.dtype and a.shape == (6, width * h), name
    b = _as_f32(b)
    ymax = float(np.abs(b).max())
    tol = 1e-6 * ymax if drq else int_qmatmul.int_weights_tolerance(
        d, 0, ymax)
    assert _within(a.float().numpy(), b, tol, dtype == 'bfloat16'), name
  # The rope matters: q and k from the sine's negation leave the tolerance.
  bad = QKV(tx, _t(g), _t(w), _t(s), _t(cos), _t(-sin), nq=nq, nk=nk, h=h,
            drq=drq)
  assert np.abs(bad[0].float().numpy() - _as_f32(want[0])).max() > 1e-2


def test_qkv_rope_cos_sin_matches_jax():
  """The host frequencies and the angles of pallas_qkv.rope_cos_sin: the
  same f32 angles, cos and sin within an ulp (libm)."""
  pos = np.array([[0], [5], [896], [1023]], np.int32)
  jc, js = pallas_qkv.rope_cos_sin(jnp.asarray(pos), 256, 10000.0)
  tc, ts = qkv.rope_cos_sin(torch.from_numpy(pos), 256, 10000.0)
  assert tc.shape == (4, 1, 128) and tc.dtype == torch.float32
  np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-7)
  np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-7)


def _norm_codes_jax(x, g, eps=1e-6):
  """pallas_qkv.py:77-88's norm and DRQ codes, in JAX outside the kernel."""
  xf = x.astype(jnp.float32)
  rs = jax.lax.rsqrt(jnp.mean(xf * xf, axis=1, keepdims=True) + eps)
  xn = ((x * rs.astype(x.dtype)).astype(jnp.float32) * g).astype(x.dtype)
  xnf = xn.astype(jnp.float32)
  xs = jnp.maximum(jnp.max(jnp.abs(xnf), axis=1, keepdims=True), 1e-9) * (
      1.0 / 127.0)
  return jnp.round(xnf * (1.0 / xs)).astype(jnp.int8)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_qkv_drq_codes_at_gemma_width(dtype):
  """D 2048 over 256 rows of random scales: the prologue's DRQ codes (its
  norm in f64 against JAX's f32 mean) flip by one step in at most
  NORM_FLIPS places; q, k and v through the plain version against the
  Pallas kernel at Gemma-2B's heads (8 of 256, one KV head) differ beyond
  the toy test's tolerance only in rows with a flipped code."""
  m, d, nq, nk, h = 256, 2048, 8, 1, 256
  rng = np.random.default_rng(7)
  x, g, w, s, cos, sin = _qkv_case(7, m, d, nq, nk, h)
  x = x * (rng.random((m, 1)) * 4 + 0.1).astype(np.float32)
  jx = jnp.asarray(x, dtype)
  tx = _t(_as_f32(jx)).to(getattr(torch, dtype))
  want_codes = np.asarray(_exact(_norm_codes_jax)(jx, _j(g)))
  xn = qkv.qkv_norm_plain(tx, _t(g), 1e-6)
  got_codes = pq.quantize_rows_drq(xn.float())[0].numpy()
  diff = got_codes.astype(np.int32) - want_codes.astype(np.int32)
  assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= NORM_FLIPS
  want = _exact(pallas_qkv.qkv_rope_pallas)(
      jx, _j(g), _j(w), _j(s), _j(cos), _j(sin), nq=nq, nk=nk, h=h, drq=True,
      interpret=True)
  got = QKV(tx, _t(g), _t(w), _t(s), _t(cos), _t(sin), nq=nq, nk=nk, h=h,
            drq=True)
  flipped = np.any(diff != 0, axis=1)
  for a, b in zip(got, want):
    a, b = a.float().numpy(), _as_f32(b)
    tol = 1e-6 * np.abs(b).max()
    if dtype == 'bfloat16':
      tol = tol + _bf16_ulp(b)
    rows_off = np.any(np.abs(a - b) > tol, axis=1)
    assert not np.any(rows_off & ~flipped)


# -- #19: attention + out projection + residual ---------------------------------


def _oproj_case(seed, b=8, g=4, h=128, s=128, d=256):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, 1, g, h)).astype(np.float32)
  kq = rng.integers(-127, 128, (b, 1, s, h)).astype(np.int8)
  vq = rng.integers(-127, 128, (b, 1, s, h)).astype(np.int8)
  lens = rng.integers(1, s, b).astype(np.int32)
  lens[0], lens[1] = 0, s
  x = rng.standard_normal((b, d)).astype(np.float32)
  wo = np.asarray(pallas_qmatmul.pack_int4_split(
      jnp.asarray(rng.integers(-8, 8, (d, g * h)).astype(np.int8))))
  so = (rng.random(d) * 0.01 + 0.005).astype(np.float32)
  return q, kq, vq, lens, x, wo, so


KW = dict(k_zero_point=2.0, v_zero_point=-1.0)
SCALES = (0.05, 0.04)


def _jax_ctx(q, kq, vq, lens, cast):
  """The Pallas kernel's context: its body `_ctx_prefix_len` (f32) row by
  row on arrays, q rounded to the activation dtype, the result cast to
  it, compiled as the kernel is."""
  scales = jnp.asarray([[*SCALES, KW['k_zero_point'], KW['v_zero_point']]],
                       jnp.float32)

  def rows(q, kq, vq, lens):
    qf = q.astype(cast).astype(jnp.float32)
    return jnp.stack([pallas_attention._ctx_prefix_len(
        'f32', qf[b, 0], kq[b, 0], vq[b, 0], lens[b], scales).astype(cast)
                      for b in range(q.shape[0])])

  return _exact(rows)(_j(q), _j(kq), _j(vq), _j(lens))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('drq', [True, False])
def test_attention_oproj_matches_pallas(drq, dtype):
  """B 8 (lengths 0, S and random), G 4, H 128, S 128, D 256. End to end
  against the Pallas kernel: rows within 1e-5 of max |y| (DRQ) or
  int_weights_tolerance over K = G*H plus 1e-5 (weight-only), one bf16
  ulp more at bf16, but for at most ROWS_OFF DRQ rows that differ by at
  most two code steps of their context (8 * xs * max so each). Given the
  kernel's context, the plain projection and residual are bit for bit
  (DRQ, bf16; at f32 XLA's FMA of the residual add leaves one rounding)
  or within the tolerance (weight-only)."""
  q, kq, vq, lens, x, wo, so = _oproj_case(3 + drq)
  cast = getattr(jnp, dtype)
  jx = jnp.asarray(x, dtype)
  want = _as_f32(_exact(pallas_attention.decode_attention_oproj_pallas)(
      _j(q), _j(kq), _j(vq), *SCALES, _j(lens), jx, _j(wo), _j(so),
      drq=drq, interpret=True, **KW))
  tx = _t(_as_f32(jx)).to(getattr(torch, dtype))
  before = OPROJ.plain_calls
  got = OPROJ(_t(q), _t(kq), _t(vq), *SCALES, _t(lens), tx, _t(wo), _t(so),
              drq=drq, **KW)
  assert OPROJ.plain_calls == before + 1
  assert got.dtype == tx.dtype and got.shape == x.shape
  got = got.float().numpy()
  bf16 = dtype == 'bfloat16'
  ymax = float(np.abs(want).max())
  k = q.shape[2] * q.shape[3]
  tol = 1e-5 * ymax + (0.0 if drq else int_qmatmul.int_weights_tolerance(
      k, 0, ymax))
  if bf16:
    tol = tol + _bf16_ulp(want)
  err = np.abs(got - want)
  rows_off = np.nonzero(np.any(err > tol, axis=1))[0]
  ctx = _as_f32(_jax_ctx(q, kq, vq, lens, cast)).reshape(len(x), k)
  xs = np.maximum(np.abs(ctx).max(axis=1), 1e-9) / 127.0
  assert len(rows_off) <= (ROWS_OFF if drq else 0), rows_off
  for r in rows_off:
    assert err[r].max() <= 2 * 8 * xs[r] * so.max() + np.max(tol), r
  # Given the Pallas kernel's context: the projection and the residual.
  tctx = _t(ctx).to(getattr(torch, dtype))
  if drq:
    o = pq.qmatmul_int4_packed_drq_plain(tctx, _t(wo), _t(so))
  else:
    o = pq.qmatmul_int4_packed_plain(tctx, _t(wo), _t(so))
  y = (tx + o).float().numpy()
  if drq and bf16:
    np.testing.assert_array_equal(y, want)
  elif drq:
    # XLA on the CPU contracts x + o into an FMA: one f32 rounding apart.
    bound = 2.0**-22 * (np.abs(x) + np.abs(o.numpy()) + np.abs(want))
    assert np.all(np.abs(y - want) <= bound)
  else:
    assert _within(y, want, tol, bf16)


@pytest.mark.parametrize('what', ['gqa', 'odd_g'])
def test_attention_oproj_refuses_as_pallas(what):
  """NK 2 and odd G raise ValueError, as the TPU wrapper does."""
  q, kq, vq, lens, x, wo, so = _oproj_case(0)
  kw = dict(KW)
  if what == 'gqa':
    q = np.concatenate([q, q], axis=1)
    kq, vq = (np.concatenate([a, a], axis=1) for a in (kq, vq))
    jwant = pytest.raises(ValueError, match='MQA')
  else:
    q = q[:, :, :3]
    jwant = pytest.raises(ValueError, match='even head count')
  args = (*SCALES, _t(lens), _t(x), _t(wo), _t(so))
  with jwant:
    pallas_attention.decode_attention_oproj_pallas(
        _j(q), _j(kq), _j(vq), *SCALES, _j(lens), _j(x), _j(wo), _j(so),
        interpret=True, **kw)
  with pytest.raises(ValueError):
    OPROJ(_t(q), _t(kq), _t(vq), *args, **kw)


# -- the executor against the JAX executor ------------------------------------

BATCH = 4
STEPS = 2
# bench.py's decode settings (bench.py:440-464) as JAX variables and port
# options; the block stays on, as there.
BENCH_ENV = JAX_SERVING_ENV + (('AEQT_DECODE_BLOCK', '1'),
                               ('AEQT_ATTN_WRITEBACK', '1'))
BENCH_OPTIONS = dict(int4_drq=True, attn_lengths=True, attn_writeback='stale',
                     mlp_bf=128, decode_block=True)
SETTINGS = {
    'attn_block': ({'AEQT_ATTN_BLOCK': '1'}, {'attn_block': True}),
    'norm_fusion': ({'AEQT_NORM_FUSION': '1'}, {'norm_fusion': True}),
    'both': ({'AEQT_ATTN_BLOCK': '1', 'AEQT_NORM_FUSION': '1'},
             {'attn_block': True, 'norm_fusion': True}),
    'qkv_only': ({'AEQT_ATTN_BLOCK': '1', 'AEQT_ATTN_OPROJ': '0'},
                 {'attn_block': True, 'attn_oproj': False}),
    'oproj_only': ({'AEQT_ATTN_BLOCK': '1', 'AEQT_ATTN_QKV': '0'},
                   {'attn_block': True, 'attn_qkv': False}),
}
CONFIGS = {'mqa': MQA, 'mqa128': SERVE_CFG, 'toy': None}


def _configs(name):
  if CONFIGS[name] is None:
    return jax_gemma.TOY_DECODER, gemma.TOY_DECODER
  return (jax_gemma.DecoderConfig(**CONFIGS[name]),
          gemma.DecoderConfig(**CONFIGS[name]))


@functools.lru_cache(maxsize=None)
def _graphs(name, greedy):
  """bench.py's decode graph on both sides (int8 KV stamped) and one
  weight draw (shared_weights)."""
  jcfg, tcfg = _configs(name)
  kw = dict(batch=BATCH, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=greedy)
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  tgraph = gemma.build_decoder(tcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  return jcfg, jgraph, tgraph, shared_weights(jgraph, tgraph)


def _pair(monkeypatch, name, setting, greedy=False, drq=True,
          dtype='float32'):
  """Both executors on one graph: JAX under bench.py's variables plus the
  setting's, the port with the matching options."""
  jcfg, jgraph, tgraph, (jweights, tweights) = _graphs(name, greedy)
  env, options = SETTINGS[setting]
  for var in [v for v in os.environ if v.startswith('AEQT_')]:
    monkeypatch.delenv(var)
  for var, val in BENCH_ENV + tuple(env.items()) + (
      ('AEQT_INT4_DRQ', '1' if drq else '0'),):
    monkeypatch.setenv(var, val)
  jex = jax_executor.GraphExecutor(jgraph, activation_dtype=dtype)
  jex._weights = dict(jweights)
  jex.prepare_serving_weights(min_weight_params=0)
  tex = executor.GraphExecutor(tgraph, device='cpu', activation_dtype=dtype,
                               **dict(BENCH_OPTIONS, int4_drq=drq, **options))
  tex.load_weights(tweights)
  tex.prepare_serving_weights(min_weight_params=0)
  return jcfg, jgraph, jex, tex


def _units(ex):
  return dict(
      norm=sorted(ex._norm_fusions), qkv=sorted(ex._qkv_fusions),
      epilogue=sorted(k for k, f in ex._attn_fusions.items()
                      if 'epilogue' in f),
      attention=sorted(ex._attn_fusions), block=sorted(ex._block_fusions),
      mlp=sorted(ex._mlp_fusions), head=sorted(ex._head_fusions))


# Units of each two-layer config under each setting (the greedy head
# fused), from reading the JAX finders: MQA's QKV weight (6 heads of 64)
# pads to 512 rows, so it takes no prologue; TOY_DECODER has two KV heads,
# so it takes no epilogue; a norm-fed chain forms no MLP (so no block) and
# a norm-fed head FC no head fusion; an attention with an epilogue joins
# no block; without the epilogue (qkv_only) layer 1's attention joins a
# block with layer 0's MLP, whose unit then takes its prologue's place.
WANT_UNITS = {
    ('mqa', 'attn_block'): dict(epilogue=2, attention=2, mlp=2),
    ('mqa128', 'attn_block'): dict(qkv=2, epilogue=2, attention=2, mlp=2),
    ('toy', 'attn_block'): dict(qkv=2, attention=2),
    ('mqa128', 'norm_fusion'): dict(norm=4, attention=2),
    ('mqa128', 'both'): dict(norm=4, qkv=2, epilogue=2, attention=2),
    ('mqa128', 'qkv_only'): dict(qkv=2, attention=1, block=1, mlp=1),
    ('mqa128', 'oproj_only'): dict(epilogue=2, attention=2, mlp=2),
}


@pytest.mark.parametrize('name,setting', sorted(WANT_UNITS))
def test_units_match_jax(monkeypatch, name, setting):
  """The same norm, QKV, epilogue, attention, block, MLP and head units as
  the JAX executor, with the greedy head, and the counts read from the
  finders."""
  _, _, jex, tex = _pair(monkeypatch, name, setting, greedy=True)
  got = _units(tex)
  assert got == _units(jex)
  counts = {key: len(v) for key, v in got.items()}
  want = dict.fromkeys(counts, 0)
  want.update(WANT_UNITS[(name, setting)], head=1)
  assert counts == want


@pytest.mark.parametrize('options', [{}, executor.JAX_DEFAULT_OPTIONS])
def test_options_off_form_no_unit(options):
  """With norm_fusion and attn_block at their defaults no norm, QKV or
  epilogue unit forms, and attn_qkv / attn_oproj alone change nothing."""
  _, _, tgraph, (_, tweights) = _graphs('mqa128', True)
  for extra in ({}, {'attn_qkv': True, 'attn_oproj': True}):
    tex = executor.GraphExecutor(tgraph, device='cpu',
                                 activation_dtype='float32',
                                 **dict(options, **extra))
    tex.load_weights(tweights)
    tex.prepare_serving_weights(min_weight_params=0)
    units = _units(tex)
    assert not (units['norm'] or units['qkv'] or units['epilogue'])
    assert not (tex.norm_fusion or tex.attn_block)


def _random_caches(cfg, seed):
  rng = np.random.default_rng(seed)
  shape = (BATCH, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
  return {f'layer_{li}_{kind}_cache_in':
          rng.integers(-127, 128, shape).astype(np.int8)
          for li in range(cfg.num_layers) for kind in 'kv'}


def _inputs(cfg, pos, seed):
  """One decode step at position pos over prefix masks of pos + 1 rows
  (the serving contract the stale and epilogue routes read lengths
  from)."""
  rng = np.random.default_rng(seed)
  g = cfg.num_query_heads // cfg.num_kv_heads
  mask = np.full((BATCH, 1, g, cfg.max_seq_len), -1e9, np.float32)
  mask[..., :pos + 1] = 0.0
  return {'tokens': rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(
              np.int32),
          'positions': np.full((BATCH, 1), pos, np.int32),
          'mask': mask, 'cache_pos': np.array([0, 0, pos, 0], np.int32)}


def tgraph_of(ex):
  return ex.graph.subgraphs[ex.graph.signature_by_key('decode')
                            .subgraph_index]


def _patch_exact(monkeypatch):
  """The JAX executor's two attention-block kernels compiled with XLA's
  excess precision off (see the module docstring)."""
  monkeypatch.setattr(pallas_qkv, 'qkv_rope_pallas',
                      _exact(pallas_qkv.qkv_rope_pallas))
  monkeypatch.setattr(pallas_attention, 'decode_attention_oproj_pallas',
                      _exact(pallas_attention.decode_attention_oproj_pallas))


# (logits rtol = atol, cache codes apart) by activation dtype. f32: the
# tolerance of the other decode-step tests (test_torch_port_cache_modes);
# bf16: the residual stream is bf16, so an ulp of a norm or a flipped DRQ
# code moves a logit by a bf16 step of the hidden values, carried through
# two layers and the head: 4 bf16 unit roundoffs.
STEP_TOL = {'float32': (1e-4, 1), 'bfloat16': (4 * _BF16_EPS, 1)}


DECODE_CASES = [(name, setting, drq, dtype)
                for name, setting in (('mqa128', 'both'), ('toy', 'attn_block'))
                for drq in (True, False)
                for dtype in ('float32', 'bfloat16')] + [
                    ('mqa128', 'norm_fusion', True, 'float32'),
                    ('mqa128', 'norm_fusion', False, 'bfloat16')]


@pytest.mark.parametrize('name,setting,drq,dtype', DECODE_CASES)
def test_decode_matches_jax(monkeypatch, name, setting, drq, dtype):
  """STEPS decode steps from position 37 over random caches, both sides
  fed the JAX side's output caches: logits within STEP_TOL of max |logit|,
  the greedy ids equal where the JAX top-2 margin is beyond twice that,
  int8 cache codes within one step; the units' wrappers ran their plain
  versions once a call a step, nothing launched. 'both' covers the norm
  fusion beside the prologue (the FFN norm folds into gate/up, the
  attention norm into the prologue)."""
  _patch_exact(monkeypatch)
  cfg, jgraph, jex, tex = _pair(monkeypatch, name, setting, drq=drq,
                                dtype=dtype)
  sig = jgraph.signature_by_key('decode')
  caches = _random_caches(cfg, 1)
  counters = (RMSNORM, QKV, OPROJ)
  before = [(f.plain_calls, f.launches) for f in counters]
  rtol, codes = STEP_TOL[dtype]
  for step in range(STEPS):
    pos = 37 + step
    feed = dict(caches, **_inputs(cfg, pos, step))
    jout = jex._run_signature(sig.subgraph_index, 'decode', False,
                              jex._weights,
                              {k: jnp.asarray(v) for k, v in feed.items()})
    tout = tex({k: torch.from_numpy(np.array(v)) for k, v in feed.items()},
               'decode')
    want = _as_f32(jout['logits'])
    got = tout['logits'].float().numpy()
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f'step {step}')
    top2 = np.sort(want.reshape(BATCH, -1), axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * (atol + rtol * top2[:, 1])
    ids = (got.reshape(BATCH, -1).argmax(-1), want.reshape(BATCH, -1)
           .argmax(-1))
    assert np.array_equal(ids[0][clear], ids[1][clear]), step
    for key, val in tout.items():
      if key.endswith('_cache'):
        diff = np.abs(val.numpy().astype(np.int32)
                      - np.asarray(jout[key]).astype(np.int32))
        assert diff.max() <= codes, (key, step)
    caches = {f'{k}_in': np.asarray(jout[k]) for k in jout
              if k.endswith('_cache')}
  units = _units(tex)
  sg = tgraph_of(tex)
  norm_fcs = sum(1 for i, op in enumerate(sg.ops)
                 if op.opcode == 'FULLY_CONNECTED'
                 and (0, op.inputs[0]) in tex._norm_fusions
                 and (0, i) not in tex._qkv_skip)
  ran = [(f.plain_calls - b[0], f.launches - b[1])
         for f, b in zip(counters, before)]
  assert ran == [(STEPS * n, 0) for n in (
      norm_fcs, len(units['qkv']), len(units['epilogue']))]
