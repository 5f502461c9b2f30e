"""The norm-fused weight-only FC (#14, `csrc/qmatmul_int4_rmsnorm.cu`) and
the attention out-projection epilogue (#19, `csrc/attention_oproj.cu`) as
chains of the cores' launches, on the CPU where no CUDA kernel runs: twins
composed from the stage twins of the cores, held to the plain versions and
to the TPU kernels (interpret-mode Pallas compiled with XLA's excess
precision off, `_exact`).

  * #14 with bf16 x: the block-a-row norm (`norm_rows.cuh`: each of 256
    threads sums its strided columns' squares in f64, a warp's sums meet
    by a butterfly, the 8 warps' sums in warp order; r = 1 / sqrt(f32(ss /
    K) + eps), xn = bf16(bf16(x r) bf16(gamma))), then #12's ChannelScale
    contraction (`int4_bf16_tc_gemm.cuh`; the split plan's lo and hi f32
    sums, test_torch_port_int4_bf16_tc's twin). The norm twin equals the
    plain norm bit for bit at r in IEEE f32; the chain holds
    int_weights_tolerance and one bf16 rounding against the plain version
    and the TPU kernel.
  * #19: #7's split schedule (test_torch_port_attn_split_lengths's twin) in
    each compute mode, ctx rounded to T, then #1's DRQ projection
    (`int8_tc_gemm.cuh` SplitNibblesRecipB: the reciprocal row quantize,
    exact int32 sums, (acc xs) so) or the weight-only one (ChannelScale at
    bf16, an f32 chain at f32), and the residual in the epilogue,
    y = T(T(o) + x_res). Given its context the DRQ chain is the plain
    version's bit for bit; end to end it is held by chip_smoke.oproj_case's
    rules, and against the TPU kernel by test_torch_port_attn_block's.
  * A case where rounding o to T before the add matters: the twin that
    adds in f32 fails the bit-for-bit check.
  * The sources: the cores each entry point reaches, and the plans' fields.

The card runs the kernels against their plain versions in `chip_smoke.py`
(`rmsnorm_kernel`, `oproj_kernel`, `oproj_mode_rows`).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq

import test_torch_port_attn_split_lengths as lengths_split
import test_torch_port_int4_bf16_tc as bf16_core
from test_torch_port_attn_block import ROWS_OFF, _bf16_ulp, _exact, _j

CSRC = pathlib.Path(_build.CSRC)
NORM_THREADS = 256  # norm_rows.cuh kNormThreads: one block a row
EPS = 1e-6
K_SCALE, V_SCALE, ZP_K, ZP_V = (lengths_split.K_SCALE, lengths_split.V_SCALE,
                                lengths_split.ZP_K, lengths_split.ZP_V)
_INV127 = np.float32(1.0 / 127.0)


def _t(a):
  return torch.from_numpy(np.array(a))


def _round(a, dtype):
  """f32 array a rounded to dtype (torch.bfloat16 or torch.float32)."""
  return _t(np.asarray(a, np.float32)).to(dtype).float().numpy()


# -- #14 --------------------------------------------------------------------------


def norm_twin(x, gamma, eps=EPS):
  """norm_rows.cuh (kGammaInT) on x [M, K] bf16 or f32: xn in x's dtype."""
  m, k = x.shape
  sq = x.float().numpy().astype(np.float64) ** 2  # exact in f64
  cols = np.pad(sq, ((0, 0), (0, (-k) % NORM_THREADS))).reshape(
      m, -1, NORM_THREADS)
  part = np.zeros((m, NORM_THREADS))
  for step in range(cols.shape[1]):  # a thread's strided columns, in order
    part = part + cols[:, step]
  lanes = part.reshape(m, NORM_THREADS // 32, 32)
  for o in (16, 8, 4, 2, 1):  # warp_sum_double's butterfly
    lanes = lanes + lanes[:, :, np.arange(32) ^ o]
  ss = lanes[:, 0, 0]
  for w in range(1, NORM_THREADS // 32):  # the warps' sums in warp order
    ss = ss + lanes[:, w, 0]
  var = (ss / k).astype(np.float32)
  r = (np.float32(1.0) / np.sqrt(var + np.float32(eps)))[:, None]
  xf = x.float().numpy()
  g = _round(gamma.numpy(), x.dtype)[None, :]
  return _t(_round(xf * r, x.dtype) * g).to(x.dtype)


def rmsnorm_chain_twin(x, gamma, w, s, b=None):
  """#14 at bf16 x: the norm launch, then the ChannelScale contraction."""
  return bf16_core._twin_channel(norm_twin(x, gamma), w, s, b).to(
      torch.bfloat16)


def _norm_inputs(m, k, n, seed, dtype=torch.bfloat16):
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal((m, k)) * (rng.random((m, 1)) * 4 + 0.1)).astype(
      np.float32)
  g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
  w = pq.pack_int4_split(_t(rng.integers(-8, 8, (n, k)).astype(np.int8)))
  s = _t((rng.random(n) * 0.01 + 0.005).astype(np.float32))
  b = _t(rng.standard_normal(n).astype(np.float32))
  return _t(x).to(dtype), _t(g), w, s, b


def _rms_inverse_ieee(xf, eps):
  """ops_impl.rms_inverse's function with its square root and reciprocal
  each rounded once from f64 in numpy (IEEE f32, as sqrtf and the division
  are on the card)."""
  x = xf.double().numpy()
  var = (np.sum(np.square(x), axis=-1, keepdims=True)
         / x.shape[-1]).astype(np.float32)
  v = (var + np.float32(eps)).astype(np.float64)
  root = np.sqrt(v).astype(np.float32).astype(np.float64)
  return torch.from_numpy((1.0 / root).astype(np.float32))


def test_rms_inverse_is_ieee():
  """rms_inverse's 1 / sqrt equals the correctly rounded f32 route (the
  square root in f64, rounded once, then the f32 reciprocal) over 100000
  seeded rows, from tiny to large mean squares: the CPU's vectorized f32
  torch.sqrt misrounds about a fifth of them on an AVX-512 host."""
  rng = np.random.default_rng(20)
  v = rng.uniform(1e-6, 4.0, 100000).astype(np.float32)
  v = v * np.float32(10.0) ** rng.integers(-3, 4, v.shape).astype(np.float32)
  xf = torch.from_numpy(np.sqrt(v.astype(np.float64)).astype(
      np.float32)).reshape(-1, 1)
  got = pq.ops_impl.rms_inverse(xf, EPS)
  want = _rms_inverse_ieee(xf, EPS)
  assert got.dtype == torch.float32 and got.shape == (100000, 1)
  assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,k', [(5, 512), (64, 2048), (3, 384)])
def test_norm_twin_equals_the_plain_norm(m, k, dtype):
  """The block-a-row f64 sum rounds to the plain version's f32 var: xn bit
  for bit, with the plain version's r equal to the IEEE f32 r (the
  card's), at a K that is not a multiple of the block too."""
  x, g, *_ = _norm_inputs(m, k, 64, m + k, dtype)
  got = norm_twin(x, g)
  r_host = pq.ops_impl.rms_inverse(x.float(), EPS)
  assert torch.equal(r_host, _rms_inverse_ieee(x.float(), EPS))
  want = pq.rmsnorm_gamma_plain(x, g)
  assert got.dtype == want.dtype == dtype
  assert torch.equal(got, want)


def _hold_norm_fc(got, want, k):
  """int_weights_tolerance of max |y| and one bf16 rounding of y."""
  want = want.float().numpy()
  got = got.float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, 0, float(np.abs(want).max()))
  assert np.all(np.abs(got - want) <= tol + _bf16_ulp(want)), (
      np.abs(got - want).max(), tol)


# (M, K, N): a decode tile with its K split, ragged M past a warpgroup's
# tokens, a prefill-like two-warpgroup tile.
NORM_SHAPES = [(64, 2048, 320), (37, 512, 192), (130, 1024, 256)]


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('m,k,n', NORM_SHAPES)
def test_rmsnorm_chain_twin_holds_the_plain_version(m, k, n, bias):
  x, g, w, s, b = _norm_inputs(m, k, n, 7 * m + n)
  bb = b if bias else None
  got = rmsnorm_chain_twin(x, g, w, s, bb)
  _hold_norm_fc(got, pq.qmatmul_int4_packed_rmsnorm_plain(x, g, w, s, bb), k)


@pytest.mark.parametrize('bias', [False, True])
def test_rmsnorm_chain_twin_holds_the_tpu_kernel(bias):
  """M 5, K 512, N 256 against interpret-mode Pallas, as
  test_torch_port_attn_block holds the plain version; gamma matters."""
  x, g, w, s, b = _norm_inputs(5, 512, 256, 11)
  bb = b if bias else None
  jx = jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
  want = _t(np.asarray(_exact(
      pallas_qmatmul.qmatmul_pallas_int4_packed_rmsnorm)(
          jx, _j(g), _j(w), _j(s), None if bb is None else _j(bb),
          interpret=True)).astype(np.float32))
  _hold_norm_fc(rmsnorm_chain_twin(x, g, w, s, bb), want, 512)
  with pytest.raises(AssertionError):
    _hold_norm_fc(rmsnorm_chain_twin(x, torch.ones(512), w, s, bb), want,
                  512)


# -- #19 --------------------------------------------------------------------------


def proj_twin(ctx, wo, so, x_res, drq, round_o=True):
  """The projection launches of #19 on ctx [B, K] in T (x_res's dtype) with
  the residual in the epilogue: y = T(T(o) + x_res), or with round_o off
  y = T(o + x_res) (the f32 add the epilogue must not do)."""
  dt = x_res.dtype
  c = ctx.float().numpy()
  k = c.shape[1]
  w = pq.unpack_int4_split(wo).numpy().astype(np.int64)
  if drq:  # #1: the reciprocal row quantize, exact int32 sums
    xs = np.maximum(np.abs(c).max(axis=1, keepdims=True),
                    np.float32(1e-9)) * _INV127
    codes = np.rint(c * (np.float32(1.0) / xs)).astype(np.int64)
    acc = (codes[:, :k // 2] @ w[:, :k // 2].T
           + codes[:, k // 2:] @ w[:, k // 2:].T).astype(np.float32)
    o = (acc * xs) * so.numpy()[None, :]
  elif dt == torch.bfloat16:  # #12's ChannelScale
    o = bf16_core._twin_channel(ctx, wo, so, None).numpy()
  else:  # the SIMT kernel: an f32 chain a half, the halves added
    wf = w.astype(np.float32)
    lo = lengths_split.chain_dot(_t(c[:, None, :k // 2]),
                                 _t(wf[:, :k // 2]))[:, 0].numpy()
    hi = lengths_split.chain_dot(_t(c[:, None, k // 2:]),
                                 _t(wf[:, k // 2:]))[:, 0].numpy()
    o = (lo + hi) * so.numpy()[None, :]
  if round_o:
    o = _round(o, dt)
  return _t(_round(o + x_res.float().numpy(), dt)).to(dt)


def oproj_chain_twin(q, kc, vc, lens, x_res, wo, so, compute, drq,
                     round_o=True):
  """#19's launches: #7's split schedule in `compute` (q rounded to T),
  ctx stored in T, then proj_twin. Returns (y, ctx)."""
  b, _, g, h = q.shape
  dt = x_res.dtype
  qf = q.to(dt).float()
  ctx = lengths_split.lengths_twin(qf, kc, vc, lens, compute).reshape(
      b, g * h).to(dt)
  return proj_twin(ctx, wo, so, x_res, drq, round_o), ctx


def _oproj_inputs(seed, b=8, g=4, h=128, s=256, d=256):
  rng = np.random.default_rng(seed)
  q = _t(rng.standard_normal((b, 1, g, h)).astype(np.float32))
  kc, vc = (_t(rng.integers(-127, 128, (b, 1, s, h)).astype(np.int8))
            for _ in range(2))
  lens = rng.integers(1, s, b).astype(np.int32)
  lens[0], lens[1] = 0, s
  x = _t(rng.standard_normal((b, d)).astype(np.float32))
  wo = pq.pack_int4_split(_t(rng.integers(-8, 8, (d, g * h)).astype(
      np.int8)))
  so = _t((rng.random(d) * 0.01 + 0.005).astype(np.float32))
  return q, kc, vc, _t(lens), x, wo, so


def _oproj_plain(q, kc, vc, lens, x, wo, so, compute, drq):
  return attention.decode_attention_oproj_plain(
      q, kc, vc, K_SCALE, V_SCALE, lens, x, wo, so, ZP_K, ZP_V, compute, drq)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('drq', [True, False])
@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
def test_oproj_chain_twin_holds_the_plain_version(compute, drq, dtype):
  """Given its ctx, the DRQ chain is the plain projection and residual bit
  for bit, the weight-only one within int_weights_tolerance (plus, at bf16,
  one ulp of o, rounded before the add, and one of y). End to end within
  1e-2 of max |y| (the ctx sums in another f32 order, so a DRQ code can
  flip), and in int8 with DRQ bit for bit (#7's int8 ctx is exact)."""
  q, kc, vc, lens, x, wo, so = _oproj_inputs(3 + drq + len(compute))
  x = x.to(dtype)
  got, ctx = oproj_chain_twin(q, kc, vc, lens, x, wo, so, compute, drq)
  assert got.dtype == dtype and torch.all(torch.isfinite(got.float()))
  proj = pq.qmatmul_int4_packed_drq_plain if drq else pq.qmatmul_int4_packed_plain
  o = proj(ctx, wo, so)
  given = x + o
  if drq:
    assert torch.equal(got, given)
  else:
    want = given.float().numpy()
    tol = int_qmatmul.int_weights_tolerance(ctx.shape[1], 0,
                                            float(np.abs(want).max()))
    if dtype == torch.bfloat16:
      tol = tol + _bf16_ulp(o.float().numpy()) + _bf16_ulp(want)
    assert np.all(np.abs(got.float().numpy() - want) <= tol)
  want = _oproj_plain(q, kc, vc, lens, x, wo, so, compute, drq)
  err = float(torch.max(torch.abs(got.float() - want.float())))
  assert err <= 1e-2 * float(torch.max(torch.abs(want.float())))
  if compute == 'int8' and drq:
    assert torch.equal(got, want)


def test_rounding_o_before_the_add_matters():
  """At bf16 the epilogue rounds o before it adds x_res, as the plain
  version does: the twin that adds o in f32 misses the bit-for-bit check
  given the ctx (the residual is scaled so that the two roundings meet)."""
  q, kc, vc, lens, x, wo, so = _oproj_inputs(21)
  x = (x * 4).to(torch.bfloat16)
  got, ctx = oproj_chain_twin(q, kc, vc, lens, x, wo, so, 'f32', True)
  given = x + pq.qmatmul_int4_packed_drq_plain(ctx, wo, so)
  assert torch.equal(got, given)
  in_f32 = proj_twin(ctx, wo, so, x, True, round_o=False)
  assert int(torch.sum(in_f32.view(torch.int16) != given.view(torch.int16)))


def _jax_ctx(q, kc, vc, lens, dt):
  """The TPU kernel's context with this file's scales: its body
  `_ctx_prefix_len` (f32) row by row, q rounded to the activation dtype,
  the result cast to it."""
  scales = jnp.asarray([[K_SCALE, V_SCALE, ZP_K, ZP_V]], jnp.float32)

  def rows(q, kc, vc, lens):
    qf = q.astype(dt).astype(jnp.float32)
    return jnp.stack([pallas_attention._ctx_prefix_len(
        'f32', qf[b, 0], kc[b, 0], vc[b, 0], lens[b], scales).astype(dt)
                      for b in range(q.shape[0])])

  return _exact(rows)(_j(q), _j(kc), _j(vc), _j(lens))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('drq', [True, False])
def test_oproj_chain_twin_holds_the_tpu_kernel(drq, dtype):
  """End to end against interpret-mode Pallas by
  test_torch_port_attn_block's rule (rows within 1e-5 of max |y|, plus the
  weight-only tolerance and one bf16 ulp; at most ROWS_OFF DRQ rows off, by
  two code steps of their context); given the Pallas kernel's context, the
  DRQ projection twin equals it bit for bit at bf16 and within one f32
  rounding at f32 (XLA on the CPU fuses the residual add into an FMA)."""
  q, kc, vc, lens, x, wo, so = _oproj_inputs(5 + drq, s=128)
  dt = getattr(jnp, dtype)
  tdt = getattr(torch, dtype)
  jx = jnp.asarray(x.numpy(), dtype)
  want = np.asarray(_exact(pallas_attention.decode_attention_oproj_pallas)(
      _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lens), jx, _j(wo), _j(so),
      k_zero_point=ZP_K, v_zero_point=ZP_V, drq=drq,
      interpret=True)).astype(np.float32)
  tx = _t(np.asarray(jx.astype(jnp.float32))).to(tdt)
  got, _ = oproj_chain_twin(q, kc, vc, lens, tx, wo, so, 'f32', drq)
  got = got.float().numpy()
  ymax = float(np.abs(want).max())
  k = q.shape[2] * q.shape[3]
  tol = 1e-5 * ymax + (0.0 if drq else int_qmatmul.int_weights_tolerance(
      k, 0, ymax))
  if tdt == torch.bfloat16:
    tol = tol + _bf16_ulp(want)
  err = np.abs(got - want)
  jctx = np.asarray(_jax_ctx(q, kc, vc, lens, dt)).astype(np.float32)
  jctx = jctx.reshape(len(x), k)
  xs = np.maximum(np.abs(jctx).max(axis=1), 1e-9) / 127.0
  rows_off = np.nonzero(np.any(err > tol, axis=1))[0]
  assert len(rows_off) <= (ROWS_OFF if drq else 0), rows_off
  for r in rows_off:
    assert err[r].max() <= 2 * 8 * xs[r] * float(so.max()) + np.max(tol), r
  if drq:
    y = proj_twin(_t(jctx).to(tdt), wo, so, tx, True).float().numpy()
    if tdt == torch.bfloat16:
      np.testing.assert_array_equal(y, want)
    else:
      bound = 2.0**-22 * (np.abs(x.numpy()) + np.abs(y - x.numpy())
                          + np.abs(want))
      assert np.all(np.abs(y - want) <= bound)


# -- the sources ------------------------------------------------------------------


def _code(name):
  """A source with its // comments taken out."""
  return re.sub(r'//[^\n]*', '', (CSRC / name).read_text())


def test_rmsnorm_runs_on_the_bf16_core():
  """bf16 x: the block-a-row norm, then #12's wgmma core as a programmatic
  dependent launch on it; f32 x: #12's SIMT kernel. No mma.sync tile and no
  one-warp norm remain."""
  code = _code('qmatmul_int4_rmsnorm.cu')
  assert '#include "int4_bf16_tc_gemm.cuh"' in code
  assert 'aeqt::w4::run<aeqt::w4::ChannelScaleAfterNorm>(' in code
  assert 'aeqt::qmatmul_int4_wo_kernel<float, float>' in code
  assert 'launch_rmsnorm_rows<T, true>' in code
  for gone in ('qmatmul_int4_weight_only.cuh', 'launch_wo', 'mma_bf16',
               'wo_mma'):
    assert gone not in code, gone
  assert not (CSRC / 'qmatmul_int4_weight_only.cuh').exists()
  norm = _code('norm_rows.cuh')
  assert '<<<M, kNormThreads, 0, stream>>>' in norm  # one block a row
  assert 'griddepcontrol.launch_dependents' in norm
  assert re.search(r'constexpr int kNormThreads = (\d+);', norm).group(
      1) == str(NORM_THREADS)
  core = _code('int4_bf16_tc_gemm.cuh')
  after_norm = re.search(r'struct ChannelScaleAfterNorm : ChannelScale \{'
                         r'(.*?)\n\};', core, re.S).group(1)
  assert 'kDependent = true' in after_norm
  assert 'if constexpr (P::kDependent) {' in core
  assert 'if (P::kDependent) {' in core  # the launch attribute


def test_oproj_runs_on_the_split_and_int8_cores():
  """#7's launch (the split core, the one-block body only where it refuses
  the shape), then #1's quantize and int8 wgmma launches (DRQ) or #12's
  core (bf16 weight-only), the residual in the projection's epilogue; no
  SIMT DRQ tile, no mma.sync tile and no residual kernel remain."""
  code = _code('attention_oproj.cu')
  for header in ('attention_split_tc.cuh', 'int8_tc_gemm.cuh',
                 'int4_bf16_tc_gemm.cuh', 'attention_lengths.cuh'):
    assert f'#include "{header}"' in code, header
  assert 'aeqt::lengths::launch<C>(' in code
  assert 'launch_quantize<SplitNibblesRecipB, T, true>(' in code
  assert 'launch_gemm<SplitNibblesRecipB, T, true>(' in code
  assert 'aeqt::w4::run<ChannelScaleResidual>(' in code
  for gone in ('qmatmul_int4_drq.cuh', 'qmatmul_int4_weight_only.cuh',
               'residual_add', 'launch_qmatmul', 'launch_wo',
               'launch_lengths_attention'):
    assert gone not in code, gone
  for header in ('qmatmul_int4_drq.cuh', 'qmatmul_int4_weight_only.cuh'):
    assert not (CSRC / header).exists(), header
  int8_core = _code('int8_tc_gemm.cuh')
  assert 'y[e] = round_to(out, y[e]) + load_f(res, at + e);' in int8_core
  w4_core = _code('int4_bf16_tc_gemm.cuh')
  assert 'v[e] = __bfloat162float(__float2bfloat16_rn(v[e])) + r[e];' in (
      w4_core)
  residual = re.search(r'struct ChannelScaleResidual : ChannelScale \{'
                       r'(.*?)\n\};', w4_core, re.S).group(1)
  assert 'kResidual = true' in residual and 'kDependent = true' in residual


def _plan_writes(code, fn):
  body = code[code.index(f'extern "C" int {fn}('):]
  body = body[:body.index('\n}\n')]
  return body


def test_plan_fields_match_the_wrappers():
  """Each plan export writes as many fields as its wrapper names: #14 the
  norm's two and the core's (or the SIMT kernel's) seven, #19 the lengths
  plan's five and the projection's seven (#1's six and a zero)."""
  rms = _plan_writes(_code('qmatmul_int4_rmsnorm.cu'),
                     'aeqt_qmatmul_int4_rmsnorm_plan')
  assert {int(i) for i in re.findall(r'fields\[(\d+)\] =', rms)} == {0, 1}
  assert 'long long* f = fields + 2;' in rms
  assert {int(i) for i in re.findall(r'\bf\[(\d+)\] =', rms)} == set(
      range(7))
  assert len(pq.RMSNORM_PLAN_FIELDS) == 2 + 7
  assert pq.RMSNORM_PLAN_FIELDS[2:] == pq.INT4_BF16_PLAN_FIELDS
  oproj = _plan_writes(_code('attention_oproj.cu'),
                       'aeqt_attention_oproj_plan')
  assert 'long long* f = fields + 5;' in oproj
  assert {int(i) for i in re.findall(r'\bf\[(\d+)\] =', oproj)} == set(
      range(7))
  assert len(attention.OPROJ_PLAN_FIELDS) == 5 + 7
  lengths = _code('attention_lengths.cuh')
  one_block = lengths[lengths.index('int plan_fields(int R'):]
  assert {int(i) for i in re.findall(r'fields\[(\d+)\] =', one_block)} == set(
      range(5))
