"""The stale-cache (#2) and splice-writeback (#8) decode attentions on the
split-S tensor-core core (`csrc/attention_split_tc.cuh`: `attend<kStale,
C>` and `attend<kSplice, C>`) on the CPU, where no CUDA kernel runs:
PyTorch twins of the kernels' schedules held against the plain versions
and the TPU kernels (interpret-mode Pallas compiled with XLA's excess
precision off, `_exact`).

#2 is the lengths form's schedule (test_torch_port_attn_split_lengths.py's
`lengths_twin`) over L = clip(lengths - 1, 0, S) stale rows, with the new
token's column apart: every CTA forms s_cur itself (f32 and bf16 in the
order of the plain version's one-column matmul on the card,
`new_column_order`; int8 exact), the maximum takes it after the slices'
maxima, the denominator e_cur after the slices' sums in split order (int8
in the f64 sum), and the context p_cur's operand times v_new after the
slices' partials (int8: its code, and into the code sum). A row with no
stale row weighs the new column alone: its context is v_new.

#8 is the lengths form with row p = clip(pos, 0, S - 1) read from the new
token's rows where the kernel copies it (K where p < L, V where p < L or
the row has length 0: then every V row is read) and written into both
caches for every row. A twin that reads the old row p instead misses the
bound where the old and new rows differ in every byte.

Held, as chip_smoke.py holds the card, to 1e-5 absolute in f32 (1e-5 *
max(|y|, 1) at the bench-like case; one p part fewer fails it; the
mode-by-case tests hold the twin, the plain version and the TPU kernel
each to 1e-5 * max(|y|, 1) of the function in f64, since the last two sum
in the host's matmul order), by the compute modes' rule in bf16
(test_torch_port_attn_compute._check_ctx) and bit for bit in int8, the
pools bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import attention

import test_torch_port_attn_split as split
import test_torch_port_attn_split_lengths as lengths_split
from test_torch_port_attn_compute import _check_ctx

_exact, _j = split._exact, split._j
chain_dot, lengths_twin = lengths_split.chain_dot, lengths_split.lengths_twin
CHUNK, P_PARTS = split.CHUNK, split.P_PARTS
ZP_K, ZP_V, K_SCALE, V_SCALE = (split.ZP_K, split.ZP_V, split.K_SCALE,
                                split.V_SCALE)
BOUND = lengths_split.BOUND


def new_column_order(r, h):
  """The header's new_column_order: (parts, strided, butterfly) of q . k_new
  for R = B * NK rows of head dim h."""
  if r == 1:
    return 32, False, True
  if r <= 64:
    return min(16, h // 8), False, True
  if h == 64:
    return 4, True, True
  return 16, True, False


def new_column_dot(qd, kn, r):
  """q . k_new [..., G] in new_column_order: `parts` f32 FMA chains (each
  step exact in f64, rounded once), then added as the kernel adds them."""
  h = qd.shape[-1]
  parts, strided, butterfly = new_column_order(r, h)
  n = h // parts
  idx = torch.tensor([[l + parts * i if strided else l * n + i
                       for i in range(n)] for l in range(parts)])
  a = qd[..., idx].to(torch.float64)             # [..., G, parts, n]
  kk = kn[..., 0, :][..., idx].to(torch.float64)  # [..., parts, n]
  acc = torch.zeros(a.shape[:-1], dtype=torch.float32)
  for i in range(n):
    acc = (acc.to(torch.float64) + a[..., i] * kk[..., None, :, i]).to(
        torch.float32)
  if butterfly:  # part l with l + half, then on down
    while acc.shape[-1] > 1:
      half = acc.shape[-1] // 2
      acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]
  total = acc[..., 0]
  for l in range(1, parts):
    total = total + acc[..., l]
  return total


def _bf16(t):
  return t.to(torch.bfloat16).to(torch.float32)


def stale_twin(q, k_cache, v_cache, lengths, k_new, v_new, compute='f32',
               p_parts=None, n_split=None):
  """#2's arithmetic on the split schedule: [B, NK, G, H] f32."""
  b, nk, g, h = q.shape
  s = k_cache.shape[2]
  n_split = n_split or split.splits(s)[0]
  slices = split._slices(s, n_split)
  ks = attention.score_scale(K_SCALE, h)
  v_scale = float(np.float32(V_SCALE))
  qf = q.to(torch.float32)
  qsum = torch.sum(qf, -1)
  stale_len = torch.clamp(lengths.to(torch.int64) - 1, 0, s)
  live = lengths_split._live(stale_len, b, s)
  if compute == 'int8':  # exact dots, as the plain version's
    scores = split._scores(q, k_cache, 'int8', None) * ks
    cur = attention._mode_scores(qf, k_new.to(torch.float32), ZP_K,
                                 'int8')[..., 0] * ks
  elif compute == 'bf16':
    scores = split._scores(q, k_cache, 'bf16', None) * ks
    cur = (new_column_dot(_bf16(qf), k_new, b * nk) - ZP_K * qsum) * ks
  else:
    scores = (chain_dot(qf, k_cache) - ZP_K * qsum[..., None]) * ks
    cur = (new_column_dot(qf, k_new, b * nk) - ZP_K * qsum) * ks
  cur = cur[..., None]
  sc = torch.where(live, scores, -1e30)
  m = torch.amax(torch.stack([torch.amax(sc[..., x], -1, keepdim=True)
                              for x in slices]), dim=0)
  m = torch.maximum(m, cur)  # the new column after the cluster's maxima
  e = torch.where(live, torch.exp(sc - m), 0.0)
  e_cur = torch.exp(cur - m)
  sum_t = torch.float64 if compute == 'int8' else torch.float32
  denom = (split._split_sum([torch.sum(e[..., x].to(sum_t), -1, keepdim=True)
                             for x in slices])
           + e_cur.to(sum_t)).to(torch.float32)  # e_cur last
  p, p_cur = e / denom, e_cur / denom
  vn = v_new.to(torch.float32)
  if compute == 'int8':
    codes, code_cur = torch.round(p * 127.0), torch.round(p_cur * 127.0)
    vf = v_cache.to(torch.float64)
    ctx = split._split_sum([torch.matmul(codes[..., x].to(torch.float64),
                                         vf[:, :, x]) for x in slices])
    ctx = (ctx + code_cur.to(torch.float64) * vn.to(torch.float64)).to(
        torch.float32)
    p_sum = torch.clamp_min(torch.sum(codes, -1, keepdim=True) + code_cur,
                            1.0)
    return (ctx / p_sum - ZP_V) * v_scale
  if compute == 'bf16':
    ctx = split._context(_bf16(p), v_cache, 1, n_split) + _bf16(p_cur) * vn
  else:
    ctx = (split._context(p, v_cache, p_parts or P_PARTS, n_split)
           + p_cur * vn)
  return (ctx - ZP_V) * v_scale


def splice_twin(q, k_cache, v_cache, lengths, k_new, v_new, pos,
                compute='f32', p_parts=None, n_split=None, substitute=True):
  """#8 on the split schedule: the rows each CTA copies, row p replaced
  by the new token's where the kernel replaces it (`substitute`), through
  the lengths form; the pools with row p written for every row. Returns
  (ctx, k_pool, v_pool)."""
  s = k_cache.shape[2]
  p = min(max(int(pos), 0), s - 1)
  k_seen, v_seen = k_cache.clone(), v_cache.clone()
  if substitute:
    for row, n in enumerate(lengths.tolist()):
      copied_k = min(n, s) if n > 0 else 0
      copied_v = copied_k if n > 0 else s  # a zero-length row reads all V
      if p < copied_k:
        k_seen[row, :, p] = k_new[row, :, 0]
      if p < copied_v:
        v_seen[row, :, p] = v_new[row, :, 0]
  ctx = lengths_twin(q, k_seen, v_seen, lengths, compute, p_parts=p_parts,
                     n_split=n_split)
  k_pool, v_pool = k_cache.clone(), v_cache.clone()
  k_pool[:, :, p] = k_new[:, :, 0]
  v_pool[:, :, p] = v_new[:, :, 0]
  return ctx, k_pool, v_pool


def _inputs(b, nk, g, s, h, lengths, seed):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc, vc = (rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
            for _ in range(2))
  kn, vn = (rng.integers(-127, 128, (b, nk, 1, h)).astype(np.int8)
            for _ in range(2))
  return (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
          torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(kn),
          torch.from_numpy(vn))


def _stale_plain(q, kc, vc, lens, kn, vn, compute):
  return attention.decode_attention_int8_lengths_stale_plain(
      q, kc, vc, K_SCALE, V_SCALE, lens, kn, vn, k_zero_point=ZP_K,
      v_zero_point=ZP_V, compute=compute)


def _splice_plain(q, kc, vc, lens, kn, vn, pos, compute):
  return attention.decode_attention_int8_lengths_writeback_plain(
      q, kc.clone(), vc.clone(), K_SCALE, V_SCALE, lens, kn, vn, pos,
      k_zero_point=ZP_K, v_zero_point=ZP_V, compute=compute)


def _hold(got, want, compute, rel=False):
  if compute == 'int8':
    assert torch.equal(got, want)
  elif compute == 'bf16':
    _check_ctx(got.numpy(), want.numpy(), compute, V_SCALE, ZP_V)
  else:
    err = float(torch.max(torch.abs(got - want)))
    bound = BOUND * max(float(torch.max(torch.abs(want))), 1.0) if rel \
        else BOUND
    assert err <= bound, (err, bound)


def _f64_attention(q, kc, vc, live, k_new=None, v_new=None):
  """The f32 mode's function evaluated in f64 (no host BLAS order in it):
  cache rows j < live[b] of each row, and with k_new / v_new the new
  token's column after them (#2's s_cur, e_cur and p_cur); a row with
  nothing live and no new column weighs all S rows alike, as the plain
  version's -1e30 scores do."""
  b, nk, g, h = q.shape
  s = kc.shape[2]
  ks = attention.score_scale(K_SCALE, h)
  v_scale = float(np.float32(V_SCALE))
  q64 = q.to(torch.float64)
  qsum = torch.sum(q64, dim=-1, keepdim=True)
  scores = (torch.matmul(q64, kc.to(torch.float64).transpose(-1, -2))
            - ZP_K * qsum) * ks
  rows = torch.arange(s).reshape(1, 1, 1, s)
  scores = torch.where(rows < live.reshape(b, 1, 1, 1), scores, -1e30)
  m = torch.amax(scores, dim=-1, keepdim=True)
  if k_new is not None:
    s_cur = (torch.matmul(q64, k_new.to(torch.float64).transpose(-1, -2))
             - ZP_K * qsum) * ks
    m = torch.maximum(m, s_cur)
  p = torch.exp(scores - m)
  ctx = torch.matmul(p, vc.to(torch.float64))
  denom = torch.sum(p, dim=-1, keepdim=True)
  if k_new is not None:
    p_cur = torch.exp(s_cur - m)
    ctx = ctx + p_cur * v_new.to(torch.float64)
    denom = denom + p_cur
  return (ctx / denom - ZP_V) * v_scale


def _hold_f32_exact(y64, **outputs):
  """f32: each of `outputs` (the twin, the plain version, the TPU kernel)
  within 1e-5 * max(|y|, 1) of the function evaluated in f64. The plain
  version and the TPU kernel sum in the host's matmul order: against each
  other at an absolute 1e-5 they part on some CPUs where |y| is near 8."""
  bound = BOUND * max(float(torch.max(torch.abs(y64))), 1.0)
  for name, y in outputs.items():
    err = float(torch.max(torch.abs(y.to(torch.float64) - y64)))
    assert err <= bound, (name, err, bound)


# -- #2 ---------------------------------------------------------------------------

# Lengths 0 and 1 (the new column alone), S (the new column after the last
# cache row), ragged ones and one inside a slice's second chunk; G 8, 4 and
# 16, H 64 to 256, two KV heads.
STALE_CASES = [
    ((0, 1, 384, CHUNK + 38), 1, 8, 384, 128),
    ((512, 1, 200, 2), 2, 4, 512, 64),
    ((3, 256, 0, 130), 1, 16, 256, 256)]


@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
@pytest.mark.parametrize('lengths,nk,g,s,h', STALE_CASES)
def test_stale_twin_holds_the_rules(lengths, nk, g, s, h, compute):
  b = len(lengths)
  q, kc, vc, lens, kn, vn = _inputs(b, nk, g, s, h, lengths,
                                    seed=sum(lengths) + h)
  got = stale_twin(q, kc, vc, lens, kn, vn, compute)
  assert torch.all(torch.isfinite(got))
  want = _stale_plain(q, kc, vc, lens, kn, vn, compute)
  tpu = torch.from_numpy(np.array(_exact(
      pallas_attention.decode_attention_int8_lengths_stale)(
          _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lens), _j(kn), _j(vn),
          k_zero_point=ZP_K, v_zero_point=ZP_V, compute=compute,
          batch_block=1, interpret=True)))
  if compute == 'f32':
    _hold_f32_exact(_f64_attention(q, kc, vc, lens - 1, kn, vn), twin=got,
                    plain=want, tpu=tpu)
  else:
    _hold(got, want, compute)
  if compute == 'int8':  # the codes exact against the TPU kernel's too
    _check_ctx(got.numpy(), tpu.numpy(), 'int8', V_SCALE, ZP_V)
  elif compute == 'bf16':
    _hold(got, tpu, compute)
  # A row with no stale row: its context is v_new in every mode.
  v_scale = float(np.float32(V_SCALE))
  for row in (i for i, n in enumerate(lengths) if n <= 1):
    want = (vn[row].to(torch.float32) - ZP_V) * v_scale
    assert torch.equal(got[row], want.expand_as(got[row]))


@pytest.mark.parametrize('n_split', [1, 2, 3, 4, 8])
def test_stale_twin_at_each_split(n_split):
  """Each split choose_plan may take at S 1024 holds every mode's rule;
  lengths 200 leaves the later slices past L (they copy nothing)."""
  lengths = (0, 1, 1024, 200)
  q, kc, vc, lens, kn, vn = _inputs(4, 1, 8, 1024, 128, lengths,
                                    seed=n_split)
  for compute in ('f32', 'bf16', 'int8'):
    got = stale_twin(q, kc, vc, lens, kn, vn, compute, n_split=n_split)
    _hold(got, _stale_plain(q, kc, vc, lens, kn, vn, compute), compute)


def test_stale_bench_like_and_one_p_part_fewer():
  """bench.py's shape cut down (every row 897 long: 896 stale rows) holds
  1e-5 * max(|y|, 1) with kPParts parts of p; with one part fewer the
  twin misses #2's B-64 bound on ragged rows."""
  q, kc, vc, lens, kn, vn = _inputs(4, 1, 8, 1024, 128, (897,) * 4, seed=9)
  _hold(stale_twin(q, kc, vc, lens, kn, vn),
        _stale_plain(q, kc, vc, lens, kn, vn, 'f32'), 'f32', rel=True)
  for seed in range(3):
    q, kc, vc, lens, kn, vn = _inputs(2, 1, 8, 512, 128, (512, 301),
                                      seed=seed)
    want = _stale_plain(q, kc, vc, lens, kn, vn, 'f32')
    _hold(stale_twin(q, kc, vc, lens, kn, vn), want, 'f32')
    fewer = float(torch.max(torch.abs(stale_twin(
        q, kc, vc, lens, kn, vn, p_parts=P_PARTS - 1) - want)))
    assert fewer > BOUND, (seed, fewer)


@pytest.mark.parametrize('r,h', [(1, 256), (64, 256), (65, 256), (256, 128),
                                 (64, 64), (256, 64)])
def test_new_column_order_is_a_sum_of_every_product(r, h):
  """Each order of the new column adds every product q[h] k_new[h] once:
  on inputs whose sums are exact in f32 it equals the exact dot."""
  rng = np.random.default_rng(r + h)
  q = torch.from_numpy(rng.integers(-8, 9, (2, 1, 8, h)).astype(np.float32))
  kn = torch.from_numpy(rng.integers(-127, 128, (2, 1, 1, h)).astype(
      np.float32))
  exact = torch.matmul(q.to(torch.float64), kn.to(torch.float64).transpose(
      -1, -2))[..., 0]
  assert torch.equal(new_column_dot(q, kn, r).to(torch.float64), exact)


# -- #8 ---------------------------------------------------------------------------

# pos 0 and S - 1 (the first and last chunk of the first and last CTA),
# 127 / 128 (a chunk edge); a row whose length does not reach p and a
# zero-length one (every V row read, the spliced one among them).
SPLICE_CASES = [
    (0, (1, 0, 384, 200), 1, 8, 384, 128),
    (127, (128, 127, 0, 300), 2, 4, 256, 64),
    (128, (129, 100, 0), 1, 16, 256, 256),
    (383, (384, 0, 383, 1), 1, 8, 384, 128)]


@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
@pytest.mark.parametrize('pos,lengths,nk,g,s,h', SPLICE_CASES)
def test_splice_twin_holds_the_rules(pos, lengths, nk, g, s, h, compute):
  b = len(lengths)
  q, kc, vc, lens, kn, vn = _inputs(b, nk, g, s, h, lengths,
                                    seed=pos + sum(lengths) + h)
  got, k_pool, v_pool = splice_twin(q, kc, vc, lens, kn, vn, pos, compute)
  assert torch.all(torch.isfinite(got))
  want, wk, wv = _splice_plain(q, kc, vc, lens, kn, vn, pos, compute)
  assert torch.equal(k_pool, wk) and torch.equal(v_pool, wv)
  if compute != 'f32':
    _hold(got, want, compute)
  ctx, tk, tv = _exact(
      pallas_attention.decode_attention_int8_lengths_writeback)(
          _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lens), _j(kn), _j(vn),
          jnp.int32(pos), k_zero_point=ZP_K, v_zero_point=ZP_V,
          compute=compute, batch_block=1, interpret=True)
  np.testing.assert_array_equal(k_pool.numpy(), np.asarray(tk))
  np.testing.assert_array_equal(v_pool.numpy(), np.asarray(tv))
  tpu = torch.from_numpy(np.array(ctx))
  if compute == 'int8':
    _check_ctx(got.numpy(), tpu.numpy(), 'int8', V_SCALE, ZP_V)
  elif compute == 'bf16':
    _hold(got, tpu, compute)
  else:
    _hold_f32_exact(_f64_attention(q, wk, wv, lens), twin=got, plain=want,
                    tpu=tpu)


@pytest.mark.parametrize('n_split', [1, 2, 3, 4, 8])
def test_splice_twin_at_each_split(n_split):
  """Each split at S 1024 with p inside a later slice: every mode's rule,
  the pools bit for bit."""
  pos, lengths = 700, (701, 0, 1024, 300)
  q, kc, vc, lens, kn, vn = _inputs(4, 1, 8, 1024, 128, lengths,
                                    seed=n_split + 20)
  for compute in ('f32', 'bf16', 'int8'):
    got, k_pool, v_pool = splice_twin(q, kc, vc, lens, kn, vn, pos, compute,
                                      n_split=n_split)
    want, wk, wv = _splice_plain(q, kc, vc, lens, kn, vn, pos, compute)
    assert torch.equal(k_pool, wk) and torch.equal(v_pool, wv)
    _hold(got, want, compute)


def test_splice_reads_no_old_row():
  """The old row p differs from the new one in every byte: the twin holds
  the bound in f32 and int8, a twin that reads the old row p misses it (in
  int8 through the zero-length row: at S 128 each of its codes is 1)."""
  pos = 64
  q, kc, vc, lens, kn, vn = _inputs(2, 1, 8, 128, 128, (100, 0), seed=3)
  kc[:, :, pos] = kn[:, :, 0] ^ 0x55
  vc[:, :, pos] = vn[:, :, 0] ^ 0x55
  assert torch.all(kc[:, :, pos] != kn[:, :, 0])
  assert torch.all(vc[:, :, pos] != vn[:, :, 0])
  for compute in ('f32', 'int8'):
    want = _splice_plain(q, kc, vc, lens, kn, vn, pos, compute)[0]
    _hold(splice_twin(q, kc, vc, lens, kn, vn, pos, compute)[0], want,
          compute)
    old = splice_twin(q, kc, vc, lens, kn, vn, pos, compute,
                      substitute=False)[0]
    assert float(torch.max(torch.abs(old - want))) > BOUND


def test_stale_and_splice_run_on_the_split_core():
  """#2 and #8 are forms of attention_split_tc.cuh's `attend` with their
  own plan exports; their one-block kernels stay only for the shapes the
  core does not take, by a fixed rule; no library call."""
  csrc, src = split.CSRC, split.SOURCE
  for name, form, plan in (
      ('attention_stale.cu', 'kStale', 'aeqt_attention_stale_plan'),
      ('attention_writeback.cu', 'kSplice', 'aeqt_attention_writeback_plan')):
    # The entry points, then the kernels where a header holds them.
    text = ''.join((csrc / n).read_text() for n in (name, name + 'h')
                   if (csrc / n).exists())
    assert f'attend<aeqt::split::{form}, C, H, NTS>(a)' in text
    assert f'extern "C" int {plan}' in text
    assert 'if (kernel == nullptr) {' in text  # the fixed rule
    assert f'aeqt::split::takes(aeqt::split::{form}, compute' in text
    for call in ('cublas', 'cudnn', 'scaled_dot_product'):
      assert call not in text.lower(), (name, call)
  # The twin's orders are the header's.
  for line in ('if (R == 1) return {32, false, true};',
               'if (R <= 64) return {H / 8 < 16 ? H / 8 : 16, false, true};',
               'if (H == 64) return {4, true, true};',
               'return {16, true, false};'):
    assert line in src, line
  for part in ('new_column_scores<C, H>(a, qbuf, qsum, qscale, knew, cur)',
               'tot = tot + (SumT<C>)e_cur;  // the new column last',
               'splice(kst, c, kr, a.k_new', 'splice(vst, c, vr, a.v_new',
               'tc::fence_proxy_async();'):
    assert part in src, part
