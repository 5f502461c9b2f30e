"""The fused decode block (#5, `kernels/block.py`) and the DRQ greedy head
(#4, `kernels/head.py`) on the tensor-core cores, on the CPU, where no CUDA
kernel runs: twins of what their kernels do that the plain versions do not
show.

  * #5 (`csrc/fused_block.cu`): the chain of launches composed from twins
    of its stages (the norm's DRQ, #3's gate/up pair tile, hidden DRQ and
    down chain in group order with the residual in its epilogue, the QKV's
    pair tile with RoPE and the new row's codes in its epilogue, #2's
    split-core attention, then the pools' row write) equals
    `fused_mlp_qkv_attention_plain`: codes, pools and the f32 x_ffn bit
    for bit, ctx within #2's rule (f32: 1e-5 * max(|ctx|, 1)), at B 1,
    7, 64 and 65 with pos below and at lengths - 1, in every compute
    mode; the pair tile's RoPE is the plain version's bit for
    bit; a chain that writes the pools' row before the attention reads it
    gives another ctx where pos < lengths - 1 (the order is tested).
  * #4 (`csrc/head_argmax.cu`): the int8 core's tiles with the argmax
    epilogue (one (max, first index) pair a row and 128-column tile, then
    the reduction of the pairs) equal `torch.argmax` of `head_logits_plain`
    for int8 and packed weights, f32 and bf16 x, true_n < N, ties inside a
    tile and across tiles, M 1, 7, 64 and 256.
  * The plans at the bench shapes, with the constants read from the
    sources; the sources (no cooperative launch and no SIMT stage in #5;
    #4's DRQ route on `int8_tc_gemm.cuh`).
  * One twin each against interpret-mode Pallas (`pallas_block.
    fused_mlp_qkv_attention`, `pallas_head.head_argmax_pallas`) compiled
    with XLA's excess precision off (`_exact`).

The JAX parity of the wrappers stays in `test_torch_port_block.py` and
`test_torch_port_kernels.py`; the card runs the kernels against their
plain versions in `chip_smoke.py`.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_block, pallas_head
from ai_edge_quantizer_tpu.kernels import pallas_mlp, pallas_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import _build, block, head, mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq

import test_torch_port_attn_split as split
import test_torch_port_attn_split_stale as stale
import test_torch_port_mlp_tc as mlp_tc

CSRC = pathlib.Path(_build.CSRC)
BLOCK_SRC = (CSRC / 'fused_block.cu').read_text()
MLP_HDR = (CSRC / 'mlp_int4_drq.cuh').read_text()
HEAD_SRC = (CSRC / 'head_argmax.cu').read_text()
BK, BN, WG_ROWS, MAX_STAGES = mlp_tc.BK, mlp_tc.BN, mlp_tc.WG_ROWS, \
    mlp_tc.MAX_STAGES
INT8_BUDGET = mlp_tc.INT8_BUDGET
GATE_COLS = mlp_tc.GATE_COLS
H100_SMS, SMEM_OPTIN = mlp_tc.H100_SMS, mlp_tc.SMEM_OPTIN
_box, _unpack_tile, _const = mlp_tc._box, mlp_tc._unpack_tile, mlp_tc._const
_exact = split._exact
K_SCALE, V_SCALE, ZP_K, ZP_V = (split.K_SCALE, split.V_SCALE, split.ZP_K,
                                split.ZP_V)
KQ, VQ = 0.061, 0.059  # the new row's scales
F32 = torch.float32


def _strip_comments(src):
  return re.sub(r'//[^\n]*', '', src)


# ----------------------------------------------------------------- #5 twins


def _block_inputs(b, d, f, nq, h, s, bf, pos, lengths, seed,
                  dtype=torch.float32):
  g = np.random.default_rng(seed)
  t = torch.from_numpy
  n = (nq + 2) * h
  x = t(g.standard_normal((b, d)).astype(np.float32) * 0.5).to(dtype)
  half = h // 2
  freqs = 10000.0 ** (-np.arange(0, half, dtype=np.float32) / half)
  ang = np.float32(pos) * freqs
  cos = np.broadcast_to(np.cos(ang), (b, half)).astype(np.float32)
  sin = np.broadcast_to(np.sin(ang), (b, half)).astype(np.float32)
  return [x, t((g.random(d) * 0.2 + 0.9).astype(np.float32)),
          pq.pack_int4_split(t(g.integers(-7, 8, (2 * f, d)).astype(
              np.int8))),
          t((g.random(2 * f) * 0.01 + 0.005).astype(np.float32)),
          mlp.pack_int4_split_grouped(t(g.integers(-7, 8, (d, f)).astype(
              np.int8)), bf),
          t((g.random(d) * 0.01 + 0.005).astype(np.float32)),
          t((g.random(d) * 0.2 + 0.9).astype(np.float32)),
          pq.pack_int4_split(t(g.integers(-7, 8, (n, d)).astype(np.int8))),
          t((g.random(n) * 0.01 + 0.005).astype(np.float32)),
          t(np.ascontiguousarray(cos)), t(np.ascontiguousarray(sin)),
          t(g.integers(-127, 128, (b, s, h)).astype(np.int8)),
          t(g.integers(-127, 128, (b, s, h)).astype(np.int8)),
          t(np.asarray(lengths, np.int32)), pos, K_SCALE, V_SCALE, KQ, VQ,
          nq]


def _norm_quant(x, gamma, eps):
  """Launches 1 and 5 (norm_quant_kernel): the sum of squares in
  f64, r = 1 / sqrt(var + eps) in f32 (sqrtf and the division IEEE, as on
  the card: the root taken in f64 and rounded once, which the CPU's
  vectorized f32 torch.sqrt is not on every host), xn = (x * r) * gamma,
  then the reciprocal DRQ."""
  x = x.to(F32)
  var = (torch.sum(x.to(torch.float64) ** 2, -1, keepdim=True)
         / x.shape[1]).to(F32)
  r = 1.0 / torch.sqrt((var + np.float32(eps)).double()).to(F32)
  xn = (x * r) * gamma
  return pq.quantize_rows_drq(xn), xn


def _down_chain(b, d, f, bf):
  """The down's chain of the plan before the occupancy query (which may
  shorten it, and the order holds at every length)."""
  wgs = 1 if b <= mlp_tc.DOWN_ONE_WG_ROWS else 2
  return max(1, min(H100_SMS // (-(-b // (WG_ROWS * wgs)) * -(-d // BN)),
                    mlp_tc.MAX_CHAIN, f // bf))


def _qkv_pair(xq, xs, wqkv_p, s_qkv, cos, sin, nq, h, kq_inv, vq_inv):
  """Launch 6: pair tile y holds rows e0.. and e0 + H/2.. of its head (two
  boxes of GATE_COLS rows), stages of BK packed bytes with the codes at kb
  and D/2 + kb; the epilogue's RoPE (query heads, K) and codes (K, V)."""
  m = xq.shape[0]
  n, d2 = wqkv_p.shape
  half = h // 2
  per_head = half // GATE_COLS
  xq = xq.to(torch.int64)
  q = torch.empty((m, nq, h), dtype=F32)
  k_new = torch.empty((m, h), dtype=torch.int8)
  v_new = torch.empty((m, h), dtype=torch.int8)
  for y in range(n // (2 * GATE_COLS)):
    head_i, e0 = y // per_head, (y % per_head) * GATE_COLS
    r0 = head_i * h + e0
    r1 = r0 + half
    acc = torch.zeros((m, 2 * GATE_COLS), dtype=torch.int64)
    for i in range(-(-d2 // BK)):
      bt = torch.cat([_box(wqkv_p, r0, i * BK, GATE_COLS, BK),
                      _box(wqkv_p, r1, i * BK, GATE_COLS, BK)])
      lo, hi = _unpack_tile(bt)
      acc += _box(xq, 0, i * BK, m, BK) @ lo.T
      acc += _box(xq, 0, d2 + i * BK, m, BK) @ hi.T
    x1 = (acc[:, :GATE_COLS].to(F32) * xs) * s_qkv[r0:r0 + GATE_COLS]
    x2 = (acc[:, GATE_COLS:].to(F32) * xs) * s_qkv[r1:r1 + GATE_COLS]
    e = slice(e0, e0 + GATE_COLS)
    e2 = slice(half + e0, half + e0 + GATE_COLS)
    if head_i <= nq:
      x1, x2 = x1 * cos[:, e] - x2 * sin[:, e], x2 * cos[:, e] + x1 * sin[:, e]
    if head_i < nq:
      q[:, head_i, e], q[:, head_i, e2] = x1, x2
    else:
      inv = kq_inv if head_i == nq else vq_inv
      dst = k_new if head_i == nq else v_new
      for cols, v in ((e, x1), (e2, x2)):
        dst[:, cols] = torch.clamp(torch.round(v * inv), -127, 127).to(
            torch.int8)
  return q, k_new, v_new


def _write(k_pool, v_pool, pos, k_new, v_new):
  p = min(max(int(pos), 0), k_pool.shape[1] - 1)
  k_pool[:, p] = k_new
  v_pool[:, p] = v_new


def block_twin(args, bf, compute='f32', write_first=False, act='gelu',
               eps=1e-6):
  """The chain of fused_block.cu's launches 1-8 (write_first: launch 8
  before launch 7)."""
  (x, g1, wgu, sgu, wd, sd, g2, wqkv, sqkv, cos, sin, k_pool, v_pool,
   lengths, pos, ks, vs, kq, vq, nq) = args
  b, d, f, h = x.shape[0], x.shape[1], sgu.numel() // 2, k_pool.shape[2]
  (_, _), xn = _norm_quant(x, g1, eps)                       # 1
  hid = mlp_tc._drq_gate_up_h(xn, wgu, sgu, act)             # 2
  hq, hs = mlp_tc._hquant(hid, bf)                           # 3
  y = mlp_tc._drq_down_chain(hq, hs, wd, sd, bf, _down_chain(b, d, f, bf))
  xf = x.to(F32) + y                                         # 4
  (xq2, xs2), _ = _norm_quant(xf, g2, eps)                   # 5
  q, k_new, v_new = _qkv_pair(                               # 6
      xq2, xs2, wqkv, sqkv, cos, sin, nq, h,
      float(np.float32(1.0 / kq)), float(np.float32(1.0 / vq)))
  if write_first:
    _write(k_pool, v_pool, pos, k_new, v_new)
  ctx = stale.stale_twin(q[:, None], k_pool[:, None], v_pool[:, None],  # 7
                         lengths, k_new[:, None, None], v_new[:, None, None],
                         compute)
  if not write_first:
    _write(k_pool, v_pool, pos, k_new, v_new)                # 8
  return ctx.reshape(b, nq, h), xf.to(x.dtype), k_new, v_new, xf


def _plain_block(args, bf, compute='f32'):
  a = list(args)
  a[11], a[12] = a[11].clone(), a[12].clone()
  out = block.fused_mlp_qkv_attention(*a, k_zero_point=ZP_K,
                                      v_zero_point=ZP_V, bf=bf,
                                      compute=compute)
  return out, a[11], a[12]


def _x_ffn_f32(args, bf):
  """The plain version's f32 x_ffn (what the kernel keeps for norm 2)."""
  x, g1, wgu, sgu, wd, sd = args[:6]
  xf = x.to(F32)
  x_norm = xf * block.rms_inverse(xf, 1e-6) * g1
  return xf + mlp.mlp_int4_packed_plain(x_norm, wgu, sgu, wd, sd, bf=bf)


BLOCK_CASES = [  # b, pos, lengths (pos below lengths - 1 in some rows)
    (1, 31, (32,)),
    (7, 40, (41, 1, 64, 50, 2, 41, 64)),
    (64, 63, None),
    (65, 10, None)]


@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
@pytest.mark.parametrize('b,pos,lengths', BLOCK_CASES)
def test_block_chain_is_the_plain_version(b, pos, lengths, compute):
  d, f, nq, h, s, bf = 256, 1024, 2, 128, 64, 256
  if lengths is None:
    lengths = np.random.default_rng(b).integers(1, s + 1, b)
  args = _block_inputs(b, d, f, nq, h, s, bf, pos, lengths, seed=b + pos,
                       dtype=torch.bfloat16 if b % 2 else torch.float32)
  twin_args = list(args)
  twin_args[11], twin_args[12] = args[11].clone(), args[12].clone()
  ctx, x_ffn, k_new, v_new, xf = block_twin(twin_args, bf, compute)
  (pctx, px, pk, pv), kp, vp = _plain_block(args, bf, compute)
  for got, want in ((k_new, pk), (v_new, pv), (twin_args[11], kp),
                    (twin_args[12], vp)):
    assert torch.equal(got, want)
  assert torch.equal(x_ffn, px) and x_ffn.dtype == args[0].dtype
  assert torch.equal(xf, _x_ffn_f32(args, bf))  # the f32 kept for norm 2
  stale._hold(ctx, pctx, compute, rel=True)


def test_pair_tile_rope_is_the_plain_version():
  """Rows e and e + H/2 of a head in one tile: the epilogue's rotation and
  codes equal the plain version's RoPE of the whole projection, at H 128
  (one tile a head) and 256 (two)."""
  for h in (128, 256):
    m, d, nq = 9, 256, 3
    g = np.random.default_rng(h)
    x = torch.from_numpy(g.standard_normal((m, d)).astype(np.float32))
    w = torch.from_numpy(g.integers(-8, 8, ((nq + 2) * h, d)).astype(
        np.int8))
    s = torch.from_numpy((g.random((nq + 2) * h) * 0.01 + 0.005).astype(
        np.float32))
    ang = torch.from_numpy(g.random((m, h // 2)).astype(np.float32) * 6.0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xq, xs = pq.quantize_rows_drq(x)
    q, kn, vn = _qkv_pair(xq, xs, pq.pack_int4_split(w), s, cos, sin, nq, h,
                          float(np.float32(1 / KQ)), float(np.float32(1 / VQ)))
    qkv = (xq.to(torch.int64) @ w.to(torch.int64).T).to(F32) * xs * s
    want_q = block.rope_rotate(qkv[:, :nq * h].reshape(m, nq, h),
                               cos[:, None], sin[:, None])
    want_k = block._new_row_codes(
        block.rope_rotate(qkv[:, nq * h:(nq + 1) * h], cos, sin), KQ)
    want_v = block._new_row_codes(qkv[:, (nq + 1) * h:], VQ)
    assert torch.equal(q, want_q)
    assert torch.equal(kn, want_k) and torch.equal(vn, want_v)


def test_row_write_before_the_reads_is_caught():
  """Launch 8 before launch 7 changes ctx in every row whose stale rows
  hold pos (pos < lengths - 1) and in no other: the order is tested."""
  b, d, f, nq, h, s, bf, pos = 6, 256, 1024, 2, 128, 64, 256, 20
  lengths = (21, 40, 64, 5, 22, 1)  # pos < lengths - 1 in rows 1, 2 and 4
  args = _block_inputs(b, d, f, nq, h, s, bf, pos, lengths, seed=3)
  outs = []
  for write_first in (False, True):
    a = list(args)
    a[11], a[12] = args[11].clone(), args[12].clone()
    outs.append(block_twin(a, bf, write_first=write_first)[0])
  diff = torch.amax(torch.abs(outs[0] - outs[1]), dim=(1, 2))
  read = torch.tensor([pos < n - 1 for n in lengths])
  assert torch.all(diff[read] > stale.BOUND)
  assert torch.all(diff[~read] == 0.0)
  (pctx, _, _, _), _, _ = _plain_block(args, bf)
  stale._hold(outs[0], pctx, 'f32', rel=True)


# ----------------------------------------------------------------- #4 twins


def head_twin(x, w_q, scale, packed, true_n=None):
  """fused head: launch 1 (the reciprocal DRQ), launch 2's tiles of BN
  columns (stages of BK bytes; packed: the split-half unpack against the
  codes at kb and K/2 + kb) with the argmax epilogue, launch 3's
  reduction of the per-tile pairs (the larger value, then the smaller
  index)."""
  n = w_q.shape[0]
  k = w_q.shape[1] * (2 if packed else 1)
  true_n = n if true_n is None else min(true_n, n)
  x2 = x.reshape(-1, k)
  xq, xs = pq.quantize_rows_drq(x2.to(F32))
  xq = xq.to(torch.int64)
  m = xq.shape[0]
  cols = w_q.shape[1]
  pairs = []
  for n0 in range(0, n, BN):
    acc = torch.zeros((m, BN), dtype=torch.int64)
    for i in range(-(-cols // BK)):
      tile = _box(w_q, n0, i * BK, BN, BK)
      if packed:
        lo, hi = _unpack_tile(tile)
        acc += _box(xq, 0, i * BK, m, BK) @ lo.T
        acc += _box(xq, 0, k // 2 + i * BK, m, BK) @ hi.T
      else:
        acc += _box(xq, 0, i * BK, m, BK) @ tile.to(torch.int64).T
    assert int(acc.abs().max()) < 2**31
    c = torch.arange(n0, n0 + BN)
    ok = c < n
    v = (acc[:, ok].to(F32) * xs) * scale[c[ok]]
    if x.dtype == torch.bfloat16:
      v = v.to(torch.bfloat16).to(F32)
    v = torch.where(c[ok] < true_n, v, np.float32(-3.4e38))
    # The four lanes' columns, each the best of its own (first index on
    # ties), then the larger value and the smaller index.
    lanes = []
    for qd in range(4):
      mine = [j for j in range(v.shape[1]) if (j % 8) // 2 == qd]
      vm = v[:, mine]
      best = torch.argmax(vm, dim=1)
      lanes.append((vm[torch.arange(m), best], c[ok][mine][best]))
    bv, bi = lanes[0]
    for ov, oi in lanes[1:]:
      better = (ov > bv) | ((ov == bv) & (oi < bi))
      bv, bi = torch.where(better, ov, bv), torch.where(better, oi, bi)
    pairs.append((bv, bi))
  bv, bi = pairs[0]
  for ov, oi in pairs[1:]:
    better = (ov > bv) | ((ov == bv) & (oi < bi))
    bv, bi = torch.where(better, ov, bv), torch.where(better, oi, bi)
  return bi.to(torch.int32).reshape(x.shape[:-1])


def _head_case(m, n, k, packed, seed, ties=True):
  g = np.random.default_rng(seed)
  x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32))
  lo, hi = (-8, 8) if packed else (-127, 128)
  w = g.integers(lo, hi, (n, k)).astype(np.int8)
  s = (g.random(n) * 0.01 + 0.005).astype(np.float32)
  if ties:
    w[n - 100] = w[3]        # across tiles
    s[3] = s[n - 100] = 1.0
    w[BN + 6] = w[BN + 5]    # inside one tile
    s[BN + 5] = s[BN + 6] = 0.9
  w = torch.from_numpy(w)
  return x, (pq.pack_int4_split(w) if packed else w), torch.from_numpy(s)


@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m', [1, 7, 64, 256])
def test_head_epilogue_is_the_plain_argmax(m, dtype, packed):
  n, k = 700, 256
  x, w, s = _head_case(m, n, k, packed, seed=m + 2 * packed)
  x = x.to(dtype)
  for true_n in (None, n - 150):
    got = head_twin(x, w, s, packed, true_n)
    want = torch.argmax(head.head_logits_plain(
        x, w, s, packed=packed, true_n=true_n), dim=-1).to(torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(got, head.head_argmax_plain(x, w, s, packed=packed,
                                                   true_n=true_n))


def test_head_ties_go_to_the_first_index():
  """Equal logits in one tile (columns BN + 5, BN + 6) and across tiles
  (3, N - 100): the smaller index wins both, inside the epilogue and in
  the reduction."""
  n, k = 700, 256
  x = torch.ones((2, k))
  w = torch.zeros((n, k), dtype=torch.int8)
  s = torch.full((n,), 0.01)
  for a, b_ in ((BN + 5, BN + 6), (3, n - 100)):
    w[a] = w[b_] = 5
    s[a] = s[b_] = 1.0 if a == 3 else 2.0
    got = head_twin(x, w, s, packed=False)
    assert got.tolist() == [a, a]
    w[a] = w[b_] = 0


# ------------------------------------------------------------------- plans


def _gemm(m, wgs, n_tiles, steps, chain, max_stages, buffers):
  """mlp_int4_drq.cuh size_gemm."""
  bm = WG_ROWS * wgs
  stage = 2 * bm * BK + BN * BK
  unpack = buffers * 2 * BN * BK
  boxes = WG_ROWS * wgs * BN * 4 if chain > 1 else 0
  stages = min(max_stages, (INT8_BUDGET - 1024 - unpack - boxes) // stage)
  stages = min(stages, max(steps, 2))
  return dict(wgs=wgs, m_tiles=-(-m // bm), n_tiles=n_tiles, chain=chain,
              stages=stages, smem=1024 + stages * stage + unpack + boxes,
              ring=stages * stage)


TWO_ROW_TILES_ABOVE = _const(HEAD_SRC, 'kTwoRowTilesAbove')


def _head_plan(m, n, k, packed):
  """head_argmax.cu head_plan."""
  wgs = 1 if m <= WG_ROWS else 2
  rows = 2 if m > TWO_ROW_TILES_ABOVE else 1
  bm = WG_ROWS * rows * wgs
  stage = (2 * bm * BK + BN * BK) if packed else bm * BK + BN * BK
  unpack = 2 * 2 * BN * BK if packed else 0
  stages = min(MAX_STAGES, (INT8_BUDGET - 1024 - unpack) // stage)
  n_tiles = -(-n // BN)
  return dict(wgs=wgs, rows=rows, m_tiles=-(-m // bm), n_tiles=n_tiles,
              stages=stages,
              smem=1024 + stages * stage + unpack,
              blocks=max(1, min(n_tiles, H100_SMS)),
              steps=-(-(k // 2 if packed else k) // BK))


def test_block_plans_at_the_bench_shape():
  b, d, f, bf, nq, h = 256, 2048, 16384, 2048, 8, 256
  gu, dn = mlp_tc._drq_plans(b, d, f, bf)
  qkv = _gemm(b, 1, (nq + 2) * h // (2 * GATE_COLS), d // 2 // BK, 1,
              MAX_STAGES, 2)
  assert qkv['m_tiles'] * qkv['n_tiles'] == 80  # four row tiles of 64
  for p in (gu, dn, qkv):
    assert 2 <= p['stages'] <= MAX_STAGES
    assert p['smem'] <= SMEM_OPTIN - 1024
    assert WG_ROWS * p['wgs'] * ((BN + 8) * 4 + 4) <= p['ring']
  # The down's chain: 64 tiles at one warpgroup, two blocks a tile, in one
  # wave (the occupancy query may only shorten it).
  assert dn['m_tiles'] * dn['n_tiles'] * dn['chain'] <= H100_SMS
  assert 'qkv_plan(B, D, N)' in BLOCK_SRC
  assert 'return size_gemm(M, 1, N / (2 * kGateCols)' in MLP_HDR
  # #2's attention at the bench shape (R 256, G 8, S 1024, H 256) is the
  # split core's: H and G in its range.
  assert h in (64, 128, 256) and nq <= _const(split.SOURCE, 'kMaxG')


@pytest.mark.parametrize('m', [64, 256])
@pytest.mark.parametrize('packed', [False, True])
def test_head_plans_at_the_bench_shapes(m, packed):
  n, k = 256128, 2048
  p = _head_plan(m, n, k, packed)
  assert p['n_tiles'] == 2001 and p['blocks'] == H100_SMS  # persistent
  assert 2 <= p['stages'] <= MAX_STAGES
  assert p['smem'] <= SMEM_OPTIN - 1024
  # One row tile: a stage's weight tile serves every row (two 64-row
  # accumulators a warpgroup at M 256), read and unpacked once.
  assert p['m_tiles'] == 1 and p['rows'] * p['wgs'] * WG_ROWS >= m
  assert p['steps'] == (8 if packed else 16)
  # The stage's A box: at most 256 rows (TMA's box limit).
  assert p['rows'] * p['wgs'] * WG_ROWS <= 256


# ----------------------------------------------------------------- sources


def test_block_runs_on_the_cores():
  code = _strip_comments(BLOCK_SRC)
  for gone in ('cooperative', 'grid.sync', '__dp4a', 'dot_packed',
               'stale_attention_row', 'qkv['):
    assert gone not in code, gone
  assert '#include "mlp_int4_drq.cuh"' in code
  assert '#include "attention_stale.cuh"' in code
  body = code[code.index('int launch_all('):]
  order = [body.index(s) for s in (
      'norm_quant_kernel<T><<<', 'mlp::launch_gemm<mlp::kGateUp',
      'mlp::launch_hquant(', 'mlp::launch_gemm<mlp::kDown',
      'launch_dependent(norm_quant_kernel<float>',
      'mlp::launch_gemm<mlp::kQkv', 'aeqt::stale::run(',
      'write_rows_kernel<<<')]
  assert order == sorted(order)  # the row write after the attention
  entry = code[code.index('extern "C" int aeqt_fused_block('):]
  assert entry.index('if (!takes(a)) return aeqt::kShapeRefused;') < \
      entry.index('launch_all<')
  hdr = _strip_comments(MLP_HDR)
  assert 'r1 = x1' not in hdr  # the rotation's two products and the sum
  assert 'y1[e] = x1[e] * cs[e] - x2[e] * sn[e];' in hdr
  assert 'y2[e] = x2[e] * cs[e] + x1[e] * sn[e];' in hdr
  assert 'for (int e = 0; e < 4; ++e) y[e] = aeqt::load_f(x, e) + y[e];' in hdr
  for call in ('cublas', 'cudnn', 'cooperative'):
    assert call not in hdr.lower()


def test_head_drq_route_runs_on_the_int8_core():
  code = _strip_comments(HEAD_SRC)
  assert '#include "int8_tc_gemm.cuh"' in code
  for gone in ('head_tiles_kernel', '__dp4a', 'dot_packed', 'dot_int8',
               'aeqt::quantize_rows(', 'cublas', 'atomic'):
    assert gone not in code, gone
  assert 'tc::launch_quantize<Ld, T>' in code
  assert 'launch_drq<tc::SplitNibblesRecipB, T>' in code
  assert 'launch_drq<tc::Int8RowsB, T>' in code
  # One stage's B tile (or its unpacked lo and hi tiles) for every row
  # tile of the block.
  assert 'tc::wgmma_stage(d[r], a, bt);' in code
  # The weight-only branch runs its own persistent wgmma kernel on the
  # bf16 core (no mma.sync tile) and shares only the reduction; its
  # narrowest vocab tile (two warpgroups of 64 rows) sizes the pairs.
  assert 'head_wo_kernel' in code and 'head_tiles_bf16_kernel' not in code
  assert not (CSRC / 'qmatmul_int4_weight_only.cuh').exists()
  assert code.count('head_reduce_kernel<<<') == 2
  wgs = re.search(r'p\.wgs = M <= kWoTok \? (\d+) : (\d+);', HEAD_SRC)
  assert head._HEAD_DRQ_BN == BN and head._HEAD_BN == min(
      int(g) for g in wgs.groups()) * WG_ROWS


def test_plan_fields_match_the_sources():
  assert len(block.PLAN_FIELDS) == 23
  assert 'fields + 18' in BLOCK_SRC and 'fields + 12' in BLOCK_SRC
  assert len(head.DRQ_PLAN_FIELDS) == 6 and 'fields[5] = p.stages;' in \
      HEAD_SRC


# ----------------------------------------------- against interpret Pallas


def test_block_twin_matches_interpret_pallas():
  """The chain's twin against `fused_mlp_qkv_attention` in interpret mode
  (writeback off, the caller's row write), test_torch_port_block.py's
  bounds: codes and pools equal, x_ffn 2e-6 of its largest value, ctx
  5e-5."""
  b, d, f, nq, h, s, bf, pos = 8, 256, 512, 4, 128, 64, 256, 31
  lengths = np.random.default_rng(1).integers(1, pos + 2, b)
  lengths[0] = pos + 1
  args = _block_inputs(b, d, f, nq, h, s, bf, pos, lengths, seed=11)
  a = list(args)
  a[11], a[12] = args[11].clone(), args[12].clone()
  ctx, x_ffn, k_new, v_new, _ = block_twin(a, bf)
  j = lambda t: jnp.asarray(t.numpy())
  jctx, jx, jk, jv, _, _ = _exact(pallas_block.fused_mlp_qkv_attention)(
      j(args[0]), j(args[1]),
      pallas_qmatmul.pack_int4_split(j(pq.unpack_int4_split(args[2]))),
      j(args[3]),
      pallas_mlp.pack_int4_split_grouped(
          j(mlp.unpack_int4_split_grouped(args[4], bf)), bf),
      j(args[5]), j(args[6]),
      pallas_qmatmul.pack_int4_split(j(pq.unpack_int4_split(args[7]))),
      j(args[8]), j(args[9]), j(args[10]), j(args[11]), j(args[12]),
      j(args[13]), jnp.int32(pos), K_SCALE, V_SCALE, KQ, VQ, nq,
      k_zero_point=ZP_K, v_zero_point=ZP_V, eps=1e-6, bf=bf, bb=4, ring=2,
      writeback=False, interpret=True)
  assert np.array_equal(k_new.numpy(), np.asarray(jk))
  assert np.array_equal(v_new.numpy(), np.asarray(jv))
  jx = np.asarray(jx, np.float32)
  assert np.max(np.abs(x_ffn.numpy() - jx)) <= 2e-6 * np.max(np.abs(jx))
  assert np.max(np.abs(ctx.numpy() - np.asarray(jctx))) <= 5e-5


@pytest.mark.parametrize('packed', [False, True])
def test_head_twin_matches_interpret_pallas(packed):
  m, n, k = 6, 640, 256
  x, w, s = _head_case(m, n, k, packed, seed=5)
  xb = x.to(torch.bfloat16)
  for xx in (x, xb):
    want = np.asarray(_exact(pallas_head.head_argmax_pallas)(
        jnp.asarray(xx.float().numpy()).astype(
            jnp.bfloat16 if xx.dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(w.numpy()), jnp.asarray(s.numpy()), packed=packed,
        true_n=600, bn=128, drq=True, interpret=True))
    got = head_twin(xx, w, s, packed, true_n=600).numpy()
    np.testing.assert_array_equal(got, want)
