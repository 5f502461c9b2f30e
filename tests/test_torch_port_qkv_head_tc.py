"""The attention prologue (#20, `csrc/qkv_rope.cu`) and the greedy head's
weight-only branch (#4, `csrc/head_argmax.cu` head_wo_kernel) on the
tensor-core cores, on the CPU, where no CUDA kernel runs: numpy twins of
each launch chain in the kernels' own order.

  * #20 with DRQ: the norm that ends in the row's DRQ codes (norm_rows.cuh
    `rmsnorm_quant_rows_kernel`: the block-a-row f64 sum of squares, r in
    IEEE f32, xn rounded where the unfused RMS_NORM op rounds), then the
    int8 core's pair tile (mlp_int4_drq.cuh `kQkvRope`: rows e0 .. and
    e0 + H/2 .. of a head in one tile, exact int32 sums, the projection
    rounded to the activation dtype, then the rotation): bit for bit with
    `qkv_rope_plain`, f32 and bf16 x, one and two KV heads, h 128 and 256.
  * #20 weight-only: the norm, then at bf16 x the bf16 core's pair tile
    (`QkvRopePairs`: lo and hi over the k16 windows and the plan's splits
    in order, added, scaled, rounded, rotated), at f32 x the SIMT tile and
    `rope_split_kernel`: within `int_weights_tolerance` of the plain
    version (and, for q and k at bf16, chip_smoke's rule: twice that and
    four bf16 ulps of the head's largest output).
  * Both against interpret-mode `qkv_rope_pallas` compiled with XLA's
    excess precision off, by test_torch_port_attn_block.py's rules.
  * The projection's rounding before the rotation matters: a twin that
    rotates the f32 projection leaves the plain version at bf16 x.
  * #4 weight-only: the persistent grid's tile order (block b takes vocab
    tiles b, b + blocks, ...), the passes of 64 or 128 tokens, the f32
    accumulators of the lo and hi windows, the argmax epilogue (each
    token's column over the thread's rows, the quad's lanes, and the
    warps through 64-bit keys), and the reduction over the tiles: ids
    equal to `head_argmax_plain`'s with integer-valued x (every f32 sum
    exact), ties inside a tile, across tiles and across blocks, true_n <
    N. The keys order as `better` does.
  * The launch plans and the sources: both chains on the cores, the SIMT
    DRQ tiles and the mma.sync tiles gone.

The card runs the kernels against their plain versions in `chip_smoke.py`.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_qkv
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import head
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
from ai_edge_quantizer_tpu_torch.kernels import qkv

import test_torch_port_int4_bf16_tc as bf16_core
from test_torch_port_attn_block import (_as_f32, _bf16_ulp, _exact, _j,
                                        _qkv_case, _within)

CSRC = pathlib.Path(_build.CSRC)
QKV_SRC = (CSRC / 'qkv_rope.cu').read_text()
HEAD_SRC = (CSRC / 'head_argmax.cu').read_text()
MLP_HDR = (CSRC / 'mlp_int4_drq.cuh').read_text()
NORM_HDR = (CSRC / 'norm_rows.cuh').read_text()
W4_CORE = bf16_core.CORE
F32 = np.float32
EPS = 1e-6
H100_SMS = 132


def _const(src, name):
  found = re.search(rf'constexpr (?:int|size_t) {name} = ([^;]+);', src)
  assert found, name
  return found.group(1).strip()


NORM_THREADS = int(_const(NORM_HDR, 'kNormThreads'))
GATE_COLS = int(_const(MLP_HDR, 'kGateCols'))
PAIR_H = int(_const(QKV_SRC, 'kPairH'))
WO_TOK = int(_const(HEAD_SRC, 'kWoTok'))
_WO_WGS = re.search(r'p\.wgs = M <= kWoTok \? (\d+) : (\d+);', HEAD_SRC)
_WO_R = re.search(r'p\.r = M <= kWoTok \? (\d+) : (\d+);', HEAD_SRC)
WO_MAX_STAGES = int(_const(HEAD_SRC, 'kWoMaxStages'))
WO_SUB = int(_const(HEAD_SRC, 'kWoSub'))  # 64-byte K steps a ring stage
WO_ROWS = bf16_core.WG_ROWS  # kWoRows = w4::kWgRows
STEP = bf16_core.STEP_BYTES
_INV127 = np.float32(1.0 / 127.0)


def _t(a):
  return torch.from_numpy(np.array(a))


def _round(a, bf16):
  """f32 array a rounded to bf16 (and back) when bf16, else as it is."""
  a = np.asarray(a, F32)
  return _t(a).to(torch.bfloat16).float().numpy() if bf16 else a


# ------------------------------------------------------------ #20 stages


def _row_r(xf, eps=EPS):
  """norm_rows.cuh row_rms_inverse: a block of NORM_THREADS a row, each
  thread's strided squares summed in f64 in order, the warps' butterfly,
  the warps' sums in warp order; var rounded to f32 once; r = 1 / sqrt in
  IEEE f32 (numpy's f32 sqrt and division are correctly rounded)."""
  m, k = xf.shape
  sq = xf.astype(np.float64) ** 2
  cols = np.pad(sq, ((0, 0), (0, (-k) % NORM_THREADS))).reshape(
      m, -1, NORM_THREADS)
  part = np.zeros((m, NORM_THREADS))
  for step in range(cols.shape[1]):
    part = part + cols[:, step]
  lanes = part.reshape(m, NORM_THREADS // 32, 32)
  for o in (16, 8, 4, 2, 1):
    lanes = lanes + lanes[:, :, np.arange(32) ^ o]
  ss = lanes[:, 0, 0]
  for w in range(1, NORM_THREADS // 32):
    ss = ss + lanes[:, w, 0]
  var = (ss / k).astype(F32)
  return F32(1.0) / np.sqrt(var + F32(eps))


def norm_stage(x, g, bf16):
  """norm_value<T, false>: xn = T(T(x * T(r)) * gamma), x the T values."""
  r = _round(_row_r(x), bf16)[:, None]
  return _round(_round(x * r, bf16) * g[None, :], bf16)


def quant_stage(xn):
  """rmsnorm_quant_rows_kernel's end: xs = max(absmax, 1e-9) * (1/127),
  xq = rint(xn * (1 / xs)), half to even."""
  xs = np.maximum(np.abs(xn).max(axis=1), F32(1e-9)) * _INV127
  inv = F32(1.0) / xs
  return np.rint(xn * inv[:, None]).astype(np.int8), xs.astype(F32)


def _rotate(x1, x2, c, s):
  """The epilogue's half-split RoPE in f32, each product and sum rounded."""
  return x1 * c - x2 * s, x2 * c + x1 * s


class _Heads:
  """q, k and v of a call, filled head by head (elements e0 .. of both
  halves)."""

  def __init__(self, m, nq, nk, h):
    self.nq, self.nk, self.h = nq, nk, h
    self.out = [np.full((m, nq * h), np.nan, F32),
                np.full((m, nk * h), np.nan, F32),
                np.full((m, nk * h), np.nan, F32)]

  def put(self, head, e0, y1, y2):
    nq, nk, h = self.nq, self.nk, self.h
    part, at = ((0, head) if head < nq else (1, head - nq)
                if head < nq + nk else (2, head - nq - nk))
    cols = at * h + e0 + np.arange(y1.shape[1])
    self.out[part][:, cols] = y1
    self.out[part][:, cols + h // 2] = y2


def _pair_epilogue(heads, x1, x2, head, e0, cos, sin, bf16, round_first=True):
  """kQkvRope's / QkvRopePairs' epilogue on a tile's columns e0 .. of both
  halves: the projection rounded to T (unless round_first is off), the
  rotation of a query or key head, the store in T."""
  if round_first:
    x1, x2 = _round(x1, bf16), _round(x2, bf16)
  if head < heads.nq + heads.nk:
    e = slice(e0, e0 + x1.shape[1])
    x1, x2 = _rotate(x1, x2, cos[:, e], sin[:, e])
  heads.put(head, e0, _round(x1, bf16), _round(x2, bf16))


def drq_pair_stage(xq, xs, w, s, cos, sin, nq, nk, h, bf16, round_first=True):
  """mlp_tc_kernel<kQkvRope>: pair tile y holds rows e0 .. e0 + 63 and
  e0 + h/2 .. of head y / (h / 128); the exact int32 sums; x = (f32(acc) *
  xs) * s."""
  m = xq.shape[0]
  n = w.shape[0]
  acc = xq.astype(np.int64) @ pq.unpack_int4_split(_t(w)).numpy().astype(
      np.int64).T
  assert np.abs(acc).max() < 2**24  # exact in f32
  heads = _Heads(m, nq, nk, h)
  per_head = h // (2 * GATE_COLS)
  for y in range(n // (2 * GATE_COLS)):
    head_i, e0 = y // per_head, (y % per_head) * GATE_COLS
    r0 = head_i * h + e0
    r1 = r0 + h // 2
    x1 = (acc[:, r0:r0 + GATE_COLS].astype(F32) * xs[:, None]) * s[
        r0:r0 + GATE_COLS]
    x2 = (acc[:, r1:r1 + GATE_COLS].astype(F32) * xs[:, None]) * s[
        r1:r1 + GATE_COLS]
    _pair_epilogue(heads, x1, x2, head_i, e0, cos, sin, bf16, round_first)
  return heads.out


def bf16_pair_stage(xn, w, s, cos, sin, nq, nk, h):
  """int4_bf16_tc_kernel<QkvRopePairs>: the core's plan (ChannelScale's),
  a block's kRows weight rows the halves' rows pr.x .. and pr.y .., lo and
  hi over each split's k16 windows, the splits in order, acc = lo + hi, x =
  bf16(acc * s), then the epilogue."""
  m, k = xn.shape
  n = w.shape[0]
  wgs, _, _, _, split, per, steps, _ = bf16_core._plan(m, n, k, 0, 'channel')
  rows = bf16_core.WG_ROWS * wgs
  half = rows // 2
  xlo, xhi, wlo, whi = bf16_core._windows(xn, w, k)
  heads = _Heads(m, nq, nk, h)
  per_head = h // rows
  for y in range(n // rows):
    head_i, e0 = y // per_head, (y % per_head) * half
    r0 = head_i * h + e0
    r1 = r0 + h // 2
    sel = np.r_[r0:r0 + half, r1:r1 + half]
    parts = [(bf16_core._contract(xlo, wlo[sel], range(z * per, min(
        steps, (z + 1) * per))), bf16_core._contract(xhi, whi[sel], range(
            z * per, min(steps, (z + 1) * per)))) for z in range(split)]
    lo, hi = parts[0]
    for plo, phi in parts[1:]:  # in split order
      lo, hi = lo + plo, hi + phi
    acc = lo + hi
    x1 = acc[:, :half] * s[r0:r0 + half]
    x2 = acc[:, half:] * s[r1:r1 + half]
    _pair_epilogue(heads, x1, x2, head_i, e0, cos, sin, True)
  return heads.out


def rope_split_stage(qkv_rows, cos, sin, nq, nk, h, bf16):
  """rope_split_kernel over the qkv scratch (T values): one output element
  a thread, the same rotation."""
  m = qkv_rows.shape[0]
  heads = _Heads(m, nq, nk, h)
  half = h // 2
  for head_i in range(nq + 2 * nk):
    hd = qkv_rows[:, head_i * h:(head_i + 1) * h]
    x1, x2 = hd[:, :half], hd[:, half:]
    if head_i < nq + nk:
      x1, x2 = _rotate(x1, x2, cos, sin)
    heads.put(head_i, 0, _round(x1, bf16), _round(x2, bf16))
  return heads.out


def qkv_twin(x, g, w, s, cos, sin, nq, nk, h, drq, bf16, round_first=True):
  """The launch chain qkv_rope.cu's route_of picks for the shape."""
  xn = norm_stage(x, g, bf16)
  if drq:
    xq, xs = quant_stage(xn)
    if h % PAIR_H == 0:
      return drq_pair_stage(xq, xs, w, s, cos, sin, nq, nk, h, bf16,
                            round_first)
    acc = xq.astype(np.int64) @ pq.unpack_int4_split(_t(w)).numpy().astype(
        np.int64).T
    rows = _round((acc.astype(F32) * xs[:, None]) * s[None, :], bf16)
    return rope_split_stage(rows, cos, sin, nq, nk, h, bf16)
  if bf16 and h % PAIR_H == 0:
    return bf16_pair_stage(xn, w, s, cos, sin, nq, nk, h)
  xlo, xhi, wlo, whi = bf16_core._windows(xn, w, xn.shape[1])
  rows = _round((xlo @ wlo.T + xhi @ whi.T) * s[None, :], bf16)
  return rope_split_stage(rows, cos, sin, nq, nk, h, bf16)


def _hold_wo(got, want, name, h, d, bf16):
  """Weight-only: int_weights_tolerance of max |y|; at bf16 one ulp more,
  and for q and k chip_smoke.qkv_kernel's rule (the rotation mixes two
  projections each rounded to bf16): twice the tolerance and four bf16
  ulps of the head's largest output."""
  ymax = float(np.abs(want).max())
  tol = int_qmatmul.int_weights_tolerance(d, 0, ymax)
  if not bf16:
    return np.abs(got - want).max() <= tol
  if name == 'v':
    return _within(got, want, tol, True)
  heads = want.reshape(want.shape[0], -1, h)
  hmax = np.abs(heads).max(axis=-1, keepdims=True)
  atol = np.broadcast_to(2 * tol + 4 * _bf16_ulp(hmax), heads.shape)
  return _within(got, want, atol.reshape(want.shape), True)


def _case(nk, h, dtype, seed, m=9, d=256, nq=3):
  x, g, w, s, cos, sin = _qkv_case(seed, m, d, nq, nk, h, scale_x=3.0)
  jx = jnp.asarray(x, dtype)
  xv = _as_f32(jx)  # the values of T
  return (xv, g, w, s, cos.reshape(m, h // 2), sin.reshape(m, h // 2), jx,
          nq, d)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('drq', [True, False])
@pytest.mark.parametrize('nk,h', [(1, 128), (2, 128), (1, 256)])
def test_qkv_chain_twin_is_the_plain_version(nk, h, drq, dtype):
  """The chain of the shape's route (the pair tiles at h 128 and 256)
  against qkv_rope_plain: DRQ bit for bit, weight-only within its rule."""
  bf16 = dtype == 'bfloat16'
  xv, g, w, s, cos, sin, _, nq, d = _case(nk, h, dtype, seed=nk + h + drq)
  got = qkv_twin(xv, g, w, s, cos, sin, nq, nk, h, drq, bf16)
  tx = _t(xv).to(getattr(torch, dtype))
  want = qkv.qkv_rope_plain(tx, _t(g), _t(w), _t(s), _t(cos), _t(sin),
                            nq=nq, nk=nk, h=h, drq=drq)
  for name, a, b in zip('qkv', got, want):
    b = b.float().numpy()
    assert not np.isnan(a).any(), name
    if drq:
      np.testing.assert_array_equal(a, b, err_msg=name)
    else:
      assert _hold_wo(a, b, name, h, d, bf16), name


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('drq', [True, False])
@pytest.mark.parametrize('nk', [1, 2])
def test_qkv_chain_twin_matches_interpret_pallas(nk, drq, dtype):
  """The twin against `qkv_rope_pallas` in interpret mode at h 128 (the
  pair tiles), by test_torch_port_attn_block.py's rules: DRQ within 1e-6
  of max |y| (JAX's f32 mean and rsqrt against the f64 sum and the IEEE
  root), weight-only within int_weights_tolerance; one bf16 ulp more at
  bf16 (q and k at weight-only bf16: the rule above)."""
  bf16 = dtype == 'bfloat16'
  h = 128
  xv, g, w, s, cos, sin, jx, nq, d = _case(nk, h, dtype, seed=7 * nk + drq)
  got = qkv_twin(xv, g, w, s, cos, sin, nq, nk, h, drq, bf16)
  want = _exact(pallas_qkv.qkv_rope_pallas)(
      jx, _j(g), _j(w), _j(s), _j(cos[:, None]), _j(sin[:, None]), nq=nq,
      nk=nk, h=h, drq=drq, interpret=True)
  for name, a, b in zip('qkv', got, want):
    b = _as_f32(b).reshape(a.shape)
    if drq:
      assert _within(a, b, 1e-6 * float(np.abs(b).max()), bf16), name
    else:
      assert _hold_wo(a, b, name, h, d, bf16), name


@pytest.mark.parametrize('drq', [True, False])
def test_projection_rounds_before_the_rotation(drq):
  """At bf16 x the rotation takes the projection rounded to bf16: a twin
  that rotates the f32 projection leaves the plain version (DRQ: its bits;
  weight-only: many outputs beyond one bf16 ulp), while at f32 x, where the
  rounding is none, the two twins agree."""
  h, nk = 128, 1
  for dtype in ('bfloat16', 'float32'):
    bf16 = dtype == 'bfloat16'
    xv, g, w, s, cos, sin, _, nq, _ = _case(nk, h, dtype, seed=11, m=16)
    tx = _t(xv).to(getattr(torch, dtype))
    want = qkv.qkv_rope_plain(tx, _t(g), _t(w), _t(s), _t(cos), _t(sin),
                              nq=nq, nk=nk, h=h, drq=True)
    xn = norm_stage(xv, g, bf16)
    xq, xs = quant_stage(xn)
    outs = [drq_pair_stage(xq, xs, w, s, cos, sin, nq, nk, h, bf16, rf)
            for rf in (True, False)]
    if not drq:  # the weight-only pair tile with and without the rounding
      outs = []
      for rf in (True, False):
        heads = _Heads(xv.shape[0], nq, nk, h)
        xlo, xhi, wlo, whi = bf16_core._windows(xn, w, xn.shape[1])
        proj = (xlo @ wlo.T + xhi @ whi.T) * s[None, :]
        for head_i in range(nq + 2 * nk):
          hd = proj[:, head_i * h:(head_i + 1) * h]
          _pair_epilogue(heads, hd[:, :h // 2], hd[:, h // 2:], head_i, 0,
                         cos, sin, bf16, rf)
        outs.append(heads.out)
      want = qkv.qkv_rope_plain(tx, _t(g), _t(w), _t(s), _t(cos), _t(sin),
                                nq=nq, nk=nk, h=h, drq=False)
    good, bad = outs
    q_want = want[0].float().numpy()
    if bf16:
      if drq:
        np.testing.assert_array_equal(good[0], q_want)
        assert np.count_nonzero(bad[0] != q_want) > 0
      else:
        off = np.abs(bad[0] - q_want) > _bf16_ulp(q_want)
        assert np.count_nonzero(off) > np.count_nonzero(
            np.abs(good[0] - q_want) > _bf16_ulp(q_want))
    else:
      np.testing.assert_array_equal(good[0], bad[0])


def test_column_route_at_a_head_size_the_pair_tile_refuses():
  """h 64 (h % 128 != 0): the norm, the core's column tile into the qkv
  scratch, then rope_split_kernel; DRQ bit for bit with the plain version
  at both dtypes."""
  h, nk = 64, 2
  for dtype in ('float32', 'bfloat16'):
    bf16 = dtype == 'bfloat16'
    xv, g, w, s, cos, sin, _, nq, _ = _case(nk, h, dtype, seed=5)
    got = qkv_twin(xv, g, w, s, cos, sin, nq, nk, h, True, bf16)
    tx = _t(xv).to(getattr(torch, dtype))
    want = qkv.qkv_rope_plain(tx, _t(g), _t(w), _t(s), _t(cos), _t(sin),
                              nq=nq, nk=nk, h=h, drq=True)
    for a, b in zip(got, want):
      np.testing.assert_array_equal(a, b.float().numpy())


def test_norm_stage_is_the_plain_norm():
  """The norm launch's xn equals qkv_norm_plain's bit for bit at D 2048
  (rms_inverse's IEEE root and the kernel's sum order round to the same
  r), both dtypes, rows of very different scales."""
  rng = np.random.default_rng(3)
  x = (rng.standard_normal((64, 2048)) * (rng.random((64, 1)) * 8 + 0.01)
       ).astype(F32)
  g = (1 + 0.1 * rng.standard_normal(2048)).astype(F32)
  for dtype in (torch.float32, torch.bfloat16):
    tx = _t(x).to(dtype)
    xv = tx.float().numpy()
    want = qkv.qkv_norm_plain(tx, _t(g), EPS).float().numpy()
    np.testing.assert_array_equal(norm_stage(xv, g, dtype == torch.bfloat16),
                                  want)


# ------------------------------------------------------------ #20 plans


def _route(m, d, nq, nk, h, drq, x_bf16):
  """qkv_rope.cu route_of (the Route enum's names), None where refused."""
  n = (nq + 2 * nk) * h
  if m <= 0 or h % 2 or nq < 1 or nk < 1:
    return None
  if drq:
    if d % 32:
      return None
    return 'drq_pair_tile' if h % PAIR_H == 0 else \
        'drq_column_tile_rope_launch'
  if n % 64 or d % 128:
    return None
  if not x_bf16:
    return 'f32_simt_rope_launch'
  return 'bf16_pair_tile' if h % PAIR_H == 0 else \
      'bf16_column_tile_rope_launch'


def test_routes_and_the_pair_plan():
  """Every route name is the enum's, in order; at bench.py's shape (M 256,
  D 2048, 8 query heads and one KV head of 256) the DRQ pair tile runs 80
  blocks of one warpgroup (mlp_int4_drq.cuh qkv_plan), the weight-only one
  the bf16 core's plan (split 3 in a cluster, 120 blocks)."""
  names = re.search(r'enum Route : int \{(.*?)\};', QKV_SRC, re.S).group(1)
  assert re.findall(r'k(\w+) = (\d+)', names) == [
      ('DrqPair', '0'), ('DrqColumns', '1'), ('Bf16Pair', '2'),
      ('Bf16Columns', '3'), ('F32Simt', '4')]
  assert len(qkv.ROUTES) == 5
  assert _route(256, 2048, 8, 1, 256, True, True) == qkv.ROUTES[0]
  assert _route(256, 2048, 8, 1, 256, False, True) == qkv.ROUTES[2]
  assert _route(256, 2048, 8, 1, 256, False, False) == qkv.ROUTES[4]
  assert _route(6, 256, 4, 2, 64, True, True) == qkv.ROUTES[1]
  assert _route(6, 256, 4, 1, 64, False, True) == qkv.ROUTES[3]
  assert _route(6, 96, 4, 1, 64, True, True) == qkv.ROUTES[1]  # D 96: DRQ
  assert _route(6, 96, 4, 1, 64, False, True) is None        # D % 128
  n = (8 + 2) * 256
  assert n // (2 * GATE_COLS) * -(-256 // 64) == 80
  wgs, _, m_tiles, n_tiles, split, *_ = bf16_core._plan(256, n, 2048, 0,
                                                        'channel')
  assert (wgs, m_tiles * n_tiles * split) == (2, 120)
  assert 256 % (bf16_core.WG_ROWS * wgs) == 0  # a pair tile within a head
  assert len(qkv.PLAN_FIELDS) == 11
  written = {int(i) for i in re.findall(r'\bfields\[(\d+)\] =', QKV_SRC)}
  assert written == set(range(4))
  assert 'long long* f = fields + 4;' in QKV_SRC


def test_drq_scratch_holds_codes_and_scales():
  """The codes (M * D bytes) and the scales (16-byte aligned after them)
  fit the wrapper's xn scratch of M * D values of T for every D % 32 == 0
  the DRQ route takes."""
  for m in (1, 7, 256, 1024):
    for d in (32, 64, 96, 2048):
      for size in (2, 4):  # bf16, f32
        assert -(-m * d // 16) * 16 + 4 * m <= m * d * size


# ------------------------------------------------------------ #4 keys


def _better(v, i, bv, bi):
  return v > bv or (v == bv and i < bi)


def pair_key(v, i):
  """head_argmax.cu pair_key on an f32 value and an index."""
  v = F32(0.0) if v == 0 else F32(v)
  u = int(np.array(v, F32).view(np.uint32))
  u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
  return (u << 32) | (0xFFFFFFFF - i)


def key_pair(key):
  """head_argmax.cu key_pair."""
  u = key >> 32
  u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
  return float(np.array(u, np.uint32).view(F32)), 0xFFFFFFFF - (
      key & 0xFFFFFFFF)


def test_keys_order_as_better():
  """The keys give back their pair (-0 as +0) and order as `better`:
  larger value first, then the smaller index, over values of either sign,
  zeros of both signs, the mask value and huge ones."""
  rng = np.random.default_rng(4)
  special = [0.0, -0.0, -3.4e38, 3.4e38, 1e-30, -1e-30, 1.5, -1.5]
  vals = list(rng.standard_normal(60).astype(F32)) + special
  idx = [0, 1, 2, 255, 256128, 2**31 - 1]
  pairs = [(F32(v), i) for v in vals for i in idx[:3]] + [
      (F32(1.5), i) for i in idx]
  for v, i in pairs:
    back_v, back_i = key_pair(pair_key(v, i))
    assert back_i == i and back_v == v
    assert not np.signbit(back_v) or v != 0
  for _ in range(2000):
    (v, i), (w, j) = (pairs[k] for k in rng.integers(0, len(pairs), 2))
    if (v, i) == (w, j) or (v == w and i == j):
      continue
    assert (pair_key(v, i) > pair_key(w, j)) == _better(v, i, w, j)


# ------------------------------------------------------------ #4 twin


def wo_plan(m, n, k, packed, sms=H100_SMS):
  """head_argmax.cu wo_plan: consumer warpgroups (one 64-row tile each),
  token tiles a pass, vocab rows a tile, tokens a pass, passes, vocab
  tiles, K steps, stages, blocks, shared memory."""
  small = m <= WO_TOK
  wgs = int(_WO_WGS.group(1 if small else 2))
  r = int(_WO_R.group(1 if small else 2))
  rows, tok = wgs * WO_ROWS, r * WO_TOK
  sub = WO_SUB
  stage = sub * (2 if packed else 1) * r * WO_TOK * 128 + rows * sub * STEP
  keys = 2 * (wgs * 4) * tok * 8  # static: a pass's keys, in turns
  stages = min(WO_MAX_STAGES, (232448 - 1024 - keys - 256) // stage)
  n_tiles = -(-n // rows)
  return dict(wgs=wgs, r=r, rows=rows, tok=tok, passes=-(-m // tok),
              n_tiles=n_tiles,
              steps=-(-((k // 2 if packed else k) // STEP) // sub), sub=sub,
              stages=stages, blocks=max(1, min(n_tiles, sms)),
              smem=1024 + stages * stage, static=keys)


def head_wo_twin(x, w_q, scale, packed, true_n=None, sms=H100_SMS):
  """head_wo_kernel and head_reduce_kernel: block b's vocab tiles b, b +
  blocks, ... in turn, each in passes of `tok` tokens; per stage its
  64-byte K steps in order (a stage past K adds zeros), their k16 windows
  in order into one f32 accumulator, lo then hi; the epilogue's logits acc
  * s rounded to x's dtype, -3.4e38 past true_n; per warp (16 rows of a
  row tile) the best pair of each token by `better`, the warps' keys'
  largest; then the reduction over the tiles."""
  m, k = x.shape
  n = w_q.shape[0]
  true_n = n if true_n is None else min(true_n, n)
  p = wo_plan(m, n, k, packed, sms)
  xb = _round(x.float().numpy(), True)  # x rounded to bf16
  wf = (pq.unpack_int4_split(w_q) if packed else w_q).numpy().astype(F32)
  s = scale.numpy()
  cast = x.dtype == torch.bfloat16
  half = k // 2
  steps64 = (half if packed else k) // STEP
  pmax = np.full((m, p['n_tiles']), np.nan, F32)
  pidx = np.full((m, p['n_tiles']), -1, np.int64)
  for b in range(p['blocks']):
    for tile in range(b, p['n_tiles'], p['blocks']):
      n0 = tile * p['rows']
      rows = np.arange(n0, min(n0 + p['rows'], n))
      for ps in range(p['passes']):
        toks = np.arange(ps * p['tok'], min(m, (ps + 1) * p['tok']))
        acc = np.zeros((len(toks), len(rows)), F32)
        for i in range(p['steps'] * p['sub']):
          if i >= steps64:
            continue  # a sub-step past K: zero weights
          for c in range(4):
            col = i * STEP + 16 * c
            windows = [slice(col, col + 16)]
            if packed:
              windows.append(slice(half + col, half + col + 16))
            for cols in windows:  # lo, then hi
              acc = acc + (xb[toks][:, cols]
                           @ wf[rows][:, cols].T).astype(F32)
        v = acc * s[rows][None, :]
        v = _round(v, cast)
        v = np.where(rows[None, :] < true_n, v, F32(-3.4e38))
        for ti, m_i in enumerate(toks):
          best = 0
          for w0 in range(0, len(rows), 16):  # a warp's 16 rows
            bv, bi = -np.inf, None
            for j in range(w0, min(w0 + 16, len(rows))):
              if bi is None or _better(v[ti, j], rows[j], bv, bi):
                bv, bi = v[ti, j], rows[j]
            best = max(best, pair_key(bv, int(bi)))
          pmax[m_i, tile], pidx[m_i, tile] = key_pair(best)
  ids = np.zeros(m, np.int64)
  for m_i in range(m):
    bv, bi = -np.inf, None
    for tile in range(p['n_tiles']):
      if bi is None or _better(pmax[m_i, tile], pidx[m_i, tile], bv, bi):
        bv, bi = pmax[m_i, tile], pidx[m_i, tile]
    ids[m_i] = bi
  return torch.from_numpy(ids.astype(np.int32))


def _head_case(m, n, k, packed, seed, dtype):
  """Integer-valued x in [-4, 4] (every f32 sum exact in any order) and
  ties planted inside a tile (rows 5, 6), across tiles of one block (rows
  3 and 2 tiles on, with few blocks) and across blocks (rows 3 and a
  tile on)."""
  g = np.random.default_rng(seed)
  x = torch.from_numpy(g.integers(-4, 5, (m, k)).astype(F32)).to(dtype)
  lo, hi = (-8, 8) if packed else (-127, 128)
  w = g.integers(lo, hi, (n, k)).astype(np.int8)
  s = (g.random(n) * 0.01 + 0.005).astype(F32)
  rows = wo_plan(m, n, k, packed)['rows']
  for a, b_, sc in ((5, 6, 2.0), (3, rows + 3, 3.0), (3, 2 * rows + 3, 3.0)):
    w[b_] = w[a]
    s[a] = s[b_] = sc
  w = torch.from_numpy(w)
  return x, (pq.pack_int4_split(w) if packed else w), torch.from_numpy(s)


@pytest.mark.parametrize('packed', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m', [1, 7, 64, 100, 200, 300])
def test_head_wo_twin_is_the_plain_argmax(m, dtype, packed):
  """N 700 (a ragged last tile), K 256, two blocks (persistent: a block
  takes several tiles), true_n N and N - 150: the twin's ids are
  head_argmax_plain's, ties to the first index."""
  n, k = 700, 256
  x, w, s = _head_case(m, n, k, packed, seed=m + 3 * packed, dtype=dtype)
  for true_n in (None, n - 150):
    got = head_wo_twin(x, w, s, packed, true_n, sms=2)
    want = head.head_argmax_plain(x, w, s, packed=packed, true_n=true_n,
                                  drq=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize('packed,k', [(True, 384), (False, 192)])
def test_head_wo_twin_at_a_k_of_odd_steps(packed, k):
  """K of three 64-byte steps: the last stage's second step lies past K
  (zeros from TMA); the ids are still the plain version's."""
  for m in (7, 100):
    x, w, s = _head_case(m, 700, k, packed, seed=k + m, dtype=torch.bfloat16)
    p = wo_plan(m, 700, k, packed)
    assert p['steps'] * p['sub'] >= (k // 2 if packed else k) // STEP
    got = head_wo_twin(x, w, s, packed, 600, sms=2)
    assert torch.equal(got, head.head_argmax_plain(
        x, w, s, packed=packed, true_n=600, drq=False))


def test_head_wo_ties_go_to_the_first_index():
  """Two equal best rows in one tile, in two tiles of one block, and in
  two blocks: the first wins every row."""
  m, n, k = 5, 700, 256
  for packed in (True, False):
    for a, b_ in ((5, 6), (3, 515), (3, 259)):
      x = torch.ones((m, k), dtype=torch.bfloat16)
      w = np.zeros((n, k), np.int8)
      w[a] = w[b_] = 2
      s = np.full(n, 0.01, F32)
      w_t = torch.from_numpy(w)
      wq = pq.pack_int4_split(w_t) if packed else w_t
      got = head_wo_twin(x, wq, torch.from_numpy(s), packed, sms=2)
      assert got.tolist() == [a] * m


def test_head_wo_plans_at_the_head_shapes():
  """N 256128, K 2048: every configuration's ring keeps at least two
  stages and fits the block's shared memory beside its static keys; the
  pairs fit the wrapper's scratch of N / 128 columns; M 64 takes one pass
  of four warpgroups over 256-row tiles, M 256 two passes of 128 tokens
  over 128-row tiles (the second from L2: a tile's 128 KB of packed
  weights just read); no tile or box passes TMA's 256 rows."""
  n, k = 256128, 2048
  for packed in (True, False):
    for m in (1, 64, 65, 128, 129, 256, 300):
      p = wo_plan(m, n, k, packed)
      assert p['stages'] >= 2, (m, packed)
      assert p['smem'] + p['static'] + 256 <= 232448
      assert p['n_tiles'] <= -(-n // head._HEAD_BN)
      assert p['blocks'] == H100_SMS
      assert p['rows'] <= 256 and p['tok'] <= 256  # TMA's box limit
    assert wo_plan(64, n, k, packed)['passes'] == 1
    assert wo_plan(256, n, k, packed)['passes'] == 2
    assert wo_plan(64, n, k, packed)['rows'] == 256
    assert wo_plan(256, n, k, packed)['rows'] == 128 == head._HEAD_BN
  assert len(head.WO_PLAN_FIELDS) == 8
  assert 'fields[7] = p.stages;' in HEAD_SRC


# ------------------------------------------------------------ sources


def _code(src):
  return re.sub(r'//[^\n]*', '', src)


def test_qkv_rope_runs_on_the_cores():
  """DRQ: the norm ending in the codes, then the int8 core's pair tile
  (kQkvRope) as a dependent launch, or its column tile and the RoPE
  launch; weight-only bf16 x: the norm, then the bf16 core's pair policy;
  f32 x: SIMT. No SIMT DRQ tile and no mma.sync tile remain."""
  code = _code(QKV_SRC)
  for header in ('mlp_int4_drq.cuh', 'int4_bf16_tc_gemm.cuh', 'norm_rows.cuh',
                 'qmatmul_int4_simt.cuh'):
    assert f'#include "{header}"' in code, header
  for call in ('aeqt::launch_rmsnorm_quant_rows<T>(',
               'mlp::launch_gemm<mlp::kQkvRope, T>(',
               'tc::launch_gemm<B, T>(', 'w4::run<w4::QkvRopePairs>(',
               'w4::run<w4::ChannelScaleAfterNorm>(',
               'aeqt::launch_rmsnorm_rows<T, false>(',
               'aeqt::qmatmul_int4_wo_kernel<float, float>'):
    assert call in code, call
  for gone in ('qmatmul_int4_drq.cuh', 'qmatmul_int4_weight_only.cuh',
               'launch_qmatmul', 'launch_wo', '__dp4a', 'mma.sync'):
    assert gone not in code, gone
  # The pair tiles' epilogues round the projection before the rotation.
  rope = re.search(r'else if constexpr \(kKind == kQkvRope\) \{(.*?)\n      \}'
                   r' else \{', MLP_HDR, re.S).group(1)
  assert rope.index('x1[e] = aeqt::round_to(tag, x1[e]);') < rope.index(
      'y1[e] = x1[e] * cs[e] - x2[e] * sn[e];')
  assert 'head < ep.NQ + ep.NK' in rope
  w4_rope = re.search(r'else if constexpr \(P::kRope\) \{(.*?)\n  \} else \{',
                      W4_CORE, re.S).group(1)
  assert w4_rope.index('__float2bfloat16_rn(a1 * sc[e])') < w4_rope.index(
      'y1[e] = x1 * cs[e] - x2 * sn[e];')
  pairs = re.search(r'struct QkvRopePairs : ChannelScale \{(.*?)\n\};',
                    W4_CORE, re.S).group(1)
  assert 'kDependent = true' in pairs and 'kRope = true' in pairs
  assert 'griddepcontrol.launch_dependents' in NORM_HDR
  assert 'rmsnorm_quant_rows_kernel<T><<<M, kNormThreads, 0, stream>>>' in (
      NORM_HDR)


def test_head_weight_only_runs_on_the_bf16_core():
  """The weight-only branch: a persistent wgmma grid over the vocab tiles
  with the argmax epilogue, the weights widened in registers; no mma.sync
  tile remains, and no atomic."""
  code = _code(HEAD_SRC)
  assert '#include "int4_bf16_tc_gemm.cuh"' in code
  assert 'head_wo_kernel' in code and 'w4::wgmma_rs<64>(' in code
  # One accumulator a (row tile, token tile): lo then hi of each window
  # (the twin's order), a stage's K steps in order.
  assert 'w4::wgmma_rs<64>(d[r], alo[u][c], dlo);' in code
  assert 'w4::wgmma_rs<64>(d[r], ahi[u][c], dhi);' in code
  assert 'w4::a_frags(' in code and 'w4::a_frags_int8(' in code
  for gone in ('qmatmul_int4_weight_only.cuh', 'head_tiles_bf16_kernel',
               'wo_mma_tile', 'kMmaNT', 'mma.sync', 'atomic'):
    assert gone not in code, gone
  assert code.count('head_reduce_kernel<<<') == 2
  assert head._HEAD_BN == min(int(g) for g in _WO_WGS.groups()) * WO_ROWS


def test_the_duplicate_tiles_are_gone():
  """The SIMT DRQ tiles and the mma.sync weight-only tiles lost their last
  users: the headers are gone and no source names them."""
  for name in ('qmatmul_int4_drq.cuh', 'qmatmul_int4_weight_only.cuh'):
    assert not (CSRC / name).exists(), name
  for src in CSRC.iterdir():
    text = src.read_text()
    for name in ('qmatmul_int4_drq.cuh', 'qmatmul_int4_weight_only.cuh'):
      assert f'#include "{name}"' not in text, (src.name, name)
  assert 'qmatmul_int4_weight_only' in _build.SOURCES  # #12's .cu stays
