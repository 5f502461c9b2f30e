"""The GeGLU MLP (#3, `kernels/mlp.py`) on the tensor-core cores, on the
CPU, where no CUDA kernel runs: numpy twins of what its kernels do that the
plain version does not show.

  * DRQ branch (`csrc/mlp_int4_drq.cu` on `int8_tc_gemm.cuh`): the gate/up
    tile that carries 64 gate rows and the 64 up rows of the same columns
    (two TMA boxes), so that h forms from the two halves of one int32
    tile; hs and hq from the group's h in any order of the maximum; the
    down's group-split loader (a stage's codes at P + g*bf/2 and that +
    bf/2) with the int32 sum flushed into f32 at each group's end, in
    group order: the plain version bit for bit, at ragged M.
  * Weight-only branch, bf16 x (`csrc/mlp_int4_bf16.cu` on
    `int4_bf16_tc_gemm.cuh`, policies GateUpScale and GroupSum): the
    loader's coordinates exact on integer operands, and the split-order
    combine of the down's group sums within the plain version's bound.
  * The plans of both, with the constants read from the sources, at the
    server's shapes (M 1, 64, 256, 1024; bf 512, 2048).
  * Each twin against interpret-mode Pallas `mlp_pallas_int4_packed`
    compiled with XLA's excess precision off, gelu and silu.
  * The sources: both routes contract on the cores (no SIMT dot, no
    mma.sync tile; f32 x of the weight-only branch keeps the SIMT tiles),
    and #22 (`csrc/attention_int8_basic.cu`) launches the split lengths
    form, keeping the one-block body for the shapes the core refuses.

The JAX parity of the wrappers stays in `test_torch_port_kernels.py` and
`test_torch_port_default_mode.py`; the card runs the kernels against their
plain versions in `chip_smoke.py`.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_mlp
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq

CSRC = pathlib.Path(_build.CSRC)
INT8_CORE = (CSRC / 'int8_tc_gemm.cuh').read_text()
BF16_CORE = (CSRC / 'int4_bf16_tc_gemm.cuh').read_text()
# The DRQ branch's entry points, then its kernels (shared with #5).
DRQ_SRC = ((CSRC / 'mlp_int4_drq.cu').read_text()
           + (CSRC / 'mlp_int4_drq.cuh').read_text())
BF16_SRC = (CSRC / 'mlp_int4_bf16.cu').read_text()
BASIC_SRC = (CSRC / 'attention_int8_basic.cu').read_text()
H100_SMS = 132
SMEM_OPTIN = 232448  # opt-in dynamic shared memory of a block on the H100


def _const(text, name):
  found = re.search(rf'constexpr (?:int|size_t) {name} = ([0-9 *+-]+);', text)
  assert found, name
  return int(eval(found.group(1)))  # a literal integer expression


BK, BN, WG_ROWS, MAX_STAGES = (_const(INT8_CORE, n) for n in
                               ('kBK', 'kBN', 'kWgRows', 'kMaxStages'))
INT8_BUDGET = _const(INT8_CORE, 'kSmemBudget')
GATE_COLS, DOWN_ONE_WG_ROWS, MAX_CHAIN, GATE_UP_STAGES_1 = (
    _const(DRQ_SRC, n) for n in ('kGateCols', 'kDownOneWgRows', 'kMaxChain',
                                 'kGateUpStages1'))
STEP_BYTES, W4_MAX_STAGES, W4_MAX_SPLIT, W4_MIN_SPLIT, NT1 = (
    _const(BF16_CORE, n) for n in ('kStepBytes', 'kMaxStages', 'kMaxSplit',
                                   'kMinSplitSteps', 'kNT1'))
W4_BUDGET = _const(BF16_CORE, 'kSmemBudget')
W4_HALF = _const(BF16_CORE, 'kSmemHalf')


def _bits(t):
  return t.view(torch.int32) if t.dtype == torch.float32 else t.view(
      torch.int16)


def _case(seed, m, d, f, bf, dtype=torch.float32, integer_x=False):
  g = torch.Generator().manual_seed(seed)
  if integer_x:
    x = torch.randint(-4, 5, (m, d), generator=g).to(dtype)
  else:
    x = torch.randn((m, d), generator=g).to(dtype)
  wgu = torch.randint(-8, 8, (2 * f, d), generator=g).to(torch.int8)
  wd = torch.randint(-8, 8, (d, f), generator=g).to(torch.int8)
  s_gu = torch.rand((2 * f,), generator=g) * 0.02 + 0.01
  s_d = torch.rand((d,), generator=g) * 0.02 + 0.01
  return (x, pq.pack_int4_split(wgu), s_gu,
          mlp.pack_int4_split_grouped(wd, bf), s_d)


def _box(a, r0, c0, rows, cols):
  """A TMA box: rows x cols of `a` at (r0, c0), zeros past its edges."""
  out = torch.zeros((rows, cols), dtype=a.dtype)
  r = a[r0:r0 + rows, c0:c0 + cols]
  out[:r.shape[0], :r.shape[1]] = r
  return out


def _unpack_tile(packed):
  """A packed [rows, w] tile -> (lo, hi) int64 [rows, w]: the nibbles of
  its bytes, sign-extended (the core's unpack)."""
  both = pq.unpack_int4_split(packed).to(torch.int64)
  w = packed.shape[1]
  return both[:, :w], both[:, w:]


# ------------------------------------------------------------ DRQ branch twin


def _drq_gate_up_h(x, wgu_p, s_gu, act):
  """Contraction 2: per tile of GATE_COLS columns f0, the B tile's gate
  rows f0.. and up rows F + f0.. (two boxes), stages of BK packed bytes
  with the codes at kb and D/2 + kb; the epilogue's h from the halves."""
  two_f, d2 = wgu_p.shape
  f, d = two_f // 2, 2 * d2
  xq, xs = pq.quantize_rows_drq(x.to(torch.float32))
  xq = xq.to(torch.int64)
  act_f = mlp.activation(act)
  h = torch.empty((x.shape[0], f), dtype=torch.float32)
  steps = -(-d2 // BK)
  for f0 in range(0, f, GATE_COLS):
    acc = torch.zeros((x.shape[0], 2 * GATE_COLS), dtype=torch.int64)
    for i in range(steps):
      b = torch.cat([_box(wgu_p, f0, i * BK, GATE_COLS, BK),
                     _box(wgu_p, f + f0, i * BK, GATE_COLS, BK)])
      lo, hi = _unpack_tile(b)
      acc += _box(xq, 0, i * BK, xq.shape[0], BK) @ lo.T
      acc += _box(xq, 0, d2 + i * BK, xq.shape[0], BK) @ hi.T
    assert int(acc.abs().max()) < 2**31
    cols = slice(f0, f0 + GATE_COLS)
    gate = (acc[:, :GATE_COLS].to(torch.float32) * xs) * s_gu[cols]
    up = (acc[:, GATE_COLS:].to(torch.float32) * xs) * s_gu[f:][cols]
    h[:, cols] = act_f(gate) * up
  return h


def _hquant(h, bf, chunks=8):
  """Contraction 3: a group's absmax as the maximum of per-chunk maxima
  (the block's threads and warps, in another order), hs, hq."""
  m, f = h.shape
  g = h.reshape(m, f // bf, chunks, bf // chunks)
  amax = torch.amax(torch.amax(torch.abs(g), dim=3), dim=2)
  hs = torch.clamp_min(amax, 1e-9) * np.float32(1.0 / 127.0)
  inv = torch.reciprocal(hs)
  hq = torch.round(h.reshape(m, f // bf, bf) * inv[..., None]).to(torch.int8)
  return hq.reshape(m, f), hs


def _drq_down(hq, hs, wd_g, s_d, bf):
  """Contraction 4: stages of BK packed bytes; stage i of group g reads
  the codes at i*BK + g*bf/2 (lo) and that + bf/2 (hi); at the group's
  end acc += f32(part) * hs[:, g], in group order."""
  m, f = hq.shape
  group_steps = bf // 2 // BK
  hq = hq.to(torch.int64)
  acc = torch.zeros((m, wd_g.shape[0]), dtype=torch.float32)
  part = torch.zeros((m, wd_g.shape[0]), dtype=torch.int64)
  for i in range(f // 2 // BK):
    g = i // group_steps
    lo_col = i * BK + g * (bf // 2)
    lo, hi = _unpack_tile(wd_g[:, i * BK:(i + 1) * BK])
    part += hq[:, lo_col:lo_col + BK] @ lo.T
    part += hq[:, lo_col + bf // 2:lo_col + bf // 2 + BK] @ hi.T
    if (i + 1) % group_steps == 0:
      assert int(part.abs().max()) < 2**24  # f32(part) is exact
      acc = acc + part.to(torch.float32) * hs[:, g:g + 1]
      part.zero_()
  return acc * s_d


def _drq_twin(x, wgu_p, s_gu, wd_g, s_d, bf, act='gelu'):
  h = _drq_gate_up_h(x, wgu_p, s_gu, act)
  hq, hs = _hquant(h, bf)
  y = _drq_down(hq, hs, wd_g, s_d, bf)
  return y.to(pq.compute_dtype(x)).to(x.dtype)


@pytest.mark.parametrize('m,d,f,bf', [(5, 512, 2048, 256), (7, 256, 2048, 512),
                                      (66, 512, 4096, 2048),
                                      (1, 256, 1024, 512)])
def test_drq_twin_is_the_plain_version_bit_for_bit(m, d, f, bf):
  x, wgu_p, s_gu, wd_g, s_d = _case(m + bf, m, d, f, bf, torch.bfloat16)
  got = _drq_twin(x, wgu_p, s_gu, wd_g, s_d, bf)
  want = mlp.mlp_int4_packed_plain(x, wgu_p, s_gu, wd_g, s_d, bf=bf)
  assert torch.equal(_bits(got), _bits(want))


def _drq_down_chain(hq, hs, wd_g, s_d, bf, chain):
  """The down's chain: group g's f32 product P[g] = f32(part) * hs[:, g]
  formed by block g % chain of a tile's cluster on its own, the running
  sum R[g] = R[g - 1] + P[g] (R[-1] = 0) passed from block to block in
  group order; the block of the last group scales it by s_d."""
  m, f = hq.shape
  groups = f // bf
  wd = mlp.unpack_int4_split_grouped(wd_g, bf).to(torch.int64)
  blocks = [dict() for _ in range(chain)]
  for z in range(chain):  # each block's groups, in its own order
    for g in range(z, groups, chain):
      cols = slice(g * bf, (g + 1) * bf)
      part = hq[:, cols].to(torch.int64) @ wd[:, cols].T
      assert int(part.abs().max()) < 2**24  # f32(part) is exact
      blocks[z][g] = part.to(torch.float32) * hs[:, g:g + 1]
  r = torch.zeros((m, wd_g.shape[0]), dtype=torch.float32)
  for g in range(groups):  # the message round the chain
    r = r + blocks[g % chain][g]
  return r * s_d


@pytest.mark.parametrize('chain,bf', [(1, 512), (3, 256), (6, 512),
                                      (8, 2048)])
def test_drq_down_chain_keeps_the_group_order(chain, bf):
  """Round-robin groups over a cluster's blocks with the running sum
  passed in group order: the sequential flush bit for bit."""
  x, wgu_p, s_gu, wd_g, s_d = _case(chain, 9, 256, 4096, bf)
  hq, hs = _hquant(_drq_gate_up_h(x, wgu_p, s_gu, 'gelu'), bf)
  want = _drq_down(hq, hs, wd_g, s_d, bf)
  got = _drq_down_chain(hq, hs, wd_g, s_d, bf, chain)
  assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize('bf', [256, 512, 2048])
def test_drq_hs_and_hq_from_the_group_in_any_order(bf):
  """The plain version's hs and hq bit for bit from the tiles' h, the
  maximum taken over chunks of the group (the block's order)."""
  x, wgu_p, s_gu, _, _ = _case(bf, 9, 256, 4096, bf)
  h = _drq_gate_up_h(x, wgu_p, s_gu, 'gelu')
  hq, hs = _hquant(h, bf, chunks=16)
  for t in range(h.shape[1] // bf):
    want_q, want_s = pq.quantize_rows_drq(h[:, t * bf:(t + 1) * bf])
    assert torch.equal(hq[:, t * bf:(t + 1) * bf], want_q)
    assert torch.equal(_bits(hs[:, t:t + 1].contiguous()), _bits(want_s))


@pytest.mark.parametrize('bf', [256, 512, 2048])
def test_drq_down_loader_reads_the_group_split_layout(bf):
  """The loader's codes for stage i of group g, columns i*BK + g*bf/2 (lo
  nibbles) and that + bf/2 (hi), contract to the same int32 partial per
  group as `unpack_int4_split_grouped`'s columns; a split-half loader
  (hi at K/2 + i*BK) does not."""
  m, d, f = 6, 128, 4096
  g = torch.Generator().manual_seed(bf)
  hq = torch.randint(-127, 128, (m, f), generator=g).to(torch.int8)
  wd = torch.randint(-8, 8, (d, f), generator=g).to(torch.int8)
  wd_g = mlp.pack_int4_split_grouped(wd, bf)
  np.testing.assert_array_equal(
      mlp.unpack_int4_split_grouped(wd_g, bf).numpy(), wd.numpy())
  hs = torch.ones((m, f // bf))
  want = torch.zeros((m, d), dtype=torch.float32)
  for t in range(f // bf):
    cols = slice(t * bf, (t + 1) * bf)
    part = hq[:, cols].to(torch.int64) @ wd[:, cols].to(torch.int64).T
    want = want + part.to(torch.float32)
  got = _drq_down(hq, hs, wd_g, torch.ones(d), bf)
  assert torch.equal(got, want)
  # The split-half coordinates are another function of the same bytes.
  lo, hi = _unpack_tile(wd_g)
  wrong = (hq[:, :f // 2].to(torch.int64) @ lo.T
           + hq[:, f // 2:].to(torch.int64) @ hi.T)
  assert not torch.equal(wrong.to(torch.float32), want)


def test_split_unpack_every_byte():
  """The int8 core's `unpack_split_tile`, which both contractions of the
  DRQ MLP and the core's own SplitNibbles (#1, #6) run: n | ((n &
  0x08080808) * 0x1E) on the words of nibbles (w & 0x0F0F0F0F, (w >> 4) &
  0x0F0F0F0F) equals `unpack_int4_split` (and nib_lo / nib_hi) on every
  byte value, four bytes a word."""
  core = _strip_comments(INT8_CORE)
  assert 'return n | ((n & 0x08080808u) * 0x1Eu);' in core
  assert 'sign_extend_nibbles(w[e] & 0x0F0F0F0Fu)' in core
  assert 'sign_extend_nibbles((w[e] >> 4) & 0x0F0F0F0Fu)' in core
  assert 'unpack_split_tile(st + 2 * (size_t)bm * kBK, lo, consumers);' in core
  packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
  words = packed.view(np.uint32).astype(np.uint64)
  def ext(n):
    return ((n | ((n & 0x08080808) * 0x1E)) & 0xFFFFFFFF).astype(np.uint32)
  lo = ext(words & 0x0F0F0F0F).view(np.int8).reshape(1, 256)
  hi = ext((words >> 4) & 0x0F0F0F0F).view(np.int8).reshape(1, 256)
  want = pq.unpack_int4_split(torch.from_numpy(packed)).numpy()
  np.testing.assert_array_equal(np.concatenate([lo, hi], axis=1), want)


# ------------------------------------------------- weight-only branch twin


def _w4_plan(m, n, k, bs, gate_up, grouped, sms=H100_SMS):
  """int4_bf16_tc_gemm.cuh make_plan for GateUpScale (gate_up: no split)
  and GroupSum (grouped: bs = bf/2 bytes a group, split in whole
  groups)."""
  wgs = 1 if m <= NT1 else 2
  nt = NT1 if wgs == 1 else (128 if gate_up else 64)
  rows = 64 * wgs
  m_tiles, n_tiles = -(-m // nt), -(-n // rows)
  steps = k // 2 // STEP_BYTES
  unit = bs // STEP_BYTES if grouped else 1
  units = steps // unit
  min_units = max(1, W4_MIN_SPLIT // unit)
  sms = 2 * sms if grouped and wgs == 1 else sms  # two blocks an SM
  want = 1 if gate_up else max(1, min(units // min_units,
                                      sms // (m_tiles * n_tiles),
                                      W4_MAX_SPLIT))
  per = -(-units // want)
  split = -(-units // per)
  return dict(wgs=wgs, nt=nt, rows=rows, m_tiles=m_tiles, n_tiles=n_tiles,
              steps=steps, unit=unit, split=split, steps_per_split=per * unit)


def _w4_gate_up(x, wgu_p, s_gu, act, m_total):
  """GateUpScale: a block's weight tile is rows/2 gate rows and the up
  rows of the same columns; lo and hi f32 sums over the steps (x tiles at
  j0 and D/2 + j0); h = bf16(act((lo + hi) * s_g) * ((lo + hi) * s_u))."""
  two_f, d2 = wgu_p.shape
  f = two_f // 2
  p = _w4_plan(m_total, two_f, 2 * d2, 0, True, False)
  half = p['rows'] // 2
  xf = x.to(torch.float32)
  act_f = mlp.activation(act)
  h = torch.empty((x.shape[0], f), dtype=torch.float32)
  for f0 in range(0, f, half):
    lo_acc = torch.zeros((x.shape[0], 2 * half))
    hi_acc = torch.zeros((x.shape[0], 2 * half))
    for i in range(p['steps']):
      j0 = i * STEP_BYTES
      w = torch.cat([_box(wgu_p, f0, j0, half, STEP_BYTES),
                     _box(wgu_p, f + f0, j0, half, STEP_BYTES)])
      lo, hi = _unpack_tile(w)
      lo_acc += _box(xf, 0, j0, x.shape[0], STEP_BYTES) @ lo.T.float()
      hi_acc += _box(xf, 0, d2 + j0, x.shape[0], STEP_BYTES) @ hi.T.float()
    cols = slice(f0, f0 + half)
    gate = (lo_acc[:, :half] + hi_acc[:, :half]) * s_gu[cols]
    up = (lo_acc[:, half:] + hi_acc[:, half:]) * s_gu[f:][cols]
    h[:, cols] = act_f(gate) * up
  return h.to(torch.bfloat16)


def _w4_down(h, wd_g, s_d, bf, m_total, sms=H100_SMS):
  """GroupSum: steps of STEP_BYTES packed bytes, x at j0 + g*bf/2 and that
  + bf/2; y += lo + hi at each group's end; the splits (whole groups) of
  the plan added in split order; then y * s_d."""
  d, f2 = wd_g.shape
  p = _w4_plan(m_total, d, 2 * f2, bf // 2, False, True, sms)
  hf = h.to(torch.float32)
  parts = []
  for z in range(p['split']):
    y = torch.zeros((h.shape[0], d))
    lo_acc = torch.zeros_like(y)
    hi_acc = torch.zeros_like(y)
    first = z * p['steps_per_split']
    for i in range(first, min(p['steps'], first + p['steps_per_split'])):
      j0 = i * STEP_BYTES
      x_lo = j0 + (i // p['unit']) * p['unit'] * STEP_BYTES
      lo, hi = _unpack_tile(wd_g[:, j0:j0 + STEP_BYTES])
      lo_acc += hf[:, x_lo:x_lo + STEP_BYTES] @ lo.T.float()
      x_hi = x_lo + p['unit'] * STEP_BYTES
      hi_acc += hf[:, x_hi:x_hi + STEP_BYTES] @ hi.T.float()
      if (i + 1) % p['unit'] == 0:
        y = y + (lo_acc + hi_acc)
        lo_acc.zero_()
        hi_acc.zero_()
    parts.append(y)
  acc = parts[0]
  for y in parts[1:]:
    acc = acc + y
  return (acc * s_d).to(torch.bfloat16), p['split']


def test_w4_loader_coordinates_exact_on_integer_operands():
  """On integer x, weights and unit scales every f32 sum is exact, so the
  gate/up tile's two boxes and the down's group-split x coordinates must
  give the plain contraction bit for bit (a wrong column would not)."""
  m, d, f, bf = 7, 256, 1024, 128
  x, wgu_p, _, wd_g, _ = _case(3, m, d, f, bf, torch.bfloat16, True)
  ones = torch.ones(2 * f)
  h = _w4_gate_up(x, wgu_p, ones, 'gelu', m)
  wgu = pq.unpack_int4_split(wgu_p).to(torch.float32)
  gate = x.float() @ wgu[:f].T
  up = x.float() @ wgu[f:].T
  assert torch.equal(h, (mlp.gelu_tanh(gate) * up).to(torch.bfloat16))
  hint = torch.randint(-3, 4, (m, f), generator=torch.Generator().manual_seed(
      4)).to(torch.bfloat16)
  y, split = _w4_down(hint, wd_g, torch.ones(d), bf, m)
  assert split > 1  # decode rows split K over a cluster
  wd = mlp.unpack_int4_split_grouped(wd_g, bf).to(torch.float32)
  assert torch.equal(y, (hint.float() @ wd.T).to(torch.bfloat16))


@pytest.mark.parametrize('m,bf,act', [(7, 128, 'gelu'), (64, 512, 'silu'),
                                      (70, 256, 'gelu'), (1, 512, 'gelu')])
def test_w4_twin_within_the_plain_bound(m, bf, act):
  """The gate/up and the split down, lo + hi and the splits in their own
  order: at most one bf16 ulp beyond 1e-3 of max |y| from the plain
  version, chip_smoke.py's bound for bf16 x."""
  d, f = 256, 1024
  x, wgu_p, s_gu, wd_g, s_d = _case(m + bf, m, d, f, bf, torch.bfloat16)
  h = _w4_gate_up(x, wgu_p, s_gu, act, m)
  got, _ = _w4_down(h, wd_g, s_d, bf, m, sms=4 * H100_SMS)
  want = mlp.mlp_int4_packed_plain(x, wgu_p, s_gu, wd_g, s_d, act=act,
                                   drq=False, bf=bf).float()
  ymax = float(want.abs().max())
  w = want.abs().clamp_min(2.0**-126)
  ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
  beyond = ((got.float() - want).abs() - 1e-3 * ymax).clamp_min(0) / ulp
  assert float(beyond.max()) <= 1.0


# ------------------------------------------------------------------- plans


def _drq_plans(m, d, f, bf):
  """mlp_int4_drq.cu gate_up_plan / down_plan (the down's chain before the
  occupancy query, which may shorten it)."""
  def size(wgs, n_tiles, steps, chain, max_stages, buffers):
    bm = WG_ROWS * wgs
    stage = 2 * bm * BK + BN * BK
    unpack = buffers * 2 * BN * BK
    boxes = WG_ROWS * wgs * BN * 4 if chain > 1 else 0  # the f32 inbox
    stages = min(max_stages, (INT8_BUDGET - 1024 - unpack - boxes) // stage)
    stages = min(stages, max(steps, 2))
    return dict(wgs=wgs, m_tiles=-(-m // bm), n_tiles=n_tiles, steps=steps,
                chain=chain, stages=stages,
                smem=1024 + stages * stage + unpack + boxes,
                ring=stages * stage)
  wgs = 1 if m <= WG_ROWS else 2
  gu = size(wgs, -(-f // GATE_COLS), -(-d // 2 // BK), 1,
            GATE_UP_STAGES_1 if wgs == 1 else MAX_STAGES, 1 if wgs == 1 else 2)
  wgs = 1 if m <= DOWN_ONE_WG_ROWS else 2
  tiles = -(-m // (WG_ROWS * wgs)) * -(-d // BN)
  chain = max(1, min(H100_SMS // tiles, MAX_CHAIN, f // bf))
  dn = size(wgs, -(-d // BN), f // 2 // BK, chain, MAX_STAGES, 2)
  return gu, dn


@pytest.mark.parametrize('m', [1, 64, 256, 1024])
@pytest.mark.parametrize('bf', [512, 2048])
def test_plans_at_the_server_shapes(m, bf):
  d, f = 2048, 16384
  gu, dn = _drq_plans(m, d, f, bf)
  assert gu['n_tiles'] == f // GATE_COLS and gu['steps'] == d // 2 // BK
  assert dn['n_tiles'] == d // BN and dn['steps'] * BK * 2 == f
  for p in (gu, dn):
    assert 2 <= p['stages'] <= MAX_STAGES
    assert p['smem'] <= SMEM_OPTIN - 1024
    # The epilogue's staged tile and the row scales fit the ring, which
    # every stage has left by then.
    assert WG_ROWS * p['wgs'] * ((BN + 8) * 4 + 4) <= p['ring']
  if gu['wgs'] == 1:  # two blocks an SM: 256 tiles at decode in one wave
    assert 2 * (gu['smem'] + 1024) <= 233472
  assert (bf // 2) % BK == 0  # whole stages a group: the flush points
  assert gu['m_tiles'] * gu['n_tiles'] >= H100_SMS  # no split needed
  # The chain: decode rows take a cluster of blocks a tile, prefill none.
  assert (dn['chain'] > 1) == (m <= 256)
  assert dn['chain'] <= min(MAX_CHAIN, f // bf)
  # Weight-only branch, bf16 x.
  g = _w4_plan(m, 2 * f, d, 0, True, False)
  dn4 = _w4_plan(m, d, f, bf // 2, False, True)
  assert g['split'] == 1 and g['n_tiles'] == 2 * f // g['rows']
  assert dn4['steps_per_split'] % dn4['unit'] == 0  # whole groups a split
  assert dn4['split'] <= W4_MAX_SPLIT
  assert (dn4['split'] > 1) == (m <= 256)


def test_plan_fields_match_the_sources():
  assert len(mlp.DRQ_PLAN_FIELDS) == 12
  assert 'fields + 6 * i' in DRQ_SRC
  assert len(mlp.BF16_PLAN_FIELDS) == 14 and 'fields + 7' in BF16_SRC


# ----------------------------------------------- against interpret Pallas


def _exact(fn):
  """fn compiled with XLA's excess precision off (its bf16 roundings
  kept), its array arguments traced."""
  def call(*args, **kw):
    return jax.jit(lambda *a: fn(*a, **kw)).lower(*args).compile(
        compiler_options={'xla_allow_excess_precision': False})(*args)
  return call


@pytest.mark.parametrize('drq,act,dtype', [
    (True, 'gelu', torch.bfloat16), (True, 'silu', torch.float32),
    (False, 'gelu', torch.bfloat16), (False, 'silu', torch.bfloat16)])
def test_twins_match_interpret_pallas(drq, act, dtype):
  """The twins against `mlp_pallas_int4_packed` in interpret mode: DRQ
  within 1e-3 of max |y| (XLA's tanh or logistic and torch's differ by an
  ulp, which may flip one hidden code); weight-only, bf16 x, within 4e-3
  (test_torch_port_default_mode.py's bound: a bf16 hidden value may round
  the other way)."""
  m, d, f, bf = 8, 256, 1024, 256 if drq else 512
  x, wgu_p, s_gu, wd_g, s_d = _case(11 + drq, m, d, f, bf, dtype)
  jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
  j = lambda t: jnp.asarray(t.float().numpy() if t.is_floating_point()
                            else t.numpy())
  want = np.asarray(_exact(pallas_mlp.mlp_pallas_int4_packed)(
      j(x).astype(jdt), j(wgu_p), j(s_gu), j(wd_g), j(s_d), act=act,
      drq=drq, bf=bf, interpret=True).astype(jnp.float32))
  if drq:
    got = _drq_twin(x, wgu_p, s_gu, wd_g, s_d, bf, act)
    tol = 1e-3
  else:
    got, _ = _w4_down(_w4_gate_up(x, wgu_p, s_gu, act, m), wd_g, s_d, bf, m)
    tol = 4e-3
  got = got.float().numpy()
  assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


# ------------------------------------------------------------------ sources


def _strip_comments(src):
  return re.sub(r'//[^\n]*', '', src)


def test_drq_route_runs_on_the_int8_core():
  code = _strip_comments(DRQ_SRC)
  assert '#include "int8_tc_gemm.cuh"' in code
  assert 'qmatmul_int4_drq.cuh' not in code  # no SIMT tile
  assert not (CSRC / 'qmatmul_int4_drq.cuh').exists()  # nor its header
  assert '__dp4a' not in code and 'dot_packed' not in code
  assert 'tc::wgmma_stage(' in code and 'SplitNibblesRecipB' in code
  # One unpack: the core's, no copy of it here.
  assert 'tc::unpack_split_tile(' in code
  assert 'nib_lo' not in code and '0x0F0F0F0F' not in code
  # A stage of the down (BK packed bytes) lies in one group only where bf %
  # (2 * BK) == 0; the entry point refuses the others before any launch
  # (the TPU kernel's (d, bf/2) block needs bf/2 % 128 == 0 as well).
  assert 2 * BK == 256 and 'bf % 256 == 0' in code
  entry = code[code.index('extern "C" int aeqt_mlp_int4_drq('):]
  assert entry.index('if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;') \
      < entry.index('launch_all<')
  # With one unpack buffer (the gate/up at one warpgroup) every warp's
  # wgmma of a step ends before the next step unpacks into the buffer.
  assert ('if ((overlap || unpack_buffers == 1) && i + 1 < nk)\n'
          '      tc::bar_sync(1, consumers);') in code
  assert 'launch_quantize<Loader' in code
  # The group sum runs in group order: a tile's running sum goes from
  # block to block of its cluster (stores into the next block's inbox),
  # with no float atomics and no global scratch.
  assert 'atomic' not in code
  assert 'st.async.shared::cluster.mbarrier::complete_tx' in code
  assert 'acc[k] = acc[k] + (float)d[k] * hs_row[(k >> 1) & 1];' in code


def test_bf16_route_runs_on_the_bf16_core():
  code = _strip_comments(BF16_SRC)
  assert '#include "int4_bf16_tc_gemm.cuh"' in code
  assert 'qmatmul_int4_weight_only.cuh' not in code  # no mma.sync tile
  assert not (CSRC / 'qmatmul_int4_weight_only.cuh').exists()
  assert 'run_nb<aeqt::w4::GateUpScale>' in code
  assert 'run<aeqt::w4::GroupSum>' in code
  # f32 x keeps the SIMT tiles, and only f32 x reaches them.
  body = code[code.index('extern "C" int aeqt_mlp_int4_bf16('):]
  assert body.index('if (!x_bf16)') < body.index('launch_f32(')
  core = _strip_comments(BF16_CORE)
  assert 'struct GateUpScale' in core and 'struct GroupSum' in core


def test_int8_basic_launches_the_split_lengths_form():
  """#22 is #7's launch (attention_lengths.cuh aeqt::lengths) at f32 with
  zero points 0: the split core's lengths form, the one-block body only
  where the core refuses the shape."""
  code = _strip_comments(BASIC_SRC)
  header = _strip_comments((CSRC / 'attention_lengths.cuh').read_text())
  assert '#include "attention_lengths.cuh"' in code
  assert '#include "attention_split_tc.cuh"' in header
  assert 'split::attend<split::kLengths, C, H, NTS>(a)' in header
  assert 'split::takes(split::kLengths, C, R, G, S, H)' in header
  entry = code[code.index('extern "C" int aeqt_attention_int8_basic('):]
  entry = entry[:entry.index('\n}\n')]
  assert 'aeqt::lengths::launch<aeqt::kF32>(' in entry
  assert '0.0f,\n      0.0f' in entry  # both zero points
  launch = header[header.index('int launch(const void* q'):]
  launch = launch[:launch.index('\n}\n')]
  # The one-block body only where the core refuses the shape.
  assert launch.index('if (kernel == nullptr)') < launch.index(
      'launch_lengths_attention')
  assert 'split::launch(kernel' in launch
