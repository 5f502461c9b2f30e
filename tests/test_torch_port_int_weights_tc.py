"""The weight-only integer matmul (#16, `int_qmatmul.qmatmul_int_weights`,
`csrc/qmatmul_int_weights.cu`) on the bf16 tensor cores, on the CPU, where
no CUDA kernel runs: numpy twins of what the kernel does that the plain
version does not show.

  * The int8 widening (`widen_pair`: 0x4300 | (b & 0x7F) less 0x4300 |
    (b & 0x80), a bf16 difference) is every signed byte exactly, over all
    256 byte values; the 0x4300 | nibble trick of the int4 core would not
    be (it covers 7 bits).
  * The weights' A fragments (`window_bytes`, `a_frags`): each thread's four
    bytes of a k16 window of its two rows, widened and placed by wgmma's
    register-fragment map, give back the row-major int8 tile.
  * The three bf16 parts of an f32 x (`split_x_kernel`: the high 16 bits,
    then those of the rest, twice) sum to x bit for bit: random normals,
    tiny and huge values, values at bf16 ties, signed zeros.
  * The launch plan (warpgroups, tokens a tile, split-K in whole stages or
    whole blocks, ring stages; the constants read from the source) and the
    f32 sums it schedules: per block of bs columns, its k16 windows' exact
    products summed from zero part by part (the smallest part first), y +
    p * s in block order within a split, the splits' partial y added in
    split order (channelwise: the splits' dots added, then scaled); then
    the bias. At bs 32, 64, 128 and channelwise, with and without a bias,
    bf16 and f32 x, within the unchanged `int_weights_tolerance` of the
    plain version and of interpret-mode Pallas `qmatmul_pallas`.
  * The sources: the entry point runs wgmma fed by a TMA ring; the SIMT
    tile is gone; the wrapper passes bf16 x as it is.

The card runs the kernel against its plain version in `chip_smoke.py`.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul

CSRC = pathlib.Path(_build.CSRC)
SOURCE = (CSRC / 'qmatmul_int_weights.cu').read_text()
CORE = (CSRC / 'int4_bf16_tc_gemm.cuh').read_text()
H100_SMS = 132


def _const(name, text=SOURCE):
  found = re.search(rf'constexpr (?:int|size_t) {name} = ([0-9 *+-]+);', text)
  assert found, name
  return int(eval(found.group(1)))  # a literal integer expression


STEP_K, MIN_SPLIT_STEPS, NT1, NT2, X_PARTS, MAX_STAGES = (
    _const(n) for n in ('kStepK', 'kMinSplitSteps', 'kNT1', 'kNT2',
                        'kXPartsF32', 'kMaxStages'))
WG_ROWS, MAX_SPLIT = (_const(n, CORE) for n in ('kWgRows', 'kMaxSplit'))
SMEM_BUDGET, SMEM_HALF = (_const(n, CORE) for n in ('kSmemBudget',
                                                    'kSmemHalf'))
SMEM_SM, SMEM_BLOCK = (int(eval(v)) for v in re.search(
    r'constexpr size_t kSmemSm = ([0-9]+), kSmemBlock = ([0-9 +]+);',
    SOURCE).groups())
CHANNEL, BS32, BLOCKS = 0, 1, 2


def test_two_block_sums_only_at_decode_rows():
  """bs 32 keeps a stage's two block sums apart only at 64 tokens; at 128
  tokens y and one sum fill the registers."""
  assert 'constexpr bool kTwoSums = P == kBs32 && NT == kNT1;' in SOURCE
  assert (NT1, NT2) == (64, 128)
  assert _plan(1024, 2048, 2048, 32, 1)['policy'] == BS32


# ------------------------------------------------------------ widening


def _bf16_to_f32(bits):
  return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


def _widen_pair(t):
  """numpy twin of widen_pair on uint32 words holding two bytes (bits 0-7
  and 16-23): the bf16 pair (low half first) as float32 [..., 2]."""
  t = np.asarray(t, np.uint32)
  a = (t & np.uint32(0x007F007F)) | np.uint32(0x43004300)
  b = (t & np.uint32(0x00800080)) | np.uint32(0x43004300)
  pa = np.stack([a & 0xFFFF, a >> 16], -1)
  pb = np.stack([b & 0xFFFF, b >> 16], -1)
  # A bf16 subtraction whose exact result is a bf16 value: no rounding.
  d = _bf16_to_f32(pa).astype(np.float64) - _bf16_to_f32(pb).astype(
      np.float64)
  out = d.astype(np.float32)
  assert np.all(_bf16_to_f32(np.asarray(out, np.float32).view(np.uint32)
                             >> np.uint32(16)) == out)  # exact in bf16
  return out


def test_widening_every_byte_value():
  b = np.arange(256, dtype=np.uint32)
  got = _widen_pair(b | (b[::-1] << np.uint32(16)))
  signed = b.astype(np.uint8).view(np.int8).astype(np.float32)
  np.testing.assert_array_equal(got[:, 0], signed)
  np.testing.assert_array_equal(got[:, 1], signed[::-1])
  assert got.min() == -128 and got.max() == 127


def test_nibble_trick_would_not_cover_a_byte():
  """The int4 core's 0x4300 | u (128 + u) is exact only for u < 128."""
  u = np.arange(256, dtype=np.uint32)
  val = _bf16_to_f32(np.uint32(0x4300) | u) - np.float32(128)
  assert np.array_equal(val[:128], u[:128].astype(np.float32))
  assert not np.array_equal(val[128:], u[128:].astype(np.float32))


# ------------------------------------------------ the operands' placement


def _window_bytes(v, q):
  """window_bytes: bytes 2q, 2q + 1, 2q + 8, 2q + 9 of a 16-byte chunk."""
  sel = [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]
  return np.frombuffer(bytes(v[sel].tobytes()), dtype=np.uint32)[0]


def _a_tile(w):
  """The A operand a warpgroup's fragments hold for each k16 window of a
  stage: [4][64 rows][16 k], from every lane's registers (a[0]: row g, k
  2q, 2q + 1; a[1]: row g + 8; a[2], a[3]: k 8 further)."""
  assert w.shape == (WG_ROWS, STEP_K)
  out = np.full((4, WG_ROWS, 16), np.nan, np.float32)
  for c in range(4):
    for warp in range(4):
      for lane in range(32):
        g, q = lane // 4, lane % 4
        for rr in (16 * warp + g, 16 * warp + g + 8):
          word = int(_window_bytes(w[rr, 16 * c:16 * c + 16], q))
          # __byte_perm(word, 0, 0x4140) and (word, 0, 0x4342).
          first = _widen_pair((word & 0xFF) | ((word >> 8 & 0xFF) << 16))
          second = _widen_pair((word >> 16 & 0xFF) | ((word >> 24) << 16))
          out[c, rr, 2 * q:2 * q + 2] = first
          out[c, rr, 2 * q + 8:2 * q + 10] = second
  return out


def test_a_fragments_give_back_the_tile():
  rng = np.random.default_rng(3)
  w = rng.integers(0, 256, (WG_ROWS, STEP_K), dtype=np.uint8)
  tile = _a_tile(w)
  signed = w.view(np.int8).astype(np.float32)
  for c in range(4):
    np.testing.assert_array_equal(tile[c], signed[:, 16 * c:16 * c + 16])


# ------------------------------------------------------- f32 x in parts


def _parts(x):
  """split_x_kernel: three bf16 parts (as float32) of float32 x."""
  r = np.asarray(x, np.float32).copy()
  parts = []
  for _ in range(X_PARTS):
    hi = (r.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    parts.append(hi)
    r = (r - hi).astype(np.float32)
  return parts


def _bf16_ties(rng, n):
  """Values halfway between two bf16 neighbours (bit 15 set, the rest of
  the low half clear), and their neighbours one f32 ulp away."""
  hi = rng.integers(0x3000, 0x4F00, n).astype(np.uint32) << np.uint32(16)
  tie = (hi | np.uint32(0x8000)).view(np.float32)
  up = (hi | np.uint32(0x8001)).view(np.float32)
  down = (hi | np.uint32(0x7FFF)).view(np.float32)
  return np.concatenate([tie, up, down, -tie])


@pytest.mark.parametrize('kind', ['randn', 'tiny', 'huge', 'ties', 'edges'])
def test_three_parts_sum_to_x(kind):
  rng = np.random.default_rng(len(kind))
  if kind == 'randn':
    x = rng.standard_normal(4096).astype(np.float32)
  elif kind == 'tiny':  # down to 2^-110, where the last part is exact
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-33, -20, 4096)
         ).astype(np.float32)
    x = x[np.abs(x) >= 2.0**-110]
  elif kind == 'huge':
    x = (rng.uniform(-1, 1, 4096) * 3.4e38).astype(np.float32)
  elif kind == 'ties':
    x = _bf16_ties(rng, 1024)
  else:
    x = np.array([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).max,
                  -np.finfo(np.float32).max, 2.0**-110, 1 + 2.0**-23],
                 np.float32)
  hi, mid, lo = _parts(x)
  for p in (hi, mid, lo):  # bf16 values: the low 16 bits clear
    assert np.all(p.view(np.uint32) & np.uint32(0xFFFF) == 0)
    assert np.all(np.isfinite(p))
  np.testing.assert_array_equal((hi + mid) + lo, x)  # in f32, and exactly
  np.testing.assert_array_equal(hi.astype(np.float64) + mid + lo,
                                x.astype(np.float64))
  assert np.all(np.abs(mid) <= np.abs(hi)) and np.all(np.abs(lo) <= np.abs(mid))


def test_two_parts_miss_a_full_mantissa():
  x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
  hi, mid, _ = _parts(x)
  assert np.mean(hi.astype(np.float64) + mid != x) > 0.9


# -------------------------------------------------------------- the plan


def _policy(bs):
  return CHANNEL if bs == 0 else (BS32 if bs == 32 else BLOCKS)


def _plan(m, n, k, bs, parts, sms=H100_SMS):
  """make_plan: dict of wgs, nt, m_tiles, n_tiles, split, per (stages a
  split), steps, stages, half_blocks, policy."""
  wgs = 1 if m <= NT1 else 2
  nt = NT1 if wgs == 1 else NT2
  policy = _policy(bs)
  m_tiles, n_tiles = -(-m // nt), -(-n // (WG_ROWS * wgs))
  steps = k // STEP_K
  half_blocks = bs // 32 if bs else 1
  unit = ((half_blocks // 2 if half_blocks % 2 == 0 else half_blocks)
          if policy == BLOCKS else 1)
  units = steps // unit
  min_units = max(1, MIN_SPLIT_STEPS // unit)
  slots = sms * (3 if wgs == 1 else 1)  # three blocks an SM at one warpgroup
  want = max(1, min(units // min_units, slots // (m_tiles * n_tiles),
                    MAX_SPLIT))
  per = -(-units // want)
  split = -(-units // per)
  stage = parts * nt * 128 + WG_ROWS * wgs * STEP_K
  budget = SMEM_HALF if wgs == 1 else SMEM_BUDGET
  stages = min(MAX_STAGES, per * unit, (budget - 1024) // stage)
  smem = 1024 + max(stages * stage, nt * (WG_ROWS * wgs + 4) * 4)
  per_sm = 1
  if wgs == 1:
    blocks = m_tiles * n_tiles * split
    waves = {b: -(-blocks // (b * sms)) for b in (2, 3)}
    three_fit = 3 * (smem + SMEM_BLOCK) <= SMEM_SM
    per_sm = 3 if three_fit and (split > 1 or waves[3] < waves[2]) else 2
    if per_sm == 2:
      smem = max(smem, SMEM_SM // 3)
  return dict(wgs=wgs, nt=nt, m_tiles=m_tiles, n_tiles=n_tiles, split=split,
              per=per * unit, steps=steps, stages=stages,
              half_blocks=half_blocks, policy=policy, smem=smem,
              per_sm=per_sm)


def test_plan_at_the_server_shapes():
  """gemma_mixed48_b32's FCs at decode (M 64: one warpgroup, two blocks an
  SM): gate/up N 32768 and the head N 256128 have tiles enough and do not
  split; the down FC (N 2048, K 16384) splits 8 ways in whole stages; the
  channelwise N 2048, K 2048 splits 8 ways. At a prefill pass's rows (M
  1024: two warpgroups, 128 tokens) nothing splits. Every ring holds at
  least two stages, f32 x's three parts too."""
  assert _plan(64, 32768, 2048, 32, 1)['stages'] == MAX_STAGES
  # Blocks an SM: gate/up's 512 tiles take two waves either way (two an
  # SM, its shared memory padded); the head's 4002 take fewer at three;
  # the split FCs' clusters take three.
  assert _plan(64, 32768, 2048, 32, 1)['per_sm'] == 2
  assert 3 * (_plan(64, 32768, 2048, 32, 1)['smem'] + SMEM_BLOCK) > SMEM_SM
  assert _plan(64, 256128, 2048, 32, 1)['per_sm'] == 3
  assert _plan(64, 2048, 16384, 32, 1)['per_sm'] == 3
  assert _plan(64, 2048, 16384, 32, X_PARTS)['per_sm'] == 2  # f32 x's ring
  for parts in (1, X_PARTS):
    assert _plan(64, 32768, 2048, 32, parts)['split'] == 1
    assert _plan(64, 256128, 2048, 32, parts)['split'] == 1
    down = _plan(64, 2048, 16384, 32, parts)
    assert (down['split'], down['per']) == (8, 32)
    assert _plan(64, 2048, 2048, 0, parts)['split'] == 8
    for n, k in ((32768, 2048), (2048, 16384)):
      p = _plan(1024, n, k, 32, parts)
      assert (p['wgs'], p['nt'], p['split']) == (2, 128, 1)
      assert p['stages'] >= 2
    assert _plan(64, 32768, 2048, 32, parts)['stages'] >= 2


@pytest.mark.parametrize('bs', [0, 32, 64, 96, 128, 256])
def test_plan_splits_whole_blocks_and_fits(bs):
  """Every split takes whole stages and whole blocks, no split is empty,
  the cluster is portable, and the ring fits with two stages wherever a
  split has two."""
  for m in (1, 37, 64, 65, 200, 1024):
    for n in (64, 192, 2048, 2112):
      for k in (256, 768, 2048, 16384):
        if bs and k % bs:
          continue
        for parts in (1, X_PARTS):
          p = _plan(m, n, k, bs, parts)
          assert 1 <= p['split'] <= MAX_SPLIT
          assert (p['split'] - 1) * p['per'] < p['steps'] <= (
              p['split'] * p['per'])
          if bs:  # a split starts at a block's first half stage
            assert (2 * p['per']) % p['half_blocks'] == 0
          assert p['stages'] >= min(2, p['per'])


# ------------------------------------------------ the arithmetic twin


def _window_dot(xa, wa):
  """One k16 window's products, exact, rounded once to f32 (the tensor
  cores' product of exact bf16 operands)."""
  return (xa.astype(np.float64) @ wa.astype(np.float64).T).astype(np.float32)


def twin(x, w, s, b, bs, x_bf16=False):
  """#16's sums on the launch plan: float32 [M, N]. x_bf16: x holds bf16
  values and is one operand (the kernel's bf16 path), else three parts."""
  x = x.float().numpy() if isinstance(x, torch.Tensor) else x
  m, k = x.shape
  n = w.shape[0]
  parts = [x] if x_bf16 else _parts(x)
  wf = w.numpy().astype(np.float32)
  plan = _plan(m, n, k, bs, len(parts))
  sn = s.numpy().reshape(n, -1)

  def block_sum(cols):
    """A block's sum from zero: its k16 windows in order, each window's
    parts, the smallest first."""
    acc = np.zeros((m, n), np.float32)
    for c0 in range(cols.start, cols.stop, 16):
      win = slice(c0, c0 + 16)
      for p in reversed(parts):
        acc = (acc + _window_dot(p[:, win], wf[:, win])).astype(np.float32)
    return acc

  partials = []
  for z in range(plan['split']):
    s0 = z * plan['per'] * STEP_K
    s1 = min(plan['steps'], (z + 1) * plan['per']) * STEP_K
    if bs == 0:
      partials.append(block_sum(range(s0, s1)))
      continue
    y = np.zeros((m, n), np.float32)
    for jb in range(s0 // bs, s1 // bs):  # y + p * s in block order
      scaled = (block_sum(range(jb * bs, (jb + 1) * bs))
                * sn[None, :, jb]).astype(np.float32)
      y = (y + scaled).astype(np.float32)
    partials.append(y)
  y = partials[0]
  for part in partials[1:]:  # in split order
    y = (y + part).astype(np.float32)
  if bs == 0:
    y = (y * sn[None, :, 0]).astype(np.float32)
  if b is not None:
    y = (y + b.numpy()[None, :]).astype(np.float32)
  return y


def _inputs(m, n, k, bs, seed, wmax=8):
  rng = np.random.default_rng(seed)
  x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
  w = torch.from_numpy(rng.integers(-wmax, wmax, (n, k)).astype(np.int8))
  s = torch.from_numpy((rng.random((n, k // bs) if bs else (n,)) * 0.01
                        + 0.005).astype(np.float32))
  b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
  return x, w, s, b


def _hold(got, want, k, bs):
  want = np.asarray(want, np.float32)
  tol = int_qmatmul.int_weights_tolerance(k, bs, float(np.abs(want).max()))
  err = float(np.abs(got - want).max())
  assert err <= tol, (err, tol)
  return err, tol


# (M, N, K, bs): a decode split (the channelwise one 4 ways), ragged M,
# one and two warpgroups, blocks of 32 (two a stage), 64 (one), 128 (two
# stages), a K of one stage, int8's full range.
TWIN_CASES = [(64, 128, 1024, 32), (37, 192, 512, 64), (65, 128, 1024, 128),
              (8, 64, 256, 32), (64, 128, 2048, 0), (70, 192, 512, 0),
              (3, 64, 64, 0)]


@pytest.mark.parametrize('m,n,k,bs', TWIN_CASES)
@pytest.mark.parametrize('x_kind', ['bf16', 'f32'])
@pytest.mark.parametrize('bias', [False, True])
def test_twin_within_tolerance(m, n, k, bs, x_kind, bias):
  x, w, s, b = _inputs(m, n, k, bs, m + n + k + bs, wmax=128 if m == 8 else 8)
  if x_kind == 'bf16':
    x = x.to(torch.bfloat16).float()  # one bf16 operand
  bb = b if bias else None
  got = twin(x, w, s, bb, bs, x_bf16=x_kind == 'bf16')
  _hold(got, int_qmatmul.qmatmul_int_weights_plain(x, w, s, bb, bs).numpy(),
        k, bs)


def test_twin_runs_split_schedules():
  assert _plan(64, 128, 1024, 32, 1)['split'] > 1
  assert _plan(64, 128, 2048, 0, 1)['split'] > 1
  assert _plan(65, 128, 1024, 128, 3)['wgs'] == 2


@pytest.mark.parametrize('bs', [0, 32, 64, 128])
def test_twin_matches_interpret_pallas(bs):
  m, n, k = 6, 256, 512
  x, w, s, b = _inputs(m, n, k, bs, 40 + bs)
  want = np.asarray(pallas_qmatmul.qmatmul_pallas(
      jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(s.numpy()),
      jnp.asarray(b.numpy()), block_size=bs, interpret=True))
  _hold(twin(x, w, s, b, bs), want, k, bs)
  bf = x.to(torch.bfloat16)
  want_bf = np.asarray(pallas_qmatmul.qmatmul_pallas(
      jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16),
      jnp.asarray(w.numpy()), jnp.asarray(s.numpy()), None, block_size=bs,
      interpret=True).astype(jnp.float32))
  got_bf = torch.from_numpy(twin(bf.float(), w, s, None, bs, True)).to(
      torch.bfloat16).float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, bs, float(np.abs(want_bf).max()))
  assert np.all(np.abs(got_bf - want_bf)
                <= tol + 2.0**-8 * np.abs(want_bf))  # one bf16 rounding


def test_twin_sees_a_wrong_block_scale_and_a_lost_part():
  """A block's scale doubled, or f32 x cut to two parts, moves the twin far
  beyond the tolerance: the pairing of blocks and scales and the third
  part are checked."""
  m, n, k, bs = 16, 128, 512, 32
  x, w, s, _ = _inputs(m, n, k, bs, 5)
  want = int_qmatmul.qmatmul_int_weights_plain(x, w, s, None, bs).numpy()
  tol = int_qmatmul.int_weights_tolerance(k, bs, float(np.abs(want).max()))
  s2 = s.clone()
  s2[:, 3] *= 2
  assert float(np.abs(twin(x, w, s2, None, bs) - want).max()) > 100 * tol
  hi, mid, _ = _parts(x.numpy())
  two = torch.from_numpy((hi + mid).astype(np.float32))
  assert float(np.abs(twin(two, w, s, None, bs) - want).max()) > tol


# --------------------------------------------------------------- the sources


def test_entry_point_runs_wgmma_and_the_simt_tile_is_gone():
  assert '#include "int4_bf16_tc_gemm.cuh"' in SOURCE
  assert 'w4::wgmma_rs<NT>(' in SOURCE and 'tma_load_2d(' in SOURCE
  assert 'wgmma.wait_group.sync.aligned 1;' in SOURCE  # two block sums
  assert 'griddepcontrol.launch_dependents' in SOURCE
  assert 'extern "C" int aeqt_qmatmul_int_weights_plan(' in SOURCE
  for gone in ('qmatmul_int_weights_kernel', 'kWoBM', '__fmaf_rn',
               'xs[kWoBK]', 'mma.sync', '<<<grid, kWoThreads'):
    assert gone not in SOURCE, gone
  # One kernel launch a call (and the parts' pass for f32 x).
  assert SOURCE.count('cudaLaunchKernelEx(') == 1
  assert SOURCE.count('<<<') == 1


def test_wrapper_passes_bf16_x_as_it_is():
  text = pathlib.Path(int_qmatmul.__file__).read_text()
  body = text[text.index('def qmatmul_int_weights('):]
  assert 'x2.to(torch.bfloat16 if x_bf16 else torch.float32)' in body
  assert 'torch.empty((3, m, k), dtype=torch.bfloat16' in body
  assert len(int_qmatmul.INT_WEIGHTS_PLAN_FIELDS) == 10
  written = {int(i) for i in re.findall(r'\bf\[(\d+)\] =', SOURCE)}
  assert written == set(range(len(int_qmatmul.INT_WEIGHTS_PLAN_FIELDS)))
