"""The bf16 tensor-core core of the weight-only packed int4 matmuls
(`csrc/int4_bf16_tc_gemm.cuh`, kernels #12 `qmatmul_int4_packed` and #13
`qmatmul_int4_packed_blockwise`) on the CPU, where no CUDA kernel runs:
numpy twins of what the kernel does that the plain versions do not show.

  * The exponent trick (`widen_word`: a nibble u as the bf16
    0x4300 | (u ^ 8), which is 136 + value, less 136) equals
    `packed_qmatmul.unpack_int4_split` on every byte value and on random
    words.
  * The weights' A fragments (`window_bytes`, `a_frags`): each thread's
    four bytes of a k16 window of its two packed rows, widened, placed by
    wgmma's register-fragment map, give back the unpacked row-major tile
    (low nibbles and high nibbles).
  * The x tiles' 128-byte swizzle (TMA's placement) read through the wgmma
    descriptor's K-major addressing (`sw128_desc`, + 32 bytes a k16 step)
    gives back the row-major tile.
  * The launch plan (warpgroups, tokens a tile, the grid, split-K in whole
    steps or byte blocks, ring stages; the constants read from the header)
    and the f32 sums it schedules: per split, lo and hi accumulators over
    its k16 windows; ChannelScale adds the splits in order, then lo + hi,
    times s, plus b; BlockScale scales each byte block's lo and hi into y
    and adds the splits' y in order, then b. At ragged M, N and K, bs 128
    and 256, with and without a bias, within
    `int_qmatmul.int_weights_tolerance` of the plain versions (and one bf16
    rounding of the bf16 result).
  * The plain versions against interpret-mode Pallas
    `qmatmul_pallas_int4_packed` and `qmatmul_pallas_int4_packed_blockwise`.
  * The sources: both entry points send bf16 x to the core (wgmma fed by a
    TMA ring, one launch, no scratch); no mma.sync tile and no second
    launch remain on that path.

The card runs the kernels against their plain versions in `chip_smoke.py`.
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
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul

CSRC = pathlib.Path(_build.CSRC)
CORE = (CSRC / 'int4_bf16_tc_gemm.cuh').read_text()
H100_SMS = 132
_BF16_EPS = 2.0**-8


def _const(name):
  found = re.search(rf'constexpr (?:int|size_t) {name} = ([0-9 *+-]+);', CORE)
  assert found, name
  return int(eval(found.group(1)))  # a literal integer expression


def _policy_nt2(policy):
  body = re.search(rf'struct {policy} \{{(.*?)\n\}};', CORE, re.S).group(1)
  return int(re.search(r'static constexpr int kNT2 = (\d+);', body).group(1))


STEP_BYTES, WG_ROWS, MAX_STAGES, MAX_SPLIT, MIN_SPLIT_STEPS, NT1 = (
    _const(n) for n in ('kStepBytes', 'kWgRows', 'kMaxStages', 'kMaxSplit',
                        'kMinSplitSteps', 'kNT1'))
NT2 = {'channel': _policy_nt2('ChannelScale'),
       'block': _policy_nt2('BlockScale')}
SMEM_BUDGET = _const('kSmemBudget')
SMEM_HALF = _const('kSmemHalf')


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ widening


def _bf16_bits_to_f32(bits):
  """uint16 bf16 bit patterns -> float32 values."""
  return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _widen_word(words):
  """numpy twin of widen_word on uint32 words: (lo01, lo23, hi01, hi23),
  each [..., 2] float32 (the bf16 pair's low half first)."""
  b = words.view(np.uint8).reshape(words.shape + (4,)).astype(np.uint32)
  t01 = b[..., 0] | (b[..., 1] << 16)
  t23 = b[..., 2] | (b[..., 3] << 16)
  out = []
  for t, shift in ((t01, 0), (t23, 0), (t01, 4), (t23, 4)):
    v = ((t >> np.uint32(shift)) & np.uint32(0x000F000F)) ^ np.uint32(
        0x43084308)
    pair = np.stack([v & 0xFFFF, v >> 16], axis=-1).astype(np.uint16)
    # 0x4300 | u' is 128 + u' exactly; less 136 (bf16 arithmetic, exact).
    out.append(_bf16_bits_to_f32(pair) - np.float32(136.0))
  return out


def _unpack_words(packed):
  """Unpacks uint8 [N, K/2] through _widen_word, four bytes a word."""
  words = np.ascontiguousarray(packed).view(np.uint32)
  lo01, lo23, hi01, hi23 = _widen_word(words)
  lo = np.concatenate([lo01, lo23], axis=-1).reshape(packed.shape)
  hi = np.concatenate([hi01, hi23], axis=-1).reshape(packed.shape)
  return np.concatenate([lo, hi], axis=1)


def test_exponent_trick_every_byte_value():
  packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
  want = packed_qmatmul.unpack_int4_split(_t(packed)).numpy()
  got = _unpack_words(packed)
  np.testing.assert_array_equal(got, want.astype(np.float32))
  # 136 + value is a bf16 integer below 256: the subtraction is exact.
  assert got.min() == -8 and got.max() == 7


@pytest.mark.parametrize('seed,n,k2', [(0, 7, 16), (1, 128, 64),
                                       (2, 33, 528)])
def test_exponent_trick_random_words(seed, n, k2):
  rng = np.random.default_rng(seed)
  packed = rng.integers(0, 256, (n, k2), dtype=np.uint8)
  want = packed_qmatmul.unpack_int4_split(_t(packed)).numpy()
  np.testing.assert_array_equal(_unpack_words(packed),
                                want.astype(np.float32))


# ------------------------------------------------ the operands' placement


def _window_bytes(v, q):
  """window_bytes: bytes 2q, 2q + 1, 2q + 8, 2q + 9 of a 16-byte chunk, as
  one little-endian uint32 (the __byte_perm of words q / 2 and 2 + q / 2)."""
  sel = [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]
  return np.frombuffer(bytes(v[sel].tobytes()), dtype=np.uint32)[0]


def _a_tiles(packed):
  """The A operand one warpgroup's fragments hold for each k16 window of a
  stage: [4 windows][64 rows][16 k] for the low and the high nibbles,
  assembled from every lane's registers by wgmma's fragment map (a[0]: row
  g, k 2q, 2q + 1; a[1]: row g + 8; a[2], a[3]: k 8 further; warp w rows
  16w .. 16w + 15)."""
  assert packed.shape == (WG_ROWS, STEP_BYTES)
  lo = np.full((4, WG_ROWS, 16), np.nan, np.float32)
  hi = np.full((4, WG_ROWS, 16), np.nan, np.float32)
  for c in range(4):
    for w in range(4):
      for lane in range(32):
        g, q = lane // 4, lane % 4
        r = 16 * w + g
        for rr in (r, r + 8):  # a[0], a[2] for row r; a[1], a[3] for r + 8
          word = np.array([_window_bytes(packed[rr, 16 * c:16 * c + 16], q)],
                          dtype=np.uint32)
          lo01, lo23, hi01, hi23 = (x[0] for x in _widen_word(word))
          # The first register holds k 2q, 2q + 1; the second 2q + 8, 2q + 9.
          for dst, first, second in ((lo, lo01, lo23), (hi, hi01, hi23)):
            dst[c, rr, 2 * q:2 * q + 2] = first
            dst[c, rr, 2 * q + 8:2 * q + 10] = second
  return lo, hi


def test_a_fragments_give_back_the_unpacked_tile():
  rng = np.random.default_rng(3)
  packed = rng.integers(0, 256, (WG_ROWS, STEP_BYTES), dtype=np.uint8)
  w = packed_qmatmul.unpack_int4_split(_t(packed)).numpy().astype(np.float32)
  lo, hi = _a_tiles(packed)
  for c in range(4):
    np.testing.assert_array_equal(lo[c], w[:, 16 * c:16 * c + 16])
    np.testing.assert_array_equal(
        hi[c], w[:, STEP_BYTES + 16 * c:STEP_BYTES + 16 * c + 16])


def _swizzle_place(tile_bytes):
  """TMA's 128-byte swizzle: byte b of row r lands at r * 128 + ((b / 16)
  ^ (r % 8)) * 16 + b % 16."""
  rows = tile_bytes.shape[0]
  smem = np.zeros(rows * 128, np.uint8)
  for r in range(rows):
    for b in range(128):
      smem[r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)] = tile_bytes[r, b]
  return smem


def _descriptor_read(smem, rows, window):
  """wgmma's reading of a K-major operand through sw128_desc at k16 step
  `window` (start + 32 bytes a step; 8-row atoms 1024 bytes apart; the
  16-byte chunk index XOR the row within its atom): [rows, 16] bf16."""
  out = np.zeros((rows, 16), np.uint16)
  for n in range(rows):
    for k in range(16):
      logical = (n // 8) * 1024 + (n % 8) * 128 + 32 * window + 2 * k
      chunk = ((logical >> 4) & 7) ^ ((logical >> 7) & 7)
      phys = (logical & ~0x70) | (chunk << 4)
      out[n, k] = smem[phys] | (np.uint16(smem[phys + 1]) << 8)
  return out


@pytest.mark.parametrize('rows', [NT1, 16])
def test_x_tile_swizzle_read_by_the_descriptor(rows):
  rng = np.random.default_rng(rows)
  x = rng.integers(0, 2**16, (rows, 64), dtype=np.uint16)  # bf16 bits
  smem = _swizzle_place(x.view(np.uint8).reshape(rows, 128))
  for window in range(4):
    np.testing.assert_array_equal(_descriptor_read(smem, rows, window),
                                  x[:, 16 * window:16 * window + 16])


# -------------------------------------------------------------- the plan


def _stage_bytes(nt, wgs):
  return 2 * nt * 128 + WG_ROWS * wgs * STEP_BYTES


def _plan(m, n, k, bs, policy, sms=H100_SMS):
  """int4_bf16_tc_gemm.cuh make_plan: (wgs, nt, m_tiles, n_tiles, split,
  steps_per_split, steps, stages)."""
  wgs = 1 if m <= NT1 else 2
  nt = NT1 if wgs == 1 else NT2[policy]
  m_tiles, n_tiles = -(-m // nt), -(-n // (WG_ROWS * wgs))
  steps = k // 2 // STEP_BYTES
  unit = bs // STEP_BYTES if policy == 'block' else 1
  units = steps // unit
  min_units = max(1, MIN_SPLIT_STEPS // unit)
  want = max(1, min(units // min_units, sms // (m_tiles * n_tiles),
                    MAX_SPLIT))
  per = -(-units // want)
  split = -(-units // per)
  budget = SMEM_HALF if wgs == 1 else SMEM_BUDGET
  fit = (budget - 1024) // _stage_bytes(nt, wgs)
  stages = min(MAX_STAGES, per * unit, fit)
  return wgs, nt, m_tiles, n_tiles, split, per * unit, steps, stages


def test_plan_at_the_server_shapes():
  """Gemma-2B's FCs: decode (M 64, one warpgroup, 64 weight rows a block,
  two blocks an SM) splits K in a cluster where the tiles leave SMs idle
  (QKV N 2560: 40 tiles, split 3; out N 2048: 32 tiles, split 4; the
  blockwise down FC, K 16384: split 4 in byte blocks); gate/up and the head
  have tiles enough and do not split; prefill (M 1024, two warpgroups)
  never splits."""
  assert _plan(64, 2560, 2048, 0, 'channel')[2:6] == (1, 40, 3, 6)
  assert _plan(64, 2048, 2048, 0, 'channel')[2:6] == (1, 32, 4, 4)
  assert _plan(64, 2560, 2048, 128, 'block')[4] == 3
  assert _plan(64, 2048, 16384, 128, 'block')[4:6] == (4, 32)
  for n in (32768, 256128):
    assert _plan(64, n, 2048, 128, 'block')[4] == 1
  for policy, bs in (('channel', 0), ('block', 128)):
    for n, k in ((2560, 2048), (2048, 2048), (32768, 2048), (2048, 16384)):
      wgs, nt, m_tiles, _, split, _, _, stages = _plan(1024, n, k, bs, policy)
      assert wgs == 2 and split == 1 and m_tiles == 1024 // nt
      assert 2 <= stages <= MAX_STAGES


@pytest.mark.parametrize('policy,bs', [('channel', 0), ('block', 128),
                                       ('block', 256)])
def test_plan_splits_whole_units_and_fits(policy, bs):
  """Every split takes whole steps (BlockScale: whole byte blocks), no split
  is empty, the cluster is portable, and the ring fits the block's shared
  memory with two stages wherever a split has two steps."""
  for m in (1, 37, 64, 65, 200, 1024):
    for n in (64, 192, 2048, 2112, 2560):
      for k in (256, 512, 2048, 16384):
        if bs and k % (2 * bs):
          continue
        wgs, nt, m_tiles, n_tiles, split, per, steps, stages = _plan(
            m, n, k, bs, policy)
        unit = bs // STEP_BYTES if bs else 1
        assert per % unit == 0 and 1 <= split <= MAX_SPLIT
        assert (split - 1) * per < steps <= split * per
        assert stages >= min(2, per)


# ------------------------------------------------ the arithmetic twins


def _windows(x2, w, k):
  """x lo / hi and w lo / hi as f32, the K/2 columns of each half."""
  k2 = k // 2
  wf = packed_qmatmul.unpack_int4_split(_t(w)).numpy().astype(np.float32)
  return x2[:, :k2], x2[:, k2:], wf[:, :k2], wf[:, k2:]


def _contract(xa, wa, steps):
  """One accumulator over `steps` (a range of 64-byte steps): k16 windows
  in order, each a product the tensor cores sum in f32."""
  acc = np.zeros((xa.shape[0], wa.shape[0]), np.float32)
  for step in steps:
    for c in range(4):
      cols = slice(STEP_BYTES * step + 16 * c, STEP_BYTES * step + 16 * c + 16)
      acc = acc + (xa[:, cols] @ wa[:, cols].T).astype(np.float32)
  return acc


def _twin_channel(x, w, s, b):
  m, k = x.shape
  x2 = x.float().numpy()
  xlo, xhi, wlo, whi = _windows(x2, w.numpy(), k)
  *_, split, per, steps, _ = _plan(m, w.shape[0], k, 0, 'channel')
  parts = [(_contract(xlo, wlo, range(z * per, min(steps, (z + 1) * per))),
            _contract(xhi, whi, range(z * per, min(steps, (z + 1) * per))))
           for z in range(split)]
  lo, hi = parts[0]
  for plo, phi in parts[1:]:  # in split order
    lo, hi = lo + plo, hi + phi
  y = (lo + hi) * s.numpy()[None, :]
  if b is not None:
    y = y + b.numpy()[None, :]
  return torch.from_numpy(y.astype(np.float32))


def _twin_block(x, w, s, b, bs):
  m, k = x.shape
  x2 = x.float().numpy()
  xlo, xhi, wlo, whi = _windows(x2, w.numpy(), k)
  sn = s.numpy()
  nb2 = sn.shape[1] // 2
  *_, split, per, steps, _ = _plan(m, w.shape[0], k, bs, 'block')
  unit = bs // STEP_BYTES
  ys = []
  for z in range(split):
    y = np.zeros((m, w.shape[0]), np.float32)
    for jb in range(z * per // unit, min(steps, (z + 1) * per) // unit):
      blk = range(jb * unit, (jb + 1) * unit)
      lo, hi = _contract(xlo, wlo, blk), _contract(xhi, whi, blk)
      y = y + (lo * sn[None, :, jb] + hi * sn[None, :, nb2 + jb])
    ys.append(y)
  y = ys[0]
  for part in ys[1:]:  # in split order
    y = y + part
  if b is not None:
    y = y + b.numpy()[None, :]
  return torch.from_numpy(y.astype(np.float32))


def _inputs(m, n, k, scale_shape, seed):
  rng = np.random.default_rng(seed)
  x = _t((rng.standard_normal((m, k)) * 2).astype(np.float32)).to(
      torch.bfloat16)
  w = packed_qmatmul.pack_int4_split(
      _t(rng.integers(-8, 8, (n, k)).astype(np.int8)))
  s = _t((rng.random(scale_shape) * 0.01 + 0.005).astype(np.float32))
  b = _t(rng.standard_normal(n).astype(np.float32))
  return x, w, s, b


def _within(got_f32, want_bf16, k, bs):
  """The twin's f32 result cast to bf16 against the plain version: within
  the tolerance of max |y|, and one bf16 rounding."""
  want = want_bf16.float().numpy()
  got = got_f32.to(torch.bfloat16).float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, bs, float(np.abs(want).max()))
  assert np.all(np.abs(got - want) <= tol + _BF16_EPS * np.abs(want)), (
      np.abs(got - want).max(), tol)


# (M, N, K): decode splits (3 and 4), one step a split, ragged M, N
# (N % 128 == 64 at two warpgroups), a one-step K, prefill-shaped rows.
CHANNEL_SHAPES = [(64, 320, 2048), (37, 192, 1024), (1, 64, 128),
                  (65, 320, 512), (130, 192, 384), (17, 192, 1408)]


@pytest.mark.parametrize('m,n,k', CHANNEL_SHAPES)
@pytest.mark.parametrize('bias', [False, True])
def test_channel_twin_within_tolerance(m, n, k, bias):
  x, w, s, b = _inputs(m, n, k, (n,), m + n + k)
  bb = b if bias else None
  _within(_twin_channel(x, w, s, bb),
          packed_qmatmul.qmatmul_int4_packed_plain(x, w, s, bb), k, 0)


BLOCK_SHAPES = [(64, 256, 2048, 128), (37, 192, 1024, 256),
                (1, 64, 256, 128), (65, 320, 1024, 128),
                (130, 128, 2048, 256), (64, 128, 4096, 128)]


@pytest.mark.parametrize('m,n,k,bs', BLOCK_SHAPES)
@pytest.mark.parametrize('bias', [False, True])
def test_block_twin_within_tolerance(m, n, k, bs, bias):
  x, w, s, b = _inputs(m, n, k, (n, k // bs), m + n + k + bs)
  bb = b if bias else None
  _within(_twin_block(x, w, s, bb, bs),
          packed_qmatmul.qmatmul_int4_packed_blockwise_plain(x, w, s, bb),
          k, bs)


def test_twin_splits_the_decode_shape():
  """The twins above run split schedules: the decode shape splits its K."""
  assert _plan(64, 320, 2048, 0, 'channel')[4] > 1
  assert _plan(64, 256, 2048, 128, 'block')[4] > 1
  assert _plan(64, 128, 4096, 128, 'block')[4] > 1


def test_block_twin_pairs_blocks_and_scales():
  """A high-nibble block's scale doubled moves the twin far beyond the
  tolerance: the pairing of byte blocks and scale columns is checked."""
  m, n, k, bs = 16, 128, 1024, 128
  x, w, s, _ = _inputs(m, n, k, (n, k // bs), 5)
  want = packed_qmatmul.qmatmul_int4_packed_blockwise_plain(x, w, s).float()
  s2 = s.clone()
  s2[:, k // bs // 2] *= 2
  bad = _twin_block(x, w, s2, None, bs)
  tol = int_qmatmul.int_weights_tolerance(k, bs, float(want.abs().max()))
  assert float((bad - want).abs().max()) > 100 * tol


# --------------------------------------- the plain versions and the TPU kernel


@pytest.mark.parametrize('bias', [False, True])
def test_channel_plain_matches_interpret_pallas(bias):
  m, n, k = 5, 256, 512
  x, w, s, b = _inputs(m, n, k, (n,), 11)
  bb = b if bias else None
  want = pallas_qmatmul.qmatmul_pallas_int4_packed(
      jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
      jnp.asarray(w.numpy()), jnp.asarray(s.numpy()),
      None if bb is None else jnp.asarray(bb.numpy()), interpret=True)
  want = np.asarray(want.astype(jnp.float32))
  got = packed_qmatmul.qmatmul_int4_packed_plain(x, w, s, bb).float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, 0, float(np.abs(want).max()))
  assert np.all(np.abs(got - want) <= tol + _BF16_EPS * np.abs(want))


@pytest.mark.parametrize('bs', [128, 256])
def test_block_plain_matches_interpret_pallas(bs):
  m, n, k = 5, 256, 1024
  x, w, s, b = _inputs(m, n, k, (n, k // bs), 13 + bs)
  want = pallas_qmatmul.qmatmul_pallas_int4_packed_blockwise(
      jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
      jnp.asarray(w.numpy()), jnp.asarray(s.numpy()), jnp.asarray(b.numpy()),
      block_size=bs, interpret=True)
  want = np.asarray(want.astype(jnp.float32))
  got = packed_qmatmul.qmatmul_int4_packed_blockwise_plain(
      x, w, s, b).float().numpy()
  tol = int_qmatmul.int_weights_tolerance(k, bs, float(np.abs(want).max()))
  assert np.all(np.abs(got - want) <= tol + _BF16_EPS * np.abs(want))


# --------------------------------------------------------------- the sources


@pytest.mark.parametrize('source,policy', [
    ('qmatmul_int4_weight_only.cu', 'ChannelScale'),
    ('qmatmul_int4_blockwise.cu', 'BlockScale')])
def test_bf16_path_runs_on_the_tensor_core_core(source, policy):
  """The entry point sends bf16 x to the core's one launch (wgmma fed by a
  TMA ring) and exports its plan; no mma.sync tile, no second launch and
  no scratch remain on the path."""
  text = (CSRC / source).read_text()
  assert '#include "int4_bf16_tc_gemm.cuh"' in text
  assert f'aeqt::w4::run<aeqt::w4::{policy}>' in text
  assert f'aeqt_{source[:-3]}_plan(' in text
  for gone in ('#include "qmatmul_int4_weight_only.cuh"', 'mma_bf16',
               'wo_mma_tile', 'launch_wo', 'blocks_sum_kernel',
               'blockwise_mma_kernel', '_scratch(', 'void* part'):
    assert gone not in text, gone
  assert not (CSRC / 'qmatmul_int4_weight_only.cuh').exists()
  assert 'wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16' in CORE
  assert 'tma_load_2d(' in CORE and 'mma.sync' not in CORE
  wrapper = pathlib.Path(packed_qmatmul.__file__).read_text()
  assert 'aeqt_qmatmul_int4_blockwise_scratch' not in wrapper


def test_plan_fields_match_the_wrapper():
  """The C plan writes as many fields as the wrapper's field names."""
  written = {int(i) for i in re.findall(r'\bf\[(\d+)\] =', CORE)}
  assert written == set(range(len(packed_qmatmul.INT4_BF16_PLAN_FIELDS)))
