"""The int8 tensor-core core of the DRQ matmuls (`csrc/int8_tc_gemm.cuh`,
kernels #15 `qmatmul_int8_drq`, #6 `qmatmul_int4_packed_drq_kblock` and #1
`qmatmul_int4_packed_drq`) on the CPU, where no CUDA kernel runs: numpy
twins of what the kernel does that the plain versions do not show.

  * The byte-wise nibble unpack (`unpack_split_tile`: each nibble n of a
    32-bit word sign-extended as `n | ((n & 0x08080808) * 0x1E)`, the
    bytes of drq_common.cuh's `nib_lo` / `nib_hi`, `((v & 0xF) ^ 8) - 8`),
    equals `packed_qmatmul.unpack_int4_split` on every byte value and on
    random words.
  * The split-K schedule: the kernel's plan (tiles, K steps, splits; the
    constants read from the header) and its tile walk, with TMA's zero fill
    past every edge, give int32 partials whose sum over the cluster of a
    tile's splits is exactly
    `qmatmul.int_matmul_exact` and, through the epilogue, the plain
    versions bit for bit, at ragged M, N and K.
  * #1's twin (#6's split-half loader, #15's reciprocal row quantize)
    also against interpret-mode Pallas `qmatmul_pallas_int4_packed_drq`.

The JAX parity of the wrappers stays in `test_torch_port_int_qmatmul.py`
(#15), `test_torch_port_hadamard.py` (#6) and `test_torch_port_kernels.py`
(#1); the card runs the kernels against their plain versions in
`chip_smoke.py`.
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
from ai_edge_quantizer_tpu_torch.kernels import qmatmul

CSRC = pathlib.Path(_build.CSRC)
CORE = (CSRC / 'int8_tc_gemm.cuh').read_text()


def _const(name):
  found = re.search(rf'constexpr (?:int|size_t) {name} = ([0-9 *+-]+);', CORE)
  assert found, name
  return int(eval(found.group(1)))  # a literal integer expression


BK, BN, WG_ROWS, MIN_SPLIT_STEPS, MIN_SPLIT_STEPS_1, MAX_SPLIT = (
    _const(n) for n in ('kBK', 'kBN', 'kWgRows', 'kMinSplitSteps',
                        'kMinSplitStepsInt4Drq', 'kMaxSplit'))
H100_SMS = 132


# ------------------------------------------------------------ nibble unpack


def _sign_extend_nibbles(words, shift):
  """numpy twin of the core's unpack of the low (shift 0) / high (shift 4)
  nibbles: n = (w >> shift) & 0x0F0F0F0F, then n | ((n & 0x08080808) *
  0x1E) in 32 bits (a byte with bit 3 set gains 0xF0, no carry between
  bytes), read as int8."""
  n = ((words >> np.uint32(shift)) & np.uint32(0x0F0F0F0F)).astype(
      np.uint64)
  v = (n | ((n & 0x08080808) * 0x1E)) & 0xFFFFFFFF
  return v.astype(np.uint32).view(np.int8)


def _unpack_words(packed):
  """Unpacks uint8 [N, K/2] as the kernel does, four bytes a word."""
  words = np.ascontiguousarray(packed).view(np.uint32)
  lo = _sign_extend_nibbles(words, 0).reshape(packed.shape)
  hi = _sign_extend_nibbles(words, 4).reshape(packed.shape)
  return np.concatenate([lo, hi], axis=1)


def test_nibble_unpack_every_byte_value():
  packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
  want = packed_qmatmul.unpack_int4_split(torch.from_numpy(packed)).numpy()
  np.testing.assert_array_equal(_unpack_words(packed), want)
  # Low nibble v -> v - 16 * (v >= 8), for every high nibble alike.
  lo = np.arange(256) & 15
  np.testing.assert_array_equal(want[0, :256], np.where(lo >= 8, lo - 16, lo))


@pytest.mark.parametrize('seed,n,k2', [(0, 7, 16), (1, 128, 64),
                                       (2, 33, 528)])
def test_nibble_unpack_random_words(seed, n, k2):
  rng = np.random.default_rng(seed)
  packed = rng.integers(0, 256, (n, k2), dtype=np.uint8)
  want = packed_qmatmul.unpack_int4_split(torch.from_numpy(packed)).numpy()
  np.testing.assert_array_equal(_unpack_words(packed), want)
  # And packing the unpacked values gives the same bytes back.
  repacked = packed_qmatmul.pack_int4_split(torch.from_numpy(want)).numpy()
  np.testing.assert_array_equal(repacked, packed)


# ------------------------------------------------------ split-K schedule twin


def _plan(m, n, k, nibbles, sms=H100_SMS, min_steps=MIN_SPLIT_STEPS):
  """int8_tc_gemm.cuh make_plan: one consumer warpgroup (64 rows) for
  M <= 64, else two; K steps of BK bytes (of K/2 packed bytes for #6 and
  #1); a split of K, into at most MAX_SPLIT blocks (one cluster), only
  while the tiles leave SMs idle and every split has `min_steps` steps
  (the policy's kMinSteps: MIN_SPLIT_STEPS_1 for #1 at one warpgroup;
  MIN_SPLIT_STEPS at two), every split but the last the same number."""
  wgs = 1 if m <= WG_ROWS else 2
  bm = WG_ROWS * wgs
  m_tiles, n_tiles = -(-m // bm), -(-n // BN)
  steps = -(-(k // 2 if nibbles else k) // BK)
  if wgs == 2:
    min_steps = MIN_SPLIT_STEPS
  want = max(1, min(steps // min_steps, sms // (m_tiles * n_tiles),
                    MAX_SPLIT))
  per = -(-steps // want)
  split = -(-steps // per)
  return bm, m_tiles, n_tiles, steps, per, split


def _box(a, r0, c0, rows, cols):
  """A TMA box of a 2D array: zeros past its last row and column."""
  out = np.zeros((rows, cols), dtype=np.int64)
  part = a[r0:r0 + rows, c0:c0 + cols]
  out[:part.shape[0], :part.shape[1]] = part
  return out


def _twin_acc(xq, w, nibbles, sms=H100_SMS, min_steps=MIN_SPLIT_STEPS):
  """The int32 sums the kernel forms: per output tile and split, a partial
  over its K steps from zero-filled boxes (#6: the packed box unpacked to
  lo and hi, contracted against the codes at kb and at K/2 + kb), staged
  as int32; block z of the tile's cluster sums its share of the rows over
  every split, its own first."""
  m, k = xq.shape
  n = w.shape[0]
  bm, m_tiles, n_tiles, steps, per, split = _plan(m, n, k, nibbles, sms,
                                                  min_steps)
  assert split * per >= steps > (split - 1) * per  # no split is empty
  acc = np.zeros((m_tiles * bm, n_tiles * BN), dtype=np.int64)
  for mt in range(m_tiles):
    for nt in range(n_tiles):
      m0, n0 = mt * bm, nt * BN
      partials = []
      for z in range(split):
        part = np.zeros((bm, BN), dtype=np.int64)
        for step in range(z * per, min(steps, (z + 1) * per)):
          kb = step * BK
          if nibbles:
            packed = _box(w, n0, kb, BN, BK).astype(np.uint8)
            lo_hi = _unpack_words(packed).astype(np.int64)
            part += _box(xq, m0, kb, bm, BK) @ lo_hi[:, :BK].T
            part += _box(xq, m0, k // 2 + kb, bm, BK) @ lo_hi[:, BK:].T
          else:
            part += _box(xq, m0, kb, bm, BK) @ _box(w, n0, kb, BN, BK).T
        partials.append(part.astype(np.int32))  # staged as int32
      per_rows = -(-bm // split)
      for z in range(split):
        rows = slice(z * per_rows, (z + 1) * per_rows)
        total = partials[z][rows].astype(np.int64)
        for other in range(split):
          if other != z:
            total = total + partials[other][rows]
        acc[m0 + rows.start:m0 + rows.start + total.shape[0],
            n0:n0 + BN] = total
  return acc[:m, :n].astype(np.int32)


def _epilogue(acc, xs, s, b, dtype):
  y = torch.from_numpy(acc).float() * xs * s.reshape(1, -1)
  if b is not None:
    y = y + b.reshape(1, -1)
  return y.to(dtype)


def _assert_bits(got, want):
  view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
  assert got.dtype == want.dtype and got.shape == want.shape
  assert torch.equal(got.view(view), want.view(view))


# (M, N, K, SMs, splits): decode, ragged M / N / K, K = 16 * odd (#15),
# splits with a shorter last one, and 3 splits (ragged rows a block).
INT8_SHAPES = [(64, 256, 2048, H100_SMS, 4), (1, 200, 2064, H100_SMS, 4),
               (17, 130, 1040, H100_SMS, 2), (200, 333, 16, H100_SMS, 1),
               (65, 128, 2064, 64, 4), (3, 384, 2000, 8, 2),
               (64, 128, 1536, H100_SMS, 3)]
KBLOCK_SHAPES = [(64, 256, 16384, H100_SMS, 4), (1, 256, 1056, H100_SMS, 1),
                 (17, 200, 4160, H100_SMS, 4), (200, 130, 64, H100_SMS, 1),
                 (37, 256, 2080, 5, 2), (130, 129, 4160, 16, 4)]


@pytest.mark.parametrize('m,n,k,sms,splits', INT8_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_int8_drq_split_k_twin_is_exact(m, n, k, sms, splits, dtype):
  assert _plan(m, n, k, False, sms)[-1] == splits
  rng = np.random.default_rng(m * 7 + n + k)
  x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 3)
  x = x.to(dtype)
  w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
  s = torch.from_numpy((rng.random(n) * 0.01 + 0.005).astype(np.float32))
  b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
  xq, xs = packed_qmatmul.quantize_rows_drq(x.float())
  acc = _twin_acc(xq.numpy(), w.numpy(), nibbles=False, sms=sms)
  np.testing.assert_array_equal(acc, qmatmul.int_matmul_exact(xq, w).numpy())
  for bias in (None, b):
    _assert_bits(_epilogue(acc, xs, s, bias, dtype),
                 int_qmatmul.qmatmul_int8_drq_plain(x, w, s, bias))


@pytest.mark.parametrize('m,n,k,sms,splits', KBLOCK_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_kblock_split_k_twin_is_exact(m, n, k, sms, splits, dtype):
  assert _plan(m, n, k, True, sms)[-1] == splits
  rng = np.random.default_rng(m * 5 + n + k)
  x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 3)
  x = x.to(dtype)
  w_q = torch.from_numpy(rng.integers(-8, 8, (n, k)).astype(np.int8))
  w = packed_qmatmul.pack_int4_split(w_q)
  s = torch.from_numpy((rng.random(n) * 0.01 + 0.005).astype(np.float32))
  b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
  xq, xs = packed_qmatmul.quantize_rows_drq_div(x.float())
  acc = _twin_acc(xq.numpy(), w.numpy(), nibbles=True, sms=sms)
  np.testing.assert_array_equal(acc,
                                qmatmul.int_matmul_exact(xq, w_q).numpy())
  for bias in (None, b):
    _assert_bits(_epilogue(acc, xs, s, bias, dtype),
                 packed_qmatmul.qmatmul_int4_packed_drq_kblock_plain(
                     x, w, s, bias))


# #1 (M, N, K, SMs, splits), splits of MIN_SPLIT_STEPS_1 steps at one
# warpgroup: the server's QKV FC at decode (K 2048 is 8 steps of 128 packed
# bytes: split 4), ragged N and K (3 + 3 + 3 steps), one ragged K step (3 +
# 2), a tiny K at ragged M and N, 4 splits with a short last one (4 + 4 +
# 4 + 2), 3 splits (3 + 3 + 1; rows 22, 22, 20 a block); of
# MIN_SPLIT_STEPS at two warpgroups: bench.py's QKV FC (4 + 4), 3 splits
# (5 + 5 + 4) and 4 (5 + 5 + 5 + 2).
INT4_DRQ_SHAPES = [(64, 2560, 2048, H100_SMS, 4), (1, 200, 2080, H100_SMS, 3),
                   (17, 130, 1056, H100_SMS, 2), (200, 333, 64, H100_SMS, 1),
                   (64, 256, 3584, H100_SMS, 4), (64, 256, 1792, H100_SMS, 3),
                   (256, 2560, 2048, H100_SMS, 2),
                   (200, 256, 3584, H100_SMS, 3), (130, 129, 4160, 16, 4)]


def _int4_drq_inputs(m, n, k, dtype, seed):
  rng = np.random.default_rng(seed)
  x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 3)
  w_q = torch.from_numpy(rng.integers(-8, 8, (n, k)).astype(np.int8))
  s = torch.from_numpy((rng.random(n) * 0.01 + 0.005).astype(np.float32))
  b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
  return x.to(dtype), w_q, packed_qmatmul.pack_int4_split(w_q), s, b


@pytest.mark.parametrize('m,n,k,sms,splits', INT4_DRQ_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_int4_drq_split_k_twin_is_exact(m, n, k, sms, splits, dtype):
  """#1 on the core: the reciprocal row codes (quantize_rows_drq), the
  split-half packed tiles unpacked and contracted at kb and K/2 + kb, the
  split-K cluster sums, then the epilogue: the plain version bit for
  bit."""
  assert _plan(m, n, k, True, sms, MIN_SPLIT_STEPS_1)[-1] == splits
  x, w_q, w, s, b = _int4_drq_inputs(m, n, k, dtype, m * 3 + n + k)
  xq, xs = packed_qmatmul.quantize_rows_drq(x.float())
  acc = _twin_acc(xq.numpy(), w.numpy(), nibbles=True, sms=sms,
                  min_steps=MIN_SPLIT_STEPS_1)
  np.testing.assert_array_equal(acc,
                                qmatmul.int_matmul_exact(xq, w_q).numpy())
  for bias in (None, b):
    _assert_bits(_epilogue(acc, xs, s, bias, dtype),
                 packed_qmatmul.qmatmul_int4_packed_drq_plain(x, w, s, bias))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_int4_drq_twin_matches_interpret_pallas(dtype):
  """The twin at a small ragged shape (split 3, a ragged K step) against
  the TPU kernel in interpret mode: bit for bit without a bias (with one,
  XLA on the CPU may contract the product and the bias into one FMA)."""
  m, n, k = 5, 384, 2080
  x, w_q, w, s, _ = _int4_drq_inputs(m, n, k, dtype, 7)
  xq, xs = packed_qmatmul.quantize_rows_drq(x.float())
  assert _plan(m, n, k, True, min_steps=MIN_SPLIT_STEPS_1)[-1] == 3
  acc = _twin_acc(xq.numpy(), w.numpy(), nibbles=True,
                  min_steps=MIN_SPLIT_STEPS_1)
  got = _epilogue(acc, xs, s, None, dtype)
  jx = jnp.asarray(x.float().numpy()).astype(
      jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
  want = pallas_qmatmul.qmatmul_pallas_int4_packed_drq(
      jx, jnp.asarray(w.numpy()), jnp.asarray(s.numpy()), interpret=True)
  want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(dtype)
  _assert_bits(got, want)


def test_plan_splits_decode_and_not_prefill():
  """At the main path's shapes on 132 SMs: decode splits K over every
  output tile, at most one cluster of MAX_SPLIT blocks a tile and one
  block per SM; prefill does not split."""
  for nibbles, n, k, min_steps in (
      (False, 2560, 2048, MIN_SPLIT_STEPS), (False, 2048, 2048, MIN_SPLIT_STEPS),
      (True, 2048, 16384, MIN_SPLIT_STEPS), (True, 2560, 2048, MIN_SPLIT_STEPS_1),
      (True, 2048, 2048, MIN_SPLIT_STEPS_1)):
    _, m_tiles, n_tiles, steps, _, split = _plan(64, n, k, nibbles,
                                                 min_steps=min_steps)
    assert m_tiles == 1 and 1 < split <= min(steps, MAX_SPLIT)
    assert m_tiles * n_tiles * split <= H100_SMS
    assert _plan(1024, n, k, nibbles, min_steps=min_steps)[-1] == 1


def test_int4_drq_plan_at_the_server_shapes():
  """#1's plans (make_plan with SplitNibblesRecipB: steps of 128 of the
  K/2 packed bytes, splits of at least MIN_SPLIT_STEPS_1 at one
  warpgroup) at the QKV and out FCs (K 2048: 8 steps): decode (M 64)
  splits 4 ways (80 and 64 blocks), bench.py's M 256 (two warpgroups,
  splits of MIN_SPLIT_STEPS) 2 ways (80 and 64 blocks), prefill (M 1024)
  not at all."""
  for n in (2560, 2048):
    plan = _plan(64, n, 2048, True, min_steps=MIN_SPLIT_STEPS_1)
    assert plan == (64, 1, n // BN, 8, 2, 4)
    plan = _plan(256, n, 2048, True, min_steps=MIN_SPLIT_STEPS_1)
    assert plan == (128, 2, n // BN, 8, 4, 2)
    plan = _plan(1024, n, 2048, True, min_steps=MIN_SPLIT_STEPS_1)
    assert plan[:2] == (128, 8) and plan[-1] == 1


# --------------------------------------------------------------- the sources


@pytest.mark.parametrize('source', ['qmatmul_int8_drq.cu',
                                    'qmatmul_int4_drq_kblock.cu',
                                    'qmatmul_int4_drq.cu'])
def test_kernel_runs_on_the_int8_tensor_core_core(source):
  """The kernels contract on the shared core (wgmma s8 fed by TMA), not
  with SIMT dot products, and export a plan beside their entry point."""
  text = (CSRC / source).read_text()
  assert '#include "int8_tc_gemm.cuh"' in text
  assert '__dp4a' not in text
  assert f'aeqt_{source[:-3]}_plan(' in text
  assert 'wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8' in CORE
  assert 'cp.async.bulk.tensor.2d' in (CSRC / 'tc_ptx.cuh').read_text()


def test_nibble_policies_differ_only_in_the_quantize_formula():
  """#6 keeps the division (rint(x / xs)), #1 takes #15's reciprocal; both
  are the one split-half loader, and #1's source has no SIMT tile."""
  assert 'using SplitNibblesB = SplitNibbles<true, kMinSplitSteps>;' in CORE
  assert ('using SplitNibblesRecipB = SplitNibbles<false, '
          'kMinSplitStepsInt4Drq>;') in CORE
  assert 'kDivide ? v / s : v * inv' in CORE
  one = (CSRC / 'qmatmul_int4_drq.cu').read_text()
  assert 'run<SplitNibblesRecipB' in one and 'launch_qmatmul' not in one
  assert 'run<SplitNibblesB,' in (CSRC / 'qmatmul_int4_drq_kblock.cu').read_text()


def test_plan_fields_match_the_wrapper():
  """The C plan writes as many fields as `_build.PLAN_FIELDS` names."""
  written = {int(i) for i in re.findall(r'\bf\[(\d+)\] =', CORE)}
  assert written == set(range(len(_build.PLAN_FIELDS)))
