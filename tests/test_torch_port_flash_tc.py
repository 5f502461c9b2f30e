"""The tensor-core flash attention (#9, `csrc/flash_attention_int8.cu`) on
the CPU, where no CUDA kernel runs: a PyTorch twin of the kernel's
arithmetic held against the plain version and the TPU kernel.

The kernel runs both contractions on bf16 / fp16 tensor cores with f32
sums: q . k with q in bf16 parts (one for bf16 q, `kQPartsF32` for f32 q),
p . V with p * `kPScale` in `kPParts` fp16 parts, over key tiles of `kBS`
(keys past S score -1e30), with the online softmax between them. The twin
repeats exactly that, the f32 sums in the CPU's order, and must stay
within 1e-5 * max(|y|, 1) of `flash_attention_int8_masked_plain` and of
interpret-mode Pallas `flash_attention_int8_masked` -- the bound the card
holds the kernel to in chip_smoke.py -- while a split with one part fewer
(of q, of p) must fail it. The constants are read from the kernel's
source.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import attention

CSRC = pathlib.Path(_build.CSRC)
SOURCE = (CSRC / 'flash_attention_int8.cu').read_text()


def _const(name):
  found = re.search(rf'constexpr (?:int|float) {name} = ([0-9.]+)f?;',
                    SOURCE)
  assert found, name
  return float(found.group(1))


BS = int(_const('kBS'))
Q_PARTS_F32 = int(_const('kQPartsF32'))
P_PARTS = int(_const('kPParts'))
P_SCALE = _const('kPScale')
K_SCALE, V_SCALE, ZP_K, ZP_V = 0.06, 0.06, 3.0, -2.0


def _parts(x, n, dtype):
  """n parts of x in `dtype` whose sum is x (to the parts' precision):
  each part rounds what the earlier ones left."""
  parts, rest = [], x
  for _ in range(n):
    part = rest.to(dtype)
    parts.append(part)
    rest = rest - part.to(torch.float32)
  return parts


def twin(q, k_cache, v_cache, mask, q_parts=None, p_parts=P_PARTS):
  """The kernel's arithmetic: [B, NK, R, H] f32."""
  b, nk, r, h = q.shape
  s = k_cache.shape[2]
  qf = q.to(torch.float32)
  if q.dtype == torch.bfloat16:
    qp = [q]
  else:
    qp = _parts(qf, q_parts or Q_PARTS_F32, torch.bfloat16)
  q_sum = torch.sum(qf, dim=-1, keepdim=True)
  ks = attention.score_scale(K_SCALE, h)
  maskf = mask.to(torch.float32).expand(b, nk, r, s)
  m = torch.full((b, nk, r, 1), -1e30)
  l = torch.zeros((b, nk, r, 1))
  acc = torch.zeros((b, nk, r, h))
  for s0 in range(0, s, BS):
    ns = min(BS, s - s0)
    # TMA fills keys past S with zeros; their scores are -1e30.
    kb = torch.zeros((b, nk, BS, h))
    vb = torch.zeros((b, nk, BS, h))
    kb[:, :, :ns] = k_cache[:, :, s0:s0 + ns].to(torch.float32)
    vb[:, :, :ns] = v_cache[:, :, s0:s0 + ns].to(torch.float32)
    mb = torch.zeros((b, nk, r, BS))
    mb[..., :ns] = maskf[..., s0:s0 + ns]
    sc = sum(torch.matmul(p.to(torch.float32), kb.transpose(-1, -2))
             for p in reversed(qp))  # the smallest part first
    sc = (sc - ZP_K * q_sum) * ks + mb
    sc[..., ns:] = -1e30
    m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(sc - m_new)
    l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
    m = m_new
    pv = sum(torch.matmul(x.to(torch.float32), vb)
             for x in _parts(p * P_SCALE, p_parts, torch.float16))
    acc = acc * alpha + pv
  return (acc / P_SCALE / torch.clamp_min(l, 1e-30) - ZP_V) * float(
      np.float32(V_SCALE))


def _inputs(b, nk, r, s, h, mask_nk, q_dtype, start, seed):
  """q, caches and the prefill device mask of the chunk at `start` (query
  row (g, t) sees keys <= start + t, G = R / T with T = R / 8), with one
  fully masked row; mask_nk NK gives each kv head its own mask."""
  rng = np.random.default_rng(seed)
  q = torch.from_numpy(rng.standard_normal((b, nk, r, h)).astype(np.float32))
  k_cache, v_cache = (torch.from_numpy(
      rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8))
                      for _ in range(2))
  t = r // 8
  pos = start + np.arange(r) % t
  rows = np.where(np.arange(s)[None, :] <= pos[:, None], 0.0, -1e9)
  mask = np.broadcast_to(rows, (b, mask_nk, r, s)).astype(np.float32).copy()
  if mask_nk > 1:
    mask[:, 1:] = mask[:, 1:, ::-1]
  mask[0, 0, 3] = -1e9  # a fully masked row averages every V row
  return q.to(q_dtype), k_cache, v_cache, torch.from_numpy(mask)


def _bound(want):
  return 1e-5 * max(float(torch.max(torch.abs(want))), 1.0)


def _plain(q, k_cache, v_cache, mask):
  return attention.flash_attention_int8_masked_plain(
      q, k_cache, v_cache, K_SCALE, V_SCALE, mask, k_zero_point=ZP_K,
      v_zero_point=ZP_V)


def _pallas(q, k_cache, v_cache, mask):
  def j(t):
    return jnp.asarray(t.to(torch.float32).numpy())
  qj = j(q).astype(jnp.bfloat16) if q.dtype == torch.bfloat16 else j(q)
  out = pallas_attention.flash_attention_int8_masked(
      qj, jnp.asarray(k_cache.numpy()), jnp.asarray(v_cache.numpy()),
      K_SCALE, V_SCALE, j(mask), k_zero_point=ZP_K, v_zero_point=ZP_V,
      interpret=True)
  return torch.from_numpy(np.array(out))


# (b, nk, r, s, h, mask_nk): H 64, 128 and 256; one mask for all kv heads
# and one each; S a multiple of the key tile and a ragged S (200, 320 + 40).
SHAPES = [(1, 2, 64, 256, 64, 1), (1, 2, 64, 200, 64, 2),
          (1, 2, 128, 256, 128, 2), (2, 1, 64, 360, 128, 1),
          (1, 1, 64, 256, 256, 1), (1, 2, 64, 200, 256, 2)]


@pytest.mark.parametrize('q_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,nk,r,s,h,mask_nk', SHAPES)
def test_twin_holds_the_bound(b, nk, r, s, h, mask_nk, q_dtype):
  q, k_cache, v_cache, mask = _inputs(b, nk, r, s, h, mask_nk, q_dtype,
                                      start=s // 3, seed=r + s + h + nk)
  got = twin(q, k_cache, v_cache, mask)
  assert torch.all(torch.isfinite(got))
  for want in (_plain(q, k_cache, v_cache, mask),
               _pallas(q, k_cache, v_cache, mask)):
    err = float(torch.max(torch.abs(got - want)))
    assert err <= _bound(want), (err, _bound(want))


@pytest.mark.parametrize('q_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('chunk', [0, 3])
def test_twin_at_the_server_width(chunk, q_dtype):
  """One (b, nk) row of the server's prefill pass: R = G * T = 8 * 128,
  S 1024, H 256, the causal masks of chunks 0 and 3."""
  q, k_cache, v_cache, mask = _inputs(1, 1, 1024, 1024, 256, 1, q_dtype,
                                      start=128 * chunk, seed=chunk)
  got = twin(q, k_cache, v_cache, mask)
  for want in (_plain(q, k_cache, v_cache, mask),
               _pallas(q, k_cache, v_cache, mask)):
    err = float(torch.max(torch.abs(got - want)))
    assert err <= _bound(want), (err, _bound(want))


@pytest.mark.parametrize('fewer', ['p', 'q'])
def test_one_part_fewer_fails_the_bound(fewer):
  """At the server width each split is needed: p in one fp16 part fewer
  (bf16 q), or an f32 q in one bf16 part fewer, misses 1e-5."""
  q_dtype = torch.bfloat16 if fewer == 'p' else torch.float32
  q, k_cache, v_cache, mask = _inputs(1, 1, 1024, 1024, 256, 1, q_dtype,
                                      start=0, seed=0)
  want = _plain(q, k_cache, v_cache, mask)
  kw = ({'p_parts': P_PARTS - 1} if fewer == 'p'
        else {'q_parts': Q_PARTS_F32 - 1})
  err = float(torch.max(torch.abs(twin(q, k_cache, v_cache, mask, **kw)
                                  - want)))
  assert err > _bound(want), (err, _bound(want))


def test_kernel_contracts_on_the_tensor_cores():
  """Both contractions are wgmma (bf16 scores from shared memory, fp16
  P . V with P in registers and V MN-major), fed by TMA; no SIMT dot
  products and no library call; H 384 stays refused."""
  assert 'wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16' in SOURCE
  assert 'wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16' in SOURCE
  assert 'tma_load_3d(' in SOURCE
  ptx = (CSRC / 'tc_ptx.cuh').read_text()
  assert 'cp.async.bulk.tensor.3d' in ptx
  assert 'fmaf(' not in SOURCE
  for call in ('cublas', 'cudnn', 'scaled_dot_product'):
    assert call not in SOURCE.lower()
  takes = SOURCE[SOURCE.index('bool takes('):]
  takes = takes[:takes.index('}')]
  assert 'H == 64 || H == 128 || H == 192 || H == 256' in takes
  assert 'aeqt_flash_attention_int8_plan(' in SOURCE


def test_wrapper_reads_q_and_mask_as_they_come():
  """The wrapper passes f32 and bf16 q and masks through (no f32 copy of a
  bf16 q or mask) and tells the kernel which they are."""
  text = pathlib.Path(attention.__file__).read_text()
  body = text[text.index('def flash_attention_int8_masked('):]
  body = body[:body.index('flash_attention_int8_masked.launches = 0')]
  assert 'int(q2.dtype == torch.bfloat16)' in body
  assert 'int(m2.dtype == torch.bfloat16)' in body
