"""The decode layer's attention prologue: RMS norm + packed int4 QKV + RoPE
(PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_qkv.py`
(`qkv_rope_pallas`, body `_qkv_rope_kernel`), the JAX executor's
AEQT_ATTN_BLOCK prologue: the pre-attention RMS_NORM, the fused QKV
projection over split-half packed int4 weights, the q/k/v head split and
the half-split rotary embedding of q and k, in one call. On a CUDA tensor
it launches `csrc/qkv_rope.cu` (or raises): at bench.py's shapes the norm
ending in the DRQ codes, then the int8 tensor-core core's pair tile with
the RoPE in its epilogue (weight-only with bf16 x: the norm, then the bf16
core's pair tile); on a CPU tensor it runs `qkv_rope_plain`, which repeats
the kernel's arithmetic.

Numerics (exactly `_qkv_rope_kernel`; cast is bf16 for bf16 x, else f32):
  xn   = ((x * rs.astype(cast)).astype(f32) * gamma).astype(cast), rs the
         row's 1 / sqrt(mean(x^2) + eps) (sum of squares in f64, ops/impl.py
         `rms_inverse`); the unfused RMS_NORM op's rounding, not #14's
  DRQ: xs = max(absmax(xn), 1e-9) * (1/127), xq = rint(xn * (1/xs)); each
         head's projection (acc * xs) * s, int32 sums
  weight-only: the low and high halves contracted in f32 and added, * s
  each head's projection cast to cast, the rope in f32 on it, cast back.
"""

from __future__ import annotations

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels.packed_qmatmul import (
    qmatmul_int4_packed_drq_plain,
    qmatmul_int4_packed_plain,
)
from ai_edge_quantizer_tpu_torch.ops.impl import rms_inverse, rope_freqs


# The launches of a shape (csrc/qkv_rope.cu aeqt_qkv_rope_plan): the route
# (ROUTES), the launches, the norm's grid and threads, then the
# contraction's grid, threads, shared memory, ring stages and rows a tile.
PLAN_FIELDS = ('route', 'launches', 'norm_blocks', 'norm_threads', 'grid_x',
               'grid_y', 'grid_z', 'threads', 'smem_bytes', 'stages',
               'rows_a_tile')
ROUTES = ('drq_pair_tile', 'drq_column_tile_rope_launch', 'bf16_pair_tile',
          'bf16_column_tile_rope_launch', 'f32_simt_rope_launch')


def plan(m: int, d: int, nq: int, nk: int, h: int, drq: bool,
         x_bf16: bool) -> dict:
  """The launches qkv_rope gives a shape (card only), with the route's
  name."""
  p = _build.plan('qkv_rope', 'aeqt_qkv_rope_plan', 'qkv_rope', m, d, nq, nk,
                  h, int(drq), int(x_bf16), fields=PLAN_FIELDS)
  return dict(p, route=ROUTES[p['route']])


def rope_cos_sin(positions: torch.Tensor, h: int, base: float) -> tuple:
  """cos/sin tables for the half-split rope at integer positions
  (pallas_qkv.rope_cos_sin): positions [...] int -> (cos, sin) [..., h//2]
  f32, the angles position * base ** (-i / (h/2)) with the frequencies
  computed on the host as the ROPE op computes them."""
  freqs = rope_freqs(float(base), h // 2, positions.device)
  angles = positions.to(torch.float32)[..., None] * freqs
  return torch.cos(angles), torch.sin(angles)


def _rope_pair(x1, x2, cos, sin):
  """Half-split rotary: (x1*cos - x2*sin, x2*cos + x1*sin)."""
  return x1 * cos - x2 * sin, x2 * cos + x1 * sin


def qkv_norm_plain(x2, gamma, eps):
  """The prologue's norm on rows x2 [M, D] (cast dtype): rounded where the
  unfused RMS_NORM op stores (pallas_qkv.py:77-82)."""
  cast = x2.dtype
  xf = x2.to(torch.float32)
  rs = rms_inverse(xf, eps).to(cast)
  return ((x2 * rs).to(torch.float32)
          * gamma.to(torch.float32).reshape(1, -1)).to(cast)


def _check(x, w_packed, scale, cos, sin, nq, nk, h):
  """(M, D, cast dtype) of a call; ValueError for inconsistent shapes."""
  name = 'qkv_rope'
  qkv_n, d2 = w_packed.shape
  d = 2 * d2
  if qkv_n != (nq + 2 * nk) * h:
    raise ValueError(f'weight rows {qkv_n} != (nq+2nk)*h '
                     f'{(nq + 2 * nk) * h}')
  _build.require(x.shape[-1] == d, name, f'x width {x.shape[-1]} != K {d}')
  m = x.numel() // d
  _build.require(scale.numel() == qkv_n, name, 'scale must have N entries')
  _build.require(cos.numel() == m * (h // 2) == sin.numel(), name,
                 'cos/sin must be [..., h//2] per row')
  cast = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
  return m, d, cast


def qkv_rope_plain(x, gamma, w_packed, scale, cos, sin, *, nq, nk, h,
                   eps=1e-6, drq=True):
  """`_qkv_rope_kernel` in plain PyTorch (any device)."""
  m, d, cast = _check(x, w_packed, scale, cos, sin, nq, nk, h)
  lead = x.shape[:-1]
  x2 = x.reshape(m, d).to(cast)
  xn = qkv_norm_plain(x2, gamma, eps)
  fc = qmatmul_int4_packed_drq_plain if drq else qmatmul_int4_packed_plain
  qkv = fc(xn, w_packed, scale.to(torch.float32))  # [M, N] in cast
  half = h // 2
  c = cos.reshape(m, 1, half).to(torch.float32)
  s = sin.reshape(m, 1, half).to(torch.float32)

  def rope(heads):
    hf = heads.to(torch.float32)
    r1, r2 = _rope_pair(hf[..., :half], hf[..., half:], c, s)
    return torch.cat([r1, r2], dim=-1).to(cast)

  heads = qkv.reshape(m, nq + 2 * nk, h)
  q = rope(heads[:, :nq])
  k = rope(heads[:, nq:nq + nk])
  v = heads[:, nq + nk:]
  return (q.reshape(lead + (nq * h,)), k.reshape(lead + (nk * h,)),
          v.reshape(lead + (nk * h,)))


def qkv_rope(
    x: torch.Tensor,
    gamma: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    nq: int,
    nk: int,
    h: int,
    eps: float = 1e-6,
    drq: bool = True,
) -> tuple:
  """Fused norm + qkv projection + rope (pallas_qkv.qkv_rope_pallas).

  x [..., D] (the residual stream, pre-norm); gamma [D]; w_packed
  [(nq+2*nk)*h, D//2] uint8 split-half packed int4; scale [(nq+2*nk)*h]
  f32; cos/sin [..., h//2] f32 per leading row. Returns (q [..., nq*h],
  k [..., nk*h], v [..., nk*h]) in the cast dtype (bf16 for bf16 x, else
  f32), q and k rope'd, head-major. The JAX wrapper's `bm` (its M tiling)
  has no counterpart here.
  """
  if _build.device_kind(x) == 'cpu':
    qkv_rope.plain_calls += 1
    return qkv_rope_plain(x, gamma, w_packed, scale, cos, sin, nq=nq, nk=nk,
                          h=h, eps=eps, drq=drq)
  name = 'qkv_rope'
  m, d, cast = _check(x, w_packed, scale, cos, sin, nq, nk, h)
  lead = x.shape[:-1]
  x2 = x.reshape(m, d).to(cast).contiguous()
  g = gamma.to(torch.float32).reshape(-1).contiguous()
  s = scale.to(torch.float32).reshape(-1).contiguous()
  c = cos.to(torch.float32).reshape(m, h // 2).contiguous()
  sn = sin.to(torch.float32).reshape(m, h // 2).contiguous()
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  for t, nm in ((g, 'gamma'), (s, 'scale'), (c, 'cos'), (sn, 'sin')):
    _build.require_cuda_tensor(t, name, nm, (torch.float32,))
  _build.require(g.numel() == d, name, 'gamma must have D entries')
  n = w_packed.shape[0]
  xn = torch.empty_like(x2)  # DRQ: the row codes and scales
  qkv = torch.empty((m, n), dtype=cast, device=x2.device)
  q = torch.empty((m, nq * h), dtype=cast, device=x2.device)
  k = torch.empty((m, nk * h), dtype=cast, device=x2.device)
  v = torch.empty((m, nk * h), dtype=cast, device=x2.device)
  fn = _build.entry('qkv_rope', 'aeqt_qkv_rope',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.I, _build.I, _build.I,
                     _build.I, _build.I, _build.F, _build.I, _build.P])
  status = fn(x2.data_ptr(), int(cast == torch.bfloat16), g.data_ptr(),
              w_packed.data_ptr(), s.data_ptr(), c.data_ptr(), sn.data_ptr(),
              xn.data_ptr(), qkv.data_ptr(), q.data_ptr(), k.data_ptr(),
              v.data_ptr(), m, d, nq, nk, h, float(eps), int(drq),
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, D={d}, nq={nq}, nk={nk}, h={h}, '
               f'drq={drq}')
  qkv_rope.launches += 1
  return (q.reshape(lead + (nq * h,)), k.reshape(lead + (nk * h,)),
          v.reshape(lead + (nk * h,)))


qkv_rope.launches = 0
qkv_rope.plain_calls = 0
