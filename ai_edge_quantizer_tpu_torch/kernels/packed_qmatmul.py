"""Packed int4 weights and the packed int4 matmuls (PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py`: the split-half
int4 layout (`pack_int4_split`, `unpack_int4_split`) and five of its
Pallas kernels over packed weights:

  * `qmatmul_pallas_int4_packed_drq` as `qmatmul_int4_packed_drq`, CUDA
    kernel `csrc/qmatmul_int4_drq.cu` on the int8 tensor-core core
    `csrc/int8_tc_gemm.cuh` (K <= 8192 on the executor's route);
  * `qmatmul_pallas_int4_packed_drq_kblock` as
    `qmatmul_int4_packed_drq_kblock`, CUDA kernel
    `csrc/qmatmul_int4_drq_kblock.cu` on the int8 tensor-core core
    `csrc/int8_tc_gemm.cuh` (DRQ with K > 8192);
  * `qmatmul_pallas_int4_packed` (weight-only, the JAX executor's default
    for packed FCs) as `qmatmul_int4_packed`, CUDA kernel
    `csrc/qmatmul_int4_weight_only.cu` on the bf16 tensor-core core
    `csrc/int4_bf16_tc_gemm.cuh` for bf16 x (SIMT f32 for f32 x);
  * `qmatmul_pallas_int4_packed_blockwise` (one scale per block of bs
    K-columns, bs % 128 == 0) as `qmatmul_int4_packed_blockwise`, CUDA
    kernel `csrc/qmatmul_int4_blockwise.cu`, the same core for bf16 x;
  * `qmatmul_pallas_int4_packed_rmsnorm` (RMS norm times gamma ahead of
    the weight-only matmul, the JAX executor's AEQT_NORM_FUSION) as
    `qmatmul_int4_packed_rmsnorm`, CUDA kernel
    `csrc/qmatmul_int4_rmsnorm.cu`.

Each wrapper has two cases: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the `..._plain` function, which repeats the kernel's
arithmetic in plain PyTorch. Each counts its launches and its plain runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels.qmatmul import int_matmul_exact
from ai_edge_quantizer_tpu_torch.ops import impl as ops_impl

_INV127 = 1.0 / 127.0  # rounded once to f32 where it meets an f32 tensor
# The bf16 tensor-core core's launch (csrc/int4_bf16_tc_gemm.cuh
# plan_fields): _build.plan's fields and the tokens of a tile.
INT4_BF16_PLAN_FIELDS = _build.PLAN_FIELDS + ('tile_tokens',)
# The norm-fused FC's two launches (csrc/qmatmul_int4_rmsnorm.cu
# aeqt_qmatmul_int4_rmsnorm_plan): the norm's grid and threads, then the
# contraction's INT4_BF16_PLAN_FIELDS (bf16 x; f32 x the SIMT kernel's).
RMSNORM_PLAN_FIELDS = ('norm_grid', 'norm_threads') + INT4_BF16_PLAN_FIELDS


def pack_int4_split(w_q: torch.Tensor) -> torch.Tensor:
  """Pack int4 values (int8 container) [N, K] -> uint8 [N, K//2].

  Split-half layout: byte j holds (w[j] & 0xF) | (w[j + K/2] << 4).
  """
  k = w_q.shape[1]
  lo = w_q[:, : k // 2].to(torch.uint8) & 0xF
  hi = w_q[:, k // 2:].to(torch.uint8) & 0xF
  return (lo | (hi << 4)).contiguous()


def unpack_int4_split(packed: torch.Tensor) -> torch.Tensor:
  """Inverse of pack_int4_split: uint8 [N, K//2] -> int8 [N, K]."""
  lo = (packed & 0xF).to(torch.int8)
  hi = (packed >> 4).to(torch.int8)
  lo = torch.where(lo >= 8, lo - 16, lo)
  hi = torch.where(hi >= 8, hi - 16, hi)
  return torch.cat([lo, hi], dim=1)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
  """The kernels' compute dtype: bf16 for bf16 inputs, else f32."""
  return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def quantize_rows_drq(x2f: torch.Tensor):
  """In-kernel DRQ of f32 rows: xs = max(absmax, 1e-9) * (1/127), then
  rint(x * (1/xs)) (pallas_qmatmul.py:590-594). Returns (xq int8, xs)."""
  absmax = torch.amax(torch.abs(x2f), dim=-1, keepdim=True)
  xs = torch.clamp_min(absmax, 1e-9) * _INV127
  xq = torch.round(x2f * torch.reciprocal(xs)).to(torch.int8)
  return xq, xs


def qmatmul_int4_packed_drq_plain(x, w_packed, scale, bias=None):
  """The kernel's arithmetic in plain PyTorch (any device)."""
  n, k2 = w_packed.shape
  k = 2 * k2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(compute_dtype(x)).to(torch.float32)
  xq, xs = quantize_rows_drq(x2)
  acc = int_matmul_exact(xq, unpack_int4_split(w_packed))
  y = acc.to(torch.float32) * xs * scale.to(torch.float32).reshape(1, n)
  if bias is not None:
    y = y + bias.to(torch.float32).reshape(1, n)
  return y.to(compute_dtype(x)).to(x.dtype).reshape(lead + (n,))


def qmatmul_int4_packed_drq(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """DRQ x [..., K] . packed int4 [N, K//2] -> [..., N] in x.dtype.

  x is quantized per row to int8 (xs = max(absmax, 1e-9)/127 in the
  kernel's reciprocal form), contracted against the sign-extended nibbles
  in int32, and scaled as (acc * xs) * scale (+ bias).
  """
  if _build.device_kind(x) == 'cpu':
    qmatmul_int4_packed_drq.plain_calls += 1
    return qmatmul_int4_packed_drq_plain(x, w_packed, scale, bias)
  name = 'qmatmul_int4_packed_drq'
  n, k2 = w_packed.shape
  k = 2 * k2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
  xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
  fn = _build.entry('qmatmul_int4_drq', 'aeqt_qmatmul_int4_drq',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.P, _build.I, _build.I,
                     _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
              w_packed.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              xq.data_ptr(), xs.data_ptr(), m, n, k,
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, N={n}, K={k}')
  qmatmul_int4_packed_drq.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int4_packed_drq.launches = 0
qmatmul_int4_packed_drq.plain_calls = 0


def quantize_rows_drq_div(x2f: torch.Tensor):
  """The K-blocked kernel's DRQ of f32 rows, which the JAX function runs
  outside its Pallas kernel: xs = max(absmax, 1e-9) * (1/127), then
  rint(x / xs) -- a division, where quantize_rows_drq multiplies by the
  reciprocal (pallas_qmatmul.py:830-834). Returns (xq int8, xs)."""
  absmax = torch.amax(torch.abs(x2f), dim=-1, keepdim=True)
  xs = torch.clamp_min(absmax, 1e-9) * _INV127
  xq = torch.round(x2f / xs).to(torch.int8)
  return xq, xs


def qmatmul_int4_packed_drq_kblock_plain(x, w_packed, scale, bias=None):
  """The K-blocked kernel's arithmetic in plain PyTorch (any device)."""
  n, k2 = w_packed.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, 2 * k2).to(torch.float32)
  xq, xs = quantize_rows_drq_div(x2)
  acc = int_matmul_exact(xq, unpack_int4_split(w_packed))
  y = acc.to(torch.float32) * xs * scale.to(torch.float32).reshape(1, n)
  if bias is not None:
    y = y + bias.to(torch.float32).reshape(1, n)
  return y.to(compute_dtype(x)).to(x.dtype).reshape(lead + (n,))


def qmatmul_int4_packed_drq_kblock(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """DRQ x [..., K] . packed int4 [N, K//2] -> [..., N] in x.dtype, for
  any K the kernel takes (the executor sends it K > 8192).

  Each row of x is quantized once to int8 (xs = max(absmax, 1e-9)/127,
  codes rint(x / xs)), contracted against the sign-extended nibbles in
  int32 over K-blocks, and scaled as (acc * xs) * scale (+ bias).
  """
  if _build.device_kind(x) == 'cpu':
    qmatmul_int4_packed_drq_kblock.plain_calls += 1
    return qmatmul_int4_packed_drq_kblock_plain(x, w_packed, scale, bias)
  name = 'qmatmul_int4_packed_drq_kblock'
  n, k2 = w_packed.shape
  k = 2 * k2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
  xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
  fn = _build.entry('qmatmul_int4_drq_kblock', 'aeqt_qmatmul_int4_drq_kblock',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.P, _build.I, _build.I,
                     _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
              w_packed.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              xq.data_ptr(), xs.data_ptr(), m, n, k,
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, N={n}, K={k}')
  qmatmul_int4_packed_drq_kblock.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int4_packed_drq_kblock.launches = 0
qmatmul_int4_packed_drq_kblock.plain_calls = 0


def qmatmul_int4_packed_plain(x, w_packed, scale, bias=None):
  """Weight-only x [..., K] . packed int4 [N, K//2] -> [..., N], the
  arithmetic of pallas_qmatmul._int4_channelwise_kernel: x in the compute
  dtype (bf16 for bf16 x, else f32; bf16 products are exact in f32), the
  low and high halves contracted in f32 and added, y = acc * s (+ b),
  stored in the compute dtype, then cast to x's dtype."""
  n, k2 = w_packed.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, 2 * k2).to(compute_dtype(x)).to(torch.float32)
  w = unpack_int4_split(w_packed).to(torch.float32)
  acc = (torch.matmul(x2[:, :k2], w[:, :k2].T)
         + torch.matmul(x2[:, k2:], w[:, k2:].T))
  y = acc * scale.to(torch.float32).reshape(1, n)
  if bias is not None:
    y = y + bias.to(torch.float32).reshape(1, n)
  return y.to(compute_dtype(x)).to(x.dtype).reshape(lead + (n,))


def qmatmul_int4_packed(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Weight-only x [..., K] . packed int4 [N, K//2] -> [..., N] in x.dtype
  (pallas_qmatmul.qmatmul_pallas_int4_packed): x in the compute dtype, the
  two halves contracted in f32 and added, y = acc * s (+ b) stored in the
  compute dtype (qmatmul_int4_packed_plain has the arithmetic)."""
  if _build.device_kind(x) == 'cpu':
    qmatmul_int4_packed.plain_calls += 1
    return qmatmul_int4_packed_plain(x, w_packed, scale, bias)
  name = 'qmatmul_int4_packed'
  n, k2 = w_packed.shape
  k = 2 * k2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  fn = _build.entry('qmatmul_int4_weight_only',
                    'aeqt_qmatmul_int4_weight_only',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.I, _build.I, _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
              w_packed.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              m, n, k, _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, N={n}, K={k}')
  qmatmul_int4_packed.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int4_packed.launches = 0
qmatmul_int4_packed.plain_calls = 0


def qmatmul_int4_packed_blockwise_plain(x, w_packed, scale, bias=None):
  """Blockwise x [..., K] . packed int4 [N, K//2] -> [..., N] with scale
  [N, K // bs], the arithmetic of pallas_qmatmul._int4_blockwise_2d_kernel:
  x in the compute dtype, an f32 output; for each byte block j in order,
  the low-nibble block (scale column j) and the high-nibble block (column
  nb/2 + j) contract in f32 and y += p_lo * s_lo + p_hi * s_hi; the bias
  comes after the last block; the result is cast to x's dtype."""
  n, k2 = w_packed.shape
  nb2 = scale.shape[-1] // 2
  bs = k2 // nb2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, 2 * k2).to(compute_dtype(x)).to(torch.float32)
  w = unpack_int4_split(w_packed).to(torch.float32)
  s = scale.to(torch.float32).reshape(n, 2 * nb2)
  y = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
  for j in range(nb2):
    lo = slice(j * bs, (j + 1) * bs)            # low nibbles, block j
    hi = slice(k2 + j * bs, k2 + (j + 1) * bs)  # high nibbles, block nb2 + j
    p_lo = torch.matmul(x2[:, lo], w[:, lo].T)
    p_hi = torch.matmul(x2[:, hi], w[:, hi].T)
    y = y + (p_lo * s[:, j] + p_hi * s[:, nb2 + j])
  if bias is not None:
    y = y + bias.to(torch.float32).reshape(1, n)
  return y.to(x.dtype).reshape(lead + (n,))


def qmatmul_int4_packed_blockwise(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Blockwise x [..., K] . packed int4 [N, K//2] -> [..., N] in x.dtype,
  scale [N, K // bs] (pallas_qmatmul.qmatmul_pallas_int4_packed_blockwise):
  x in the compute dtype, each byte block's two partials scaled and added
  in block order in f32, the bias last
  (qmatmul_int4_packed_blockwise_plain has the arithmetic)."""
  if _build.device_kind(x) == 'cpu':
    qmatmul_int4_packed_blockwise.plain_calls += 1
    return qmatmul_int4_packed_blockwise_plain(x, w_packed, scale, bias)
  name = 'qmatmul_int4_packed_blockwise'
  n, k2 = w_packed.shape
  k = 2 * k2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _build.require(scale.dim() == 2 and scale.shape[0] == n, name,
                 f'scale shape {tuple(scale.shape)} must be [N, K/bs]')
  nb = scale.shape[1]
  _build.require(nb > 0 and k % nb == 0, name, f'K={k} over {nb} blocks')
  bs = k // nb
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  scale = scale.to(torch.float32).contiguous()
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  fn = _build.entry('qmatmul_int4_blockwise', 'aeqt_qmatmul_int4_blockwise',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.I, _build.I, _build.I, _build.I,
                     _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
              w_packed.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              m, n, k, bs, _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, N={n}, K={k}, block size {bs}')
  qmatmul_int4_packed_blockwise.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int4_packed_blockwise.launches = 0
qmatmul_int4_packed_blockwise.plain_calls = 0


def rmsnorm_gamma_plain(x, gamma, eps=1e-6):
  """The norm of pallas_qmatmul._int4_channelwise_norm_kernel on the rows of
  x [M, K]: xn = (xf * rsqrt(mean(xf^2) + eps)).astype(compute) *
  gamma.astype(compute), both the cast and the product rounded in the
  compute dtype (bf16 for bf16 x, else f32). The sum of squares is taken
  in f64 (ops/impl.py `rms_inverse`)."""
  cdt = compute_dtype(x)
  xf = x.to(cdt).to(torch.float32)
  return (xf * ops_impl.rms_inverse(xf, eps)).to(cdt) * gamma.to(cdt).reshape(1, -1)


def qmatmul_int4_packed_rmsnorm_plain(x, gamma, w_packed, scale, bias=None,
                                      eps=1e-6):
  """The fused kernel's arithmetic in plain PyTorch (any device): the norm
  (rmsnorm_gamma_plain), then the weight-only matmul's
  (qmatmul_int4_packed_plain) on the normalized rows."""
  k = 2 * w_packed.shape[1]
  lead = x.shape[:-1]
  xn = rmsnorm_gamma_plain(x.reshape(-1, k), gamma, eps)
  y = qmatmul_int4_packed_plain(xn, w_packed, scale, bias)
  return y.to(x.dtype).reshape(lead + (w_packed.shape[0],))


def qmatmul_int4_packed_rmsnorm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
  """rms_norm(x) * gamma . packed int4 [N, K//2] -> [..., N] in x.dtype
  (pallas_qmatmul.qmatmul_pallas_int4_packed_rmsnorm): weight-only, the
  norm rounded in the compute dtype, f32 sums, y = acc * s (+ b)
  (qmatmul_int4_packed_rmsnorm_plain has the arithmetic). The JAX
  wrapper's `bn` is its VMEM tiling and has no counterpart here."""
  if _build.device_kind(x) == 'cpu':
    qmatmul_int4_packed_rmsnorm.plain_calls += 1
    return qmatmul_int4_packed_rmsnorm_plain(x, gamma, w_packed, scale, bias,
                                             eps)
  name = 'qmatmul_int4_packed_rmsnorm'
  n, k2 = w_packed.shape
  k = 2 * k2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  g = gamma.to(torch.float32).reshape(-1).contiguous()
  _build.require_cuda_tensor(g, name, 'gamma', (torch.float32,))
  _build.require(g.numel() == k, name, 'gamma must have K entries')
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  xn = torch.empty_like(x2)
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  fn = _build.entry('qmatmul_int4_rmsnorm', 'aeqt_qmatmul_int4_rmsnorm',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.P, _build.I, _build.I,
                     _build.I, _build.F, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), g.data_ptr(),
              w_packed.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), xn.data_ptr(),
              out.data_ptr(), m, n, k, float(eps),
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, N={n}, K={k}')
  qmatmul_int4_packed_rmsnorm.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int4_packed_rmsnorm.launches = 0
qmatmul_int4_packed_rmsnorm.plain_calls = 0


def rmsnorm_plan(m: int, n: int, k: int, x_bf16: bool = True) -> dict:
  """The launches qmatmul_int4_packed_rmsnorm gives a shape (card only)."""
  return _build.plan('qmatmul_int4_rmsnorm', 'aeqt_qmatmul_int4_rmsnorm_plan',
                     'qmatmul_int4_packed_rmsnorm', m, n, k, int(x_bf16),
                     fields=RMSNORM_PLAN_FIELDS)
