"""Packed int4 weights and the int4 DRQ matmul (PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py`: the split-half
int4 layout (`pack_int4_split`, `unpack_int4_split`) and
`qmatmul_pallas_int4_packed_drq`, whose CUDA kernel is
`csrc/qmatmul_int4_drq.cu(h)`. The other Pallas kernels of that file are
not ported yet (see ROADMAP.md).

`qmatmul_int4_packed_drq` has two cases: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs `qmatmul_int4_packed_drq_plain`,
which repeats the kernel's arithmetic in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels.qmatmul import int_matmul_exact

_INV127 = 1.0 / 127.0  # rounded once to f32 where it meets an f32 tensor


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
  _build.require(k % 32 == 0, name, f'K={k} must be a multiple of 32')
  # The block stages 16 quantized rows of x (qmatmul_int4_drq.cuh).
  _build.require(16 * k + 64 <= _build.MAX_SMEM, name,
                 f'K={k} exceeds the shared-memory row budget')
  _build.require_cuda_tensor(w_packed, name, 'w_packed', (torch.uint8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  fn = _build.entry('qmatmul_int4_drq', 'aeqt_qmatmul_int4_drq',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.I, _build.I, _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
              w_packed.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              m, n, k, _build.stream_ptr(x2.device))
  _build.check(status, name)
  qmatmul_int4_packed_drq.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int4_packed_drq.launches = 0
qmatmul_int4_packed_drq.plain_calls = 0
