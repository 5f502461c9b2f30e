"""Greedy head: logits matmul + argmax without the logits (PyTorch + CUDA).

Port of `head_argmax_pallas` in `ai_edge_quantizer_tpu/kernels/
pallas_head.py` (`_head_argmax_kernel`). The DRQ branches (int8 [N, K]
weights, the tied Gemma embedding head, and split-half packed int4
[N, K/2]) run the CUDA kernels of `csrc/head_argmax.cu` on a CUDA tensor.
The non-DRQ (bf16) branches have a plain version only; on a CUDA tensor
they raise until their kernel is ported.

Each logit is rounded to the activation dtype before the comparison (the
Pallas kernel's `cast_dt`), columns >= true_n never win, and ties go to
the first index, as `jnp.argmax` breaks them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels.packed_qmatmul import (
    quantize_rows_drq,
    unpack_int4_split,
)
from ai_edge_quantizer_tpu_torch.kernels.qmatmul import int_matmul_exact

_NEG_INF = -3.4e38  # pallas_head._NEG_INF
_HEAD_BN = 64       # vocab columns per block of head_argmax.cu


def head_argmax_plain(x, w_q, scale, *, packed, true_n=None, drq=True):
  """`_head_argmax_kernel` in plain PyTorch (any device)."""
  y = head_logits_plain(x, w_q, scale, packed=packed, true_n=true_n, drq=drq)
  # torch.argmax returns the first maximal index, like jnp.argmax.
  return torch.argmax(y, dim=-1).to(torch.int32).reshape(x.shape[:-1])


def head_logits_plain(x, w_q, scale, *, packed, true_n=None, drq=True):
  """The f32 logits [M, N] the head compares: rounded to the activation
  dtype, columns >= true_n set to -3.4e38."""
  n = w_q.shape[0]
  k = w_q.shape[1] * 2 if packed else w_q.shape[1]
  true_n = n if true_n is None else min(true_n, n)
  x2 = x.reshape(-1, k).to(torch.float32)
  w = unpack_int4_split(w_q) if packed else w_q
  s = scale.to(torch.float32).reshape(1, n)
  if drq:
    xq, xs = quantize_rows_drq(x2)
    y = int_matmul_exact(xq, w).to(torch.float32) * xs * s
  else:
    xb = x2.to(torch.bfloat16).to(torch.float32)
    y = torch.matmul(xb, w.to(torch.float32).T) * s
  cast_dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
  y = y.to(cast_dt).to(torch.float32)
  col = torch.arange(n, device=x.device).reshape(1, n)
  return torch.where(col < true_n, y, _NEG_INF)


def head_argmax(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    *,
    packed: bool,
    true_n: Optional[int] = None,
    drq: bool = True,
) -> torch.Tensor:
  """argmax over the quantized logits head -> int32 ids [...].

  x [..., K] float; w_q [N, K//2] uint8 (packed int4 split-half) or [N, K]
  int8; scale [N] f32 per channel; rows >= true_n (default N) are padding.
  """
  if _build.device_kind(x) == 'cpu':
    head_argmax.plain_calls += 1
    return head_argmax_plain(x, w_q, scale, packed=packed, true_n=true_n,
                             drq=drq)
  name = 'head_argmax'
  if not drq:
    raise NotImplementedError(
        f'{name}: drq=False (bf16 weight-only head) has no CUDA kernel yet.')
  n = w_q.shape[0]
  k = w_q.shape[1] * 2 if packed else w_q.shape[1]
  true_n = n if true_n is None else min(true_n, n)
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k)
  if x2.dtype not in (torch.float32, torch.bfloat16):
    x2 = x2.to(torch.float32)
  x2 = x2.contiguous()
  m = x2.shape[0]
  _build.require(k % 32 == 0, name, f'K={k} must be a multiple of 32')
  _build.require(16 * k + 1088 <= _build.MAX_SMEM, name, f'K={k} too wide')
  _build.require_cuda_tensor(
      w_q, name, 'w_q', (torch.uint8,) if packed else (torch.int8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  tiles = -(-n // _HEAD_BN)
  dev = x2.device
  pmax = torch.empty((m, tiles), dtype=torch.float32, device=dev)
  pidx = torch.empty((m, tiles), dtype=torch.int32, device=dev)
  ids = torch.empty((m,), dtype=torch.int32, device=dev)
  fn = _build.entry('head_argmax', 'aeqt_head_argmax',
                    [_build.P, _build.I, _build.P, _build.I, _build.P,
                     _build.P, _build.P, _build.P] + [_build.I] * 5
                    + [_build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
              int(packed), scale.data_ptr(), pmax.data_ptr(), pidx.data_ptr(),
              ids.data_ptr(), m, n, k, true_n,
              int(x.dtype == torch.bfloat16), _build.stream_ptr(dev))
  _build.check(status, name)
  head_argmax.launches += 1
  return ids.reshape(lead)


head_argmax.launches = 0
head_argmax.plain_calls = 0
