"""Greedy head: logits matmul + argmax without the logits (PyTorch + CUDA).

Port of `head_argmax_pallas` in `ai_edge_quantizer_tpu/kernels/
pallas_head.py` (`_head_argmax_kernel`). The DRQ branches (int8 [N, K]
weights, the tied Gemma embedding head, and split-half packed int4
[N, K/2]) run the CUDA kernels of `csrc/head_argmax.cu` on a CUDA tensor:
the int8 tensor-core core's row quantize, then its tiles with an argmax
epilogue (one (max, first index) pair a row and 128-column tile) and a
reduction of the pairs. The weight-only (bf16, drq=False) branches run
there too, through their own entry point: a persistent grid of bf16
tensor-core tiles whose weight stream serves every row of a pass, with the
same argmax epilogue and reduction. `head_argmax` dispatches on
`drq`; the weight-only branch is also `head_argmax_bf16`, which keeps its
own launch and plain-run counts.
In that branch x is rounded to bf16 whatever its dtype and the weights
are taken as bf16 values, with f32 sums (on tensor cores on the card).

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
# Vocab columns of the weight-only branch's narrowest tile (two warpgroups
# of 64 rows; 256 at M <= 64): its pairs' scratch holds N / 128 a row.
_HEAD_BN = 128
_HEAD_DRQ_BN = 128  # vocab columns per tile of the DRQ branch (wgmma n128)
# The DRQ branch's tile launch (csrc/head_argmax.cu aeqt_head_argmax_plan).
DRQ_PLAN_FIELDS = ('blocks', 'row_tiles', 'col_tiles', 'threads',
                   'smem_bytes', 'stages')
# The weight-only branch's pairs launch (aeqt_head_argmax_bf16_plan).
WO_PLAN_FIELDS = ('blocks', 'tile_rows', 'vocab_tiles', 'tokens_a_pass',
                  'passes', 'threads', 'smem_bytes', 'stages')


def drq_plan(m: int, n: int, k: int, packed: bool) -> dict:
  """The tile launch head_argmax's DRQ branch gives a shape (card only)."""
  return _build.plan('head_argmax', 'aeqt_head_argmax_plan', 'head_argmax',
                     m, n, k, int(packed), fields=DRQ_PLAN_FIELDS)


def wo_plan(m: int, n: int, k: int, packed: bool) -> dict:
  """The pairs launch head_argmax_bf16 gives a shape (card only)."""
  return _build.plan('head_argmax', 'aeqt_head_argmax_bf16_plan',
                     'head_argmax_bf16', m, n, k, int(packed),
                     fields=WO_PLAN_FIELDS)


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
  drq=False runs the weight-only branch, `head_argmax_bf16`.
  """
  if not drq:
    return head_argmax_bf16(x, w_q, scale, packed=packed, true_n=true_n)
  if _build.device_kind(x) == 'cpu':
    head_argmax.plain_calls += 1
    return head_argmax_plain(x, w_q, scale, packed=packed, true_n=true_n,
                             drq=True)
  name = 'head_argmax'
  k = w_q.shape[1] * 2 if packed else w_q.shape[1]
  x2 = x.reshape(-1, k)
  if x2.dtype not in (torch.float32, torch.bfloat16):
    x2 = x2.to(torch.float32)
  x2 = x2.contiguous()
  n, true_n, pmax, pidx, ids = _scratch(name, x2, w_q, scale, packed, true_n,
                                        _HEAD_DRQ_BN)
  m = x2.shape[0]
  xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
  xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
  fn = _build.entry('head_argmax', 'aeqt_head_argmax',
                    [_build.P, _build.I, _build.P, _build.I] + [_build.P] * 6
                    + [_build.I] * 5 + [_build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
              int(packed), scale.data_ptr(), xq.data_ptr(), xs.data_ptr(),
              pmax.data_ptr(), pidx.data_ptr(), ids.data_ptr(), m, n, k,
              true_n, int(x.dtype == torch.bfloat16),
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m}, N={n}, K={k}')
  head_argmax.launches += 1
  return ids.reshape(x.shape[:-1])


head_argmax.launches = 0
head_argmax.plain_calls = 0


def head_argmax_bf16(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    *,
    packed: bool,
    true_n: Optional[int] = None,
) -> torch.Tensor:
  """The weight-only branch of head_argmax (drq=False), same arguments: x
  rounded to bf16 whatever its dtype, the logits on tensor cores with f32
  sums (in another order than the plain version's), each rounded to x's
  dtype."""
  if _build.device_kind(x) == 'cpu':
    head_argmax_bf16.plain_calls += 1
    return head_argmax_plain(x, w_q, scale, packed=packed, true_n=true_n,
                             drq=False)
  name = 'head_argmax_bf16'
  k = w_q.shape[1] * 2 if packed else w_q.shape[1]
  x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
  n, true_n, pmax, pidx, ids = _scratch(name, x2, w_q, scale, packed, true_n)
  fn = _build.entry('head_argmax', 'aeqt_head_argmax_bf16',
                    [_build.P, _build.P, _build.I, _build.P, _build.P,
                     _build.P, _build.P] + [_build.I] * 5 + [_build.P])
  status = fn(x2.data_ptr(), w_q.data_ptr(), int(packed), scale.data_ptr(),
              pmax.data_ptr(), pidx.data_ptr(), ids.data_ptr(), x2.shape[0],
              n, k, true_n, int(x.dtype == torch.bfloat16),
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={x2.shape[0]}, N={n}, K={k}')
  head_argmax_bf16.launches += 1
  return ids.reshape(x.shape[:-1])


head_argmax_bf16.launches = 0
head_argmax_bf16.plain_calls = 0


def _scratch(name, x2, w_q, scale, packed, true_n, tile=_HEAD_BN):
  """Checks the weights of a CUDA launch and allocates its pairs, one a row
  and `tile`-column tile, and ids: (N, true_n, pmax, pidx, ids)."""
  n = w_q.shape[0]
  _build.require_cuda_tensor(
      w_q, name, 'w_q', (torch.uint8,) if packed else (torch.int8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  m, tiles, dev = x2.shape[0], -(-n // tile), x2.device
  return (n, n if true_n is None else min(true_n, n),
          torch.empty((m, tiles), dtype=torch.float32, device=dev),
          torch.empty((m, tiles), dtype=torch.int32, device=dev),
          torch.empty((m,), dtype=torch.int32, device=dev))
