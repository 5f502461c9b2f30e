"""Fused dequant + matmul for integer weights: dispatchers and plain twins.

Port of `ai_edge_quantizer_tpu/kernels/qmatmul.py`: the XLA references
(`qmatmul_ref`, `dynamic_quantize_activation`, `drq_matmul_ref`), which the
JAX package runs wherever no Pallas kernel applies, and the dispatchers
`drq_matmul` and `qmatmul` with the JAX package's gates, and the
static-range `srq_matmul`. Where a gate
passes, the dispatcher calls the port of the Pallas kernel
(`kernels/int_qmatmul.py`), which launches its CUDA kernel for a CUDA
tensor and runs its plain version for a CPU tensor; where it fails, the
reference runs on either device, as the JAX executor runs it off its
accelerator. There is no fallback on error: a kernel that does not build
or launch raises.

Integer contractions run as float32 matmuls over K-chunks of 1024: every
product and partial sum of int8 x int8 values within a chunk is an
integer of magnitude below 1024 * 127**2 < 2**24, so each chunk is exact
in float32 whatever the order of summation (and the int8 operands are
exact even in TF32), and the chunks add up in int32. The result equals
the int32 accumulator exactly, on any device (torch has no general
integer matmul on CUDA).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_EXACT_CHUNK = 1024


def int_matmul_exact(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
  """Exact int32 result of a [..., K] . b_t [N, K]^T for int8-range ints."""
  k = a.shape[-1]
  acc = None
  for k0 in range(0, k, _EXACT_CHUNK):
    part = torch.matmul(a[..., k0:k0 + _EXACT_CHUNK].to(torch.float32),
                        b_t[:, k0:k0 + _EXACT_CHUNK].to(torch.float32).T)
    part = part.to(torch.int32)
    acc = part if acc is None else acc + part
  return acc


def int_bmm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Exact int32 result of the batched a [..., M, K] @ b [..., K, N] for
  int8-range ints (batch dims broadcast, as torch.matmul's)."""
  k = a.shape[-1]
  acc = None
  for k0 in range(0, k, _EXACT_CHUNK):
    part = torch.matmul(a[..., k0:k0 + _EXACT_CHUNK].to(torch.float32),
                        b[..., k0:k0 + _EXACT_CHUNK, :].to(torch.float32))
    part = part.to(torch.int32)
    acc = part if acc is None else acc + part
  return acc


def qmatmul_ref(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    block_size: int = 0,
    out_dtype=None,
) -> torch.Tensor:
  """x [..., K] . int weights w_q [N, K] -> [..., N] (weight-only).

  scale: [N] (per-channel), [] (per-tensor), or [N, K // block_size]
  (blockwise). zero_point matches scale's shape (None => symmetric).
  """
  out_dtype = out_dtype or x.dtype
  compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
  # bf16 x bf16 products are exact in f32: f32 operands give the same sums
  # as bf16 operands with an f32 accumulator.
  xw = x.to(compute).to(torch.float32)
  wf = w_q.to(compute).to(torch.float32)
  if block_size > 0:
    n, k = w_q.shape
    nb = k // block_size
    xb = xw.reshape(x.shape[:-1] + (nb, block_size))
    wb = wf.reshape(n, nb, block_size)
    partial = torch.einsum('...bk,nbk->...nb', xb, wb)
    if zero_point is not None:
      xsum = torch.sum(xb, dim=-1)  # [..., nb]
      partial = partial - xsum[..., None, :] * zero_point.to(torch.float32)
    y = torch.einsum('...nb,nb->...n', partial, scale.to(torch.float32))
  else:
    y = torch.matmul(xw, wf.T)
    s = scale.to(torch.float32).reshape(-1)
    if zero_point is not None:
      zp = zero_point.to(torch.float32).reshape(-1)
      y = y - torch.sum(xw, dim=-1, keepdim=True) * zp
    y = y * s
  if bias is not None:
    y = y + bias.to(torch.float32)
  return y.to(out_dtype)


def dynamic_quantize_activation(x: torch.Tensor, num_bits: int = 8):
  """Per-row (last-dim) dynamic symmetric quantization of activations.

  Returns (x_q int8, scale f32 [..., 1]): absmax / qmax, then x / scale
  with a clip (not the in-kernel reciprocal form of the packed kernels).
  """
  qmax = float(2 ** (num_bits - 1) - 1)
  absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
  qmax_t = torch.full((), qmax, dtype=absmax.dtype, device=x.device)
  scale = torch.clamp_min(absmax, 1e-9) / qmax_t
  x_q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
  return x_q, scale.to(torch.float32)


def drq_matmul_ref(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act_num_bits: int = 8,
) -> torch.Tensor:
  """Dynamic-range path: quantize acts on the fly, int8 x int8 -> int32,
  rescale by act_scale * w_scale."""
  x_q, x_scale = dynamic_quantize_activation(x, act_num_bits)
  acc = int_matmul_exact(x_q, w_q)
  y = acc.to(torch.float32) * x_scale * w_scale.reshape(-1).to(torch.float32)
  if bias is not None:
    y = y + bias.to(torch.float32)
  return y.to(x.dtype)


def drq_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act_num_bits: int = 8,
) -> torch.Tensor:
  """DRQ dispatch (the JAX package's `drq_matmul` gate): the int8 DRQ
  kernel for int8 storage (int4 values in int8 containers too), 8-bit
  activations, K % 256 == 0, N % 128 == 0 and a per-channel scale of N
  entries (the Pallas wrapper reshapes it to [1, N], which a per-tensor
  scale fails, and the JAX dispatcher then runs the reference); else
  `drq_matmul_ref`."""
  # Imported here: int_qmatmul imports this module's exact int matmul.
  from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
  n, k = w_q.shape
  if (act_num_bits == 8 and w_q.dtype == torch.int8
      and k % 256 == 0 and n % 128 == 0 and w_scale.numel() == n):
    return int_qmatmul.qmatmul_int8_drq(x, w_q, w_scale, bias=bias)
  return drq_matmul_ref(x, w_q, w_scale, bias=bias,
                        act_num_bits=act_num_bits)


def srq_matmul(
    x_q: torch.Tensor,
    x_scale,
    x_zero_point,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
  """Static-range integer matmul: int8 x int8 -> int32.

  x_q [..., K] int8 with per-tensor (x_scale, x_zero_point); w_q [N, K]
  int8 symmetric with per-channel (or scalar) w_scale. The activation
  zero point enters in closed form through the per-channel weight row
  sums:

      y = (x_q . w_q^T  -  zp_x * rowsum(w_q)) * (s_x * s_w)  + bias

  in the JAX function's order (the two scales multiplied first, in
  float32). The int32 accumulator is exact (`int_matmul_exact`).
  """
  acc = int_matmul_exact(x_q, w_q)
  zp = int(np.asarray(x_zero_point).reshape(()))
  row_sums = torch.sum(w_q.to(torch.int32), dim=1, dtype=torch.int32)
  acc = acc - zp * row_sums
  s_x = torch.full((), float(np.asarray(x_scale, np.float32).reshape(())),
                   dtype=torch.float32, device=acc.device)
  y = acc.to(torch.float32) * (s_x * w_scale.to(torch.float32).reshape(-1))
  if bias is not None:
    y = y + bias.to(torch.float32)
  return y.to(out_dtype)


def qmatmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    block_size: int = 0,
) -> torch.Tensor:
  """Weight-only dispatch (the JAX package's `qmatmul` gate): the
  integer-weight kernel for symmetric weights (no zero point), K % 256 ==
  0, N % 128 == 0 and a scale of N (channelwise) or N * K / block_size
  (blockwise) entries, as the Pallas wrapper reshapes it; else
  `qmatmul_ref`."""
  from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
  n, k = w_q.shape
  blocks = k // block_size if block_size > 0 else 1
  if (zero_point is None and k % 256 == 0 and n % 128 == 0
      and scale.numel() == n * blocks):
    return int_qmatmul.qmatmul_int_weights(x, w_q, scale, bias=bias,
                                           block_size=block_size)
  return qmatmul_ref(x, w_q, scale, zero_point, bias, block_size)
