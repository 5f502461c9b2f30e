"""On-device quantize/dequantize arithmetic over IR QuantizationInfo (torch).

Port of `ai_edge_quantizer_tpu/execution/quant_arith.py`. The formulas are
copied exactly: `round(x / scale) + zp` (a division, not a multiply by
1/scale), clipped to the narrow range for symmetric >= 8-bit params.
`torch.round` rounds half to even, like `jnp.round`.

Per-tensor params stay Python floats and ints, so that quantizing inside a
decode step copies nothing from the host to the device (such a copy of a
pageable array synchronises the stream).
"""

from __future__ import annotations

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.graph import ir


STORAGE_TORCH_DTYPES = {
    'int2': torch.int8,
    'int4': torch.int8,
    'int8': torch.int8,
    'int16': torch.int16,
    'int32': torch.int32,
    'int64': torch.int64,
    'uint8': torch.uint8,
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
    'bool': torch.bool,
}


def storage_dtype_of(tensor: ir.Tensor) -> torch.dtype:
  return STORAGE_TORCH_DTYPES[tensor.dtype]


def _expanded_scale_zp(info: ir.QuantizationInfo, shape, ndim: int, device):
  """(scale, zero point): Python scalars when per-tensor, else tensors
  broadcastable against `shape` (blockwise params expanded)."""
  scale = np.asarray(info.scale, np.float32)
  zp = np.asarray(info.zero_point)
  if info.block_size > 0:
    qdim = info.quantized_dimension
    bshape = list(shape)
    bshape[qdim:qdim + 1] = [shape[qdim] // info.block_size, info.block_size]
    scale = np.broadcast_to(
        np.expand_dims(scale, qdim + 1), bshape).reshape(shape)
    zp = np.broadcast_to(np.expand_dims(zp, qdim + 1), bshape).reshape(shape)
    return (torch.as_tensor(np.ascontiguousarray(scale), device=device),
            torch.as_tensor(zp.astype(np.int32), device=device))
  if scale.size == 1:
    return float(scale.reshape(())), int(zp.reshape(()))
  qdim = info.quantized_dimension % ndim
  bshape = [1] * ndim
  bshape[qdim] = scale.size
  return (
      torch.as_tensor(scale.reshape(bshape), device=device),
      torch.as_tensor(zp.reshape(bshape).astype(np.int32), device=device),
  )


def dequantize(q: torch.Tensor, info: ir.QuantizationInfo,
               out_dtype=torch.float32) -> torch.Tensor:
  scale, zp = _expanded_scale_zp(info, q.shape, q.ndim, q.device)
  return ((q.to(torch.float32) - zp) * scale).to(out_dtype)


def quantize(x: torch.Tensor, info: ir.QuantizationInfo,
             storage_dtype: torch.dtype) -> torch.Tensor:
  scale, zp = _expanded_scale_zp(info, x.shape, x.ndim, x.device)
  symmetric = bool(np.all(np.asarray(info.zero_point) == 0))
  qmin = -(2 ** (info.num_bits - 1))
  qmax = 2 ** (info.num_bits - 1) - 1
  if symmetric and info.num_bits >= 8:
    qmin += 1  # narrow range, matches host-side rule
  if isinstance(scale, float):
    # A device scalar, not a Python one: torch divides by a CPU scalar as a
    # multiply by its reciprocal, which can differ from x / scale by an ulp.
    scale = torch.full((), scale, dtype=torch.float32, device=x.device)
  q = torch.round(x.to(torch.float32) / scale) + zp
  q = torch.clamp(q, qmin, qmax)
  return q.to(storage_dtype)
