"""Core affine-quantization numerics (host side, numpy).

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/quant_numerics.py`
with three changes: blockwise scales round to the fp16 grid through torch's
bfloat16 (`round_to_fp16_grid`), not through `ml_dtypes`, which the port
does not depend on (both round half to even at each step, so the scales
are the same bit for bit); `pack_subbyte` / `unpack_subbyte` make the
same bytes in fewer passes (a table gather unpacks), which the JAX
package's serializer gets from its optional C++ packer; and
`dequantize_array` multiplies 8- and 16-bit codes in float32, which gives
its float64 path's values (see there).

The single source of truth for how min/max turn into (zero_point, scale) and
how tensors quantize/dequantize, shared by every uniform algorithm. Device
side, the same math runs inside Pallas/XLA kernels (`kernels/`); this module
is the offline pipeline's implementation and the numerical reference the
kernels are tested against.

Behavioral contract matches the reference kernel
(`ai_edge_quantizer/algorithms/uniform_quantize/uniform_quantize_tensor.py`):
  * signed ranges [-2^(b-1), 2^(b-1)-1]; narrow range (qmin+1) only for
    symmetric >= 8-bit (sub-byte data is unpacked to int8 on device, so
    narrow range would waste a bin);
  * symmetric scale = max(|min|,|max|)/qmax, zero_point = 0;
  * asymmetric range always includes 0 (zero-padding exactness);
  * bias scale fixed to input_scale*weight_scale, int32 storage, promoted to
    int64 when activations are int16;
  * blockwise scales clamped to the fp16-representable window and rounded to
    a 7-bit mantissa (bfloat16 cast) so scales serialize as fp16 exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch import qtyping

# Per-op weight quantized dimension (channel axis of the weight layout
# conventions in graph/builder.py). Parity: reference
# tfl_flatbuffer_utils.py:95-106.
OP_WEIGHT_QUANTIZED_DIM = {
    qtyping.OpName.FULLY_CONNECTED: 0,
    qtyping.OpName.BATCH_MATMUL: None,  # depends on adj_y, see weight_quantized_dim()
    qtyping.OpName.CONV_2D: 0,
    qtyping.OpName.DEPTHWISE_CONV_2D: 3,
    qtyping.OpName.CONV_2D_TRANSPOSE: 0,
    qtyping.OpName.EMBEDDING_LOOKUP: 0,
}

# Blockwise quantization reduces along the input-feature axis of the weight.
OP_BLOCKWISE_WEIGHT_QUANTIZED_DIM = {
    qtyping.OpName.FULLY_CONNECTED: 1,
    qtyping.OpName.EMBEDDING_LOOKUP: 1,
}


def weight_quantized_dim(
    op_name: qtyping.OpName, op_attrs: Optional[dict] = None
) -> Optional[int]:
  """Channel axis for a weight of `op_name` (BMM depends on adj_y)."""
  if op_name == qtyping.OpName.BATCH_MATMUL:
    adj_y = bool((op_attrs or {}).get('adj_y', False))
    return -2 if adj_y else -1
  return OP_WEIGHT_QUANTIZED_DIM.get(op_name)


def quantized_range(num_bits: int, signed: bool = True):
  if signed:
    return float(-(2 ** (num_bits - 1))), float(2 ** (num_bits - 1) - 1)
  return 0.0, float(2**num_bits - 1)


def use_narrow_range(symmetric: bool, num_bits: int) -> bool:
  return symmetric and num_bits >= 8


def storage_dtype(num_bits: int) -> type:
  if num_bits <= 8:
    return np.int8
  if num_bits <= 16:
    return np.int16
  if num_bits <= 32:
    return np.int32
  return np.int64


def compute_zp_scale(
    min_value: np.ndarray,
    max_value: np.ndarray,
    num_bits: int,
    symmetric: bool,
    granularity: qtyping.QuantGranularity = qtyping.QuantGranularity.TENSORWISE,
    clipping: Optional[np.ndarray] = None,
):
  """(zero_point, scale) from per-{tensor,channel,block} min/max.

  `clipping`, when given, is an absolute bound per element of min/max
  (OCTAV-style optimal clipping constants).
  """
  min_value = np.asarray(min_value, dtype=np.float32)
  max_value = np.asarray(max_value, dtype=np.float32)
  qmin, qmax = quantized_range(num_bits, signed=True)
  eps = np.float32(1e-9)
  blockwise = qtyping.is_blockwise_granularity(granularity)

  lo_cap = hi_cap = None
  if clipping is not None:
    hi_cap = np.asarray(clipping, dtype=np.float32)
    lo_cap = -hi_cap
  if blockwise:
    # fp16 scales (7-bit mantissa): max representable scale is 65280, so the
    # widest block range is [-65280*2^b, 65280*(2^b - 1)].
    fp16_hi = np.float32(65280.0) * (2**num_bits - 1)
    fp16_lo = np.float32(-65280.0) * (2**num_bits)
    hi_cap = fp16_hi if hi_cap is None else np.minimum(hi_cap, fp16_hi)
    lo_cap = fp16_lo if lo_cap is None else np.maximum(lo_cap, fp16_lo)

  if symmetric:
    bound = np.maximum(np.abs(min_value), np.abs(max_value))
    bound = np.maximum(bound, eps)
    if clipping is not None or blockwise:
      bound = np.clip(bound, lo_cap, hi_cap)
    scale = bound / np.float32(qmax)
    zp = np.zeros_like(scale, dtype=np.int64)
  else:
    # The representable range must include 0 so zero-padding stays exact
    # (Jacob et al., arXiv:1712.05877).
    hi = np.maximum(max_value, 0.0)
    lo = np.minimum(min_value, 0.0)
    span = np.maximum(hi - lo, eps)
    if clipping is not None:
      span = np.clip(span, -np.asarray(clipping), np.asarray(clipping))
    scale = span / np.float32(qmax - qmin)
    zp = np.rint(qmin - lo / scale).astype(np.int64)

  if blockwise:
    # Round scales to the fp16 grid with a 7-bit mantissa so the serialized
    # fp16 scale reproduces the exact value used for quantization.
    scale = round_to_fp16_grid(scale)
  scale = scale.astype(np.float32)
  zp = zp.astype(storage_dtype(num_bits))
  return zp, scale


def round_to_fp16_grid(scale: np.ndarray) -> np.ndarray:
  """f32 -> bfloat16 -> float16, each rounding half to even (a float16
  array of `scale`'s shape): a 7-bit mantissa that fp16 holds exactly,
  except below fp16's normal range, where fp16 rounds a second time."""
  s = torch.from_numpy(np.array(scale, dtype=np.float32, order='C'))
  return s.to(torch.bfloat16).to(torch.float16).numpy()


# ---------------------------------------------------------------------------
# Rank / blockwise shape plumbing.
# ---------------------------------------------------------------------------


def expand_params_rank(
    data_ndim: int, quantized_dimension: Optional[int], arr: np.ndarray
) -> np.ndarray:
  """Reshape a flat per-channel array so it broadcasts against the data."""
  arr = np.asarray(arr)
  if arr.ndim == data_ndim or data_ndim == 0:
    return arr
  if arr.size == 1:
    return arr.reshape((1,) * data_ndim)
  if quantized_dimension is None:
    raise ValueError(
        'Per-channel params need quantized_dimension to expand rank.'
    )
  qdim = quantized_dimension % data_ndim
  shape = [1] * data_ndim
  shape[qdim] = arr.size
  return arr.reshape(shape)


def blockwise_shape(
    shape: Sequence[int], quantized_dim: int, block_size: int
) -> list:
  """Split `quantized_dim` into (n_blocks, block_size) for reductions."""
  dim = shape[quantized_dim]
  if dim % block_size != 0:
    raise ValueError(
        f'Dimension {dim} (axis {quantized_dim} of {tuple(shape)}) not '
        f'divisible by block size {block_size}.'
    )
  out = list(shape)
  out[quantized_dim:quantized_dim + 1] = [dim // block_size, block_size]
  return out


def expand_block_params(
    data_shape: Sequence[int],
    params: qtyping.UniformQuantParams,
) -> tuple:
  """Expand per-block scale/zp to full data shape (for constant quant)."""
  if params.quantized_dimension is None or params.block_size <= 0:
    raise ValueError('Blockwise expansion needs quantized_dimension and '
                     'block_size.')
  qdim = params.quantized_dimension
  bshape = blockwise_shape(data_shape, qdim, params.block_size)
  scale = np.broadcast_to(
      np.expand_dims(params.scale, qdim + 1), bshape
  ).reshape(data_shape)
  zp = params.zero_point
  if zp is None or np.asarray(zp).size == 0:
    zp = np.zeros(data_shape, dtype=np.int32)
  else:
    zp = np.broadcast_to(np.expand_dims(zp, qdim + 1), bshape).reshape(
        data_shape
    )
  return scale, zp


# ---------------------------------------------------------------------------
# Quantize / dequantize.
# ---------------------------------------------------------------------------

_CHUNK_BYTES = 64 * 1024 * 1024  # Bound peak host memory on huge weights.


def quantize_array(
    data: np.ndarray,
    params: qtyping.UniformQuantParams,
) -> np.ndarray:
  """Quantize `data` with `params` -> integer array of the storage dtype."""
  data = np.asarray(data)
  if params.block_size > 0:
    scale, zp = expand_block_params(data.shape, params)
  else:
    scale = expand_params_rank(data.ndim, params.quantized_dimension,
                               params.scale)
    zp = expand_params_rank(data.ndim, params.quantized_dimension,
                            params.zero_point)
  if not np.issubdtype(np.asarray(zp).dtype, np.signedinteger):
    raise ValueError(f'zero_point must be a signed integer array, got '
                     f'{np.asarray(zp).dtype}.')
  qmin, qmax = quantized_range(params.num_bits, signed=True)
  if use_narrow_range(params.symmetric, params.num_bits):
    qmin = qmin + 1
  out_dtype = storage_dtype(params.num_bits)

  if data.ndim >= 2 and data.nbytes > _CHUNK_BYTES:
    # Chunk along axis 0 with one reused f32 scratch buffer: fresh large
    # allocations are page-fault bound, so everything runs in place.
    s_b = np.broadcast_to(scale, data.shape)
    z_b = np.broadcast_to(zp, data.shape)
    out = np.empty(data.shape, dtype=out_dtype)
    row_bytes = max(1, data[0:1].nbytes)
    rows = max(1, _CHUNK_BYTES // row_bytes)
    scratch = np.empty((min(rows, data.shape[0]),) + data.shape[1:],
                       dtype=np.float32)
    for r in range(0, data.shape[0], rows):
      sl = slice(r, min(r + rows, data.shape[0]))
      n = sl.stop - sl.start
      q = scratch[:n]
      np.divide(data[sl], s_b[sl], out=q)
      np.add(q, z_b[sl], out=q)
      np.rint(q, out=q)
      np.clip(q, qmin, qmax, out=q)
      out[sl] = q  # cast on assignment
    return out

  q = data / scale
  q = q + zp
  q = np.clip(np.rint(q), qmin, qmax)
  return q.astype(out_dtype)


def dequantize_array(
    qdata: np.ndarray,
    params: qtyping.UniformQuantParams,
) -> np.ndarray:
  """Dequantize integer data back to float32."""
  qdata = np.asarray(qdata)
  if params.block_size > 0:
    scale, zp = expand_block_params(qdata.shape, params)
  else:
    scale = expand_params_rank(qdata.ndim, params.quantized_dimension,
                               params.scale)
    zp = expand_params_rank(qdata.ndim, params.quantized_dimension,
                            params.zero_point)
  scale, zp = np.asarray(scale), np.asarray(zp)
  if (qdata.dtype in (np.int8, np.uint8, np.int16)
      and scale.dtype == np.float32 and zp.dtype.kind in 'iu'
      and np.all(np.abs(zp) < 2**16)):
    # q - zp is an integer below 2**17 and each product of it with an f32
    # scale is exact in f64, so one f32 multiply rounds it as the f64 path
    # does: the same values in a quarter of the memory traffic.
    return (qdata.astype(np.float32) - zp.astype(np.float32)) * scale
  return ((qdata.astype(np.float64) - zp) * scale).astype(np.float32)


def quantize_bias(
    bias: np.ndarray,
    input_params: qtyping.UniformQuantParams,
    weight_params: qtyping.UniformQuantParams,
    check_error: bool = False,
) -> qtyping.UniformQuantParams:
  """Quantize a fused bias at scale = input_scale * weight_scale.

  Always symmetric int32 (accumulator dtype); stored as int64 when the
  activation is int16 (int64 accumulator assumption — safe to downcast on
  accelerators with int32 accumulators).
  """
  bias = np.asarray(bias)
  scale = np.squeeze(
      np.asarray(input_params.scale) * np.asarray(weight_params.scale)
  )
  if not scale.shape:
    scale = scale[np.newaxis]
  zp = np.zeros_like(scale, dtype=np.int32)
  qdim = None if scale.size == 1 else 0
  params32 = qtyping.UniformQuantParams(
      num_bits=32, quantized_dimension=qdim, scale=scale, zero_point=zp,
      symmetric=True,
  )
  qdata = quantize_array(bias, params32)
  if check_error:
    err = np.max(np.abs(dequantize_array(qdata, params32) - bias))
    tol = max(1e-6, float(np.max(scale)))
    if err > tol:
      raise ValueError(
          f'Bias quantization error {err} exceeds tolerance {tol}; the fixed '
          'bias scale (input_scale * weight_scale) is too coarse here.'
      )
  num_bits = 32
  if input_params.num_bits == 16:
    qdata = qdata.astype(np.int64)
    num_bits = 64
  return qtyping.UniformQuantParams(
      num_bits=num_bits, quantized_dimension=qdim, scale=scale, zero_point=zp,
      symmetric=True, quantized_data=qdata,
  )


def quantize_tensor_min_max(
    data: np.ndarray,
    op_name: qtyping.OpName,
    config: qtyping.TensorQuantizationConfig,
    op_attrs: Optional[dict] = None,
    clipping: Optional[np.ndarray] = None,
) -> qtyping.UniformQuantParams:
  """One-shot weight quantization: min/max -> params -> quantized data."""
  reduce_dims, qdim = weight_reduction_spec(
      data.ndim, op_name, config.granularity, op_attrs
  )
  if config.granularity == qtyping.QuantGranularity.TENSORWISE:
    view = data
  elif qtyping.is_blockwise_granularity(config.granularity):
    # View with the blocked axis split; reduce_dims already targets the
    # trailing block axis of this view.
    view = data.reshape(
        blockwise_shape(data.shape, qdim, config.block_size)
    )
  else:
    view = data
  mins = np.min(view, axis=reduce_dims) if reduce_dims else np.min(view)
  maxs = np.max(view, axis=reduce_dims) if reduce_dims else np.max(view)
  zp, scale = compute_zp_scale(
      np.asarray(mins), np.asarray(maxs), config.num_bits, config.symmetric,
      config.granularity, clipping=clipping,
  )
  params = qtyping.UniformQuantParams(
      num_bits=config.num_bits,
      quantized_dimension=(
          None
          if config.granularity == qtyping.QuantGranularity.TENSORWISE
          else qdim
      ),
      scale=scale,
      zero_point=zp,
      symmetric=config.symmetric,
      block_size=config.block_size,
  )
  qdata = quantize_array(data, params)
  return qtyping.UniformQuantParams(
      num_bits=params.num_bits,
      quantized_dimension=params.quantized_dimension,
      scale=scale, zero_point=zp, symmetric=config.symmetric,
      quantized_data=qdata, block_size=config.block_size,
  )


def weight_reduction_spec(
    ndim: int,
    op_name: qtyping.OpName,
    granularity: qtyping.QuantGranularity,
    op_attrs: Optional[dict] = None,
):
  """(reduction axes over the [possibly block-reshaped] weight, channel axis).

  For TENSORWISE: reduce everything. CHANNELWISE: keep the op's quantized
  dim. BLOCKWISE: the weight is viewed with the blocked axis split into
  (n_blocks, block); reduce only the trailing block axis — params then have
  shape [channels, n_blocks] flattened per block.
  """
  if granularity == qtyping.QuantGranularity.TENSORWISE:
    return None, None
  if granularity == qtyping.QuantGranularity.CHANNELWISE:
    qdim = weight_quantized_dim(op_name, op_attrs)
    if qdim is None:
      # Untabled op: per-tensor fallback (reference
      # common_utils.py:1177-1186).
      return None, None
    qdim = qdim % ndim
    return tuple(d for d in range(ndim) if d != qdim), qdim
  # Blockwise.
  qdim = OP_BLOCKWISE_WEIGHT_QUANTIZED_DIM.get(op_name)
  if qdim is None:
    raise ValueError(f'{op_name} does not support blockwise quantization.')
  # After blockwise_shape() reshape, the block axis is qdim+1.
  return (qdim + 1,), qdim


def pack_subbyte(data: np.ndarray, num_bits: int) -> np.ndarray:
  """Pack int2/int4 values (stored in int8) into a dense uint8 array.

  int4: two values per byte, little-nibble-first; int2: four values per byte.
  (The JAX package's bytes, in fewer passes over the data.)
  """
  flat = np.ascontiguousarray(data, dtype=np.int8).reshape(-1)
  per_byte = 8 // num_bits
  pad = (-flat.size) % per_byte
  if pad:
    flat = np.concatenate([flat, np.zeros(pad, np.int8)])
  u = flat.view(np.uint8).reshape(-1, per_byte)
  mask = np.uint8((1 << num_bits) - 1)
  out = u[:, 0] & mask
  for i in range(1, per_byte):
    out |= (u[:, i] & mask) << np.uint8(num_bits * i)
  return out


def _unpack_table(num_bits: int) -> np.ndarray:
  """Each byte value's per_byte sign-extended values, one row of int8 a
  byte, the row viewed as one unsigned word (uint16 for int4, uint32 for
  int2) so that unpacking is one gather."""
  per_byte = 8 // num_bits
  byte = np.arange(256, dtype=np.int32)[:, None]
  vals = (byte >> (num_bits * np.arange(per_byte))) & ((1 << num_bits) - 1)
  sign_bit = 1 << (num_bits - 1)
  vals = ((vals ^ sign_bit) - sign_bit).astype(np.int8)
  return np.ascontiguousarray(vals).view(
      np.uint16 if per_byte == 2 else np.uint32).reshape(256)


_UNPACK_TABLES = {4: _unpack_table(4), 2: _unpack_table(2)}


def unpack_subbyte(
    packed: np.ndarray, num_bits: int, num_elements: int
) -> np.ndarray:
  """Inverse of pack_subbyte -> int8 array of `num_elements`."""
  words = _UNPACK_TABLES[num_bits][np.asarray(packed, np.uint8).reshape(-1)]
  return words.view(np.int8)[:num_elements]
