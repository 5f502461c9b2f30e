"""Dequantized-weight recovery for QAT-exported float models.

A QAT-exported float model's weights sit exactly on a quantization grid;
this algorithm recovers that grid: per channel/block, scale = the minimum
spacing of unique values (with 0 appended for symmetry), then re-quantizes
and verifies the round trip reproduces the inputs within 1e-4.

Parity: reference `algorithms/uniform_quantize/dequantized_weight_recovery.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/dequant_recovery.py`: the
port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import min_max
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn

ALGORITHM_KEY = 'dequantized_weight_recovery'

_RECOVERY_TOL = 1e-4
_MIN_SCALE = 1e-9


def _scale_of_group(vals: np.ndarray) -> float:
  """Smallest spacing of the value grid (0 included for symmetry)."""
  uniq = np.unique(np.append(vals.ravel(), 0.0))
  if uniq.size > 1:
    return float(max(np.min(np.diff(uniq)), _MIN_SCALE))
  return _MIN_SCALE


def recover_zp_scale(
    dequant_vals: np.ndarray,
    quantized_dimension: Optional[int],
    block_size: int = 0,
):
  """(zero_point, scale) recovering the grid of `dequant_vals`."""
  if block_size > 0:
    # View with the blocked axis split: [..., n_blocks, block, ...rest];
    # one scale per block group.
    view = dequant_vals.reshape(
        qn.blockwise_shape(dequant_vals.shape, quantized_dimension,
                           block_size))
    flat = view.reshape(-1, block_size)
    scales = np.array([_scale_of_group(row) for row in flat],
                      np.float32).reshape(view.shape[:-1])
  elif quantized_dimension is not None:
    moved = np.moveaxis(dequant_vals, quantized_dimension, 0)
    scales = np.array(
        [_scale_of_group(moved[i]) for i in range(moved.shape[0])],
        np.float32)
  else:
    scales = np.array([_scale_of_group(dequant_vals)], np.float32)
  zp = np.zeros_like(scales, dtype=np.int8)
  return zp, scales


def get_tensor_quant_params(
    op_info: qtyping.OpInfo,
    tensor_quant_config: qtyping.TensorQuantizationConfig,
    tensor_content: Optional[np.ndarray] = None,
    tensor_qsv: Optional[dict[str, Any]] = None,
) -> qtyping.UniformQuantParams:
  if tensor_content is None:
    return min_max.get_tensor_quant_params(
        op_info, tensor_quant_config, tensor_content, tensor_qsv)
  if not tensor_quant_config.symmetric:
    raise ValueError(
        'Only symmetric weights are supported for dequantized weight '
        'recovery.')
  gran = tensor_quant_config.granularity
  block_size = tensor_quant_config.block_size
  if qtyping.is_blockwise_granularity(gran):
    qdim = qn.OP_BLOCKWISE_WEIGHT_QUANTIZED_DIM[op_info.op_name]
  elif gran == qtyping.QuantGranularity.CHANNELWISE:
    qdim = qn.weight_quantized_dim(op_info.op_name, op_info.op.attrs)
    qdim = qdim % tensor_content.ndim
  else:
    qdim = None

  # Check the grid is representable in the target bit width.
  limit = 1 << tensor_quant_config.num_bits
  if block_size > 0:
    groups = tensor_content.reshape(
        qn.blockwise_shape(tensor_content.shape, qdim, block_size)
    ).reshape(-1, block_size)
  elif qdim is not None:
    groups = np.moveaxis(tensor_content, qdim, 0).reshape(
        tensor_content.shape[qdim], -1)
  else:
    groups = tensor_content.reshape(1, -1)
  for row in groups:
    n_unique = np.unique(row).size
    if n_unique > limit:
      raise ValueError(
          f'Weight group has {n_unique} unique values, exceeding the '
          f'{limit} representable at {tensor_quant_config.num_bits} bits — '
          'not a QAT-exported dequantized weight.')

  zp, scale = recover_zp_scale(tensor_content, qdim, block_size)
  params = qtyping.UniformQuantParams(
      num_bits=tensor_quant_config.num_bits,
      quantized_dimension=qdim,
      scale=scale, zero_point=zp, symmetric=True, block_size=block_size,
  )
  qdata = qn.quantize_array(tensor_content, params)
  params = dataclasses.replace(params, quantized_data=qdata)
  recovered = qn.dequantize_array(qdata, params)
  max_diff = float(np.max(np.abs(recovered - tensor_content)))
  if max_diff > _RECOVERY_TOL:
    raise RuntimeError(
        'Failed to recover original quantized values from dequantized '
        f'weights; max diff {max_diff} exceeds tolerance {_RECOVERY_TOL}.')
  return params
