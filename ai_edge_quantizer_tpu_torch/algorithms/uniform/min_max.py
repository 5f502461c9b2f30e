"""Naive min/max uniform quantization (the default algorithm).

Weights: min/max per granularity -> zp/scale -> quantize. Activations:
calibrated min/max (EMA-merged by the calibrator) -> zp/scale.

Parity: reference `algorithms/uniform_quantize/naive_min_max_quantize.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/min_max.py`: the port
keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn

ALGORITHM_KEY = 'min_max_uniform_quantize'

# Calibration ignores values outside ~bfloat16 range: a -inf padding constant
# (padv2) would otherwise poison the min/max statistics.
_CALIBRATION_VALID_RANGE = (-3e38, 3e38)


def init_tensor_min_max(
    tensor_data: Optional[np.ndarray],
    op_info: qtyping.OpInfo,
) -> qtyping.QSV:
  """Initial weight min/max per the op's weight granularity ({} for acts)."""
  w_cfg = op_info.op_quant_config.weight_tensor_config
  if tensor_data is None or w_cfg is None:
    return {}
  gran = w_cfg.granularity
  if gran == qtyping.QuantGranularity.TENSORWISE:
    return {
        'min': np.min(tensor_data, keepdims=True),
        'max': np.max(tensor_data, keepdims=True),
    }
  if gran == qtyping.QuantGranularity.CHANNELWISE:
    qdim = qn.weight_quantized_dim(op_info.op_name, op_info.op.attrs)
    if qdim is None:
      # Ops without a weight-channel-dim table entry fall back to
      # per-tensor (reference common_utils.py:1177-1186: quantized_dim
      # stays None for untabled ops).
      return {
          'min': np.min(tensor_data, keepdims=True),
          'max': np.max(tensor_data, keepdims=True),
      }
    qdim = qdim % tensor_data.ndim
    reduce_dims = tuple(d for d in range(tensor_data.ndim) if d != qdim)
    return {
        'min': np.min(tensor_data, axis=reduce_dims, keepdims=True),
        'max': np.max(tensor_data, axis=reduce_dims, keepdims=True),
    }
  if qtyping.is_blockwise_granularity(gran):
    qdim = qn.OP_BLOCKWISE_WEIGHT_QUANTIZED_DIM.get(op_info.op_name)
    if qdim is None:
      raise ValueError(
          f'{op_info.op_name} does not support blockwise quantization.')
    view = tensor_data.reshape(
        qn.blockwise_shape(tensor_data.shape, qdim, w_cfg.block_size))
    return {
        'min': np.min(view, axis=qdim + 1),
        'max': np.max(view, axis=qdim + 1),
    }
  raise ValueError(f'Unsupported granularity: {gran}')


def get_tensor_quant_params(
    op_info: qtyping.OpInfo,
    tensor_quant_config: qtyping.TensorQuantizationConfig,
    tensor_content: Optional[np.ndarray] = None,
    tensor_qsv: Optional[dict[str, Any]] = None,
) -> qtyping.UniformQuantParams:
  """The min/max algorithm's GetTensorQuantParams implementation."""
  if tensor_qsv is None or 'min' not in tensor_qsv:
    if tensor_content is not None:
      # Weight-only / DRQ weights have no calibration; compute on the spot.
      tensor_min_max = init_tensor_min_max(tensor_content, op_info)
    else:
      raise ValueError(
          f'{op_info.op_name} (op id {op_info.subgraph_op_index}) has no '
          'QSV for an activation tensor; was calibration run?'
      )
  else:
    tensor_min_max = tensor_qsv
  if 'min' not in tensor_min_max or 'max' not in tensor_min_max:
    raise ValueError(
        'min and max required to compute quantization parameters; check the '
        'calibration result fed to the params generator.'
    )
  zp, scale = qn.compute_zp_scale(
      tensor_min_max['min'],
      tensor_min_max['max'],
      tensor_quant_config.num_bits,
      tensor_quant_config.symmetric,
      tensor_quant_config.granularity,
  )
  qdim = None
  if tensor_content is not None:
    if qtyping.is_blockwise_granularity(tensor_quant_config.granularity):
      qdim = qn.OP_BLOCKWISE_WEIGHT_QUANTIZED_DIM.get(op_info.op_name)
    elif tensor_quant_config.granularity == \
        qtyping.QuantGranularity.CHANNELWISE:
      qdim = qn.weight_quantized_dim(op_info.op_name, op_info.op.attrs)
      qdim = qdim % tensor_content.ndim
      # Flatten the keepdims min/max shape to a 1-D per-channel vector.
      scale = scale.reshape(-1)
      zp = zp.reshape(-1)
    else:
      scale = scale.reshape(-1)[:1]
      zp = zp.reshape(-1)[:1]
  params = qtyping.UniformQuantParams(
      num_bits=tensor_quant_config.num_bits,
      quantized_dimension=qdim,
      scale=scale,
      zero_point=zp,
      symmetric=tensor_quant_config.symmetric,
      block_size=tensor_quant_config.block_size,
  )
  if tensor_content is None:
    # Activations: flatten any keepdims shapes to scalars.
    return dataclasses.replace(
        params,
        scale=np.asarray(params.scale).reshape(-1)[:1].astype(np.float32),
        zero_point=np.asarray(params.zero_point).reshape(-1)[:1],
    )
  qdata = qn.quantize_array(tensor_content, params)
  return dataclasses.replace(params, quantized_data=qdata)


def init_qsvs(
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    inputs_to_ignore: Optional[list] = None,
    outputs_to_ignore: Optional[list] = None,
) -> qtyping.QSV:
  """Initial QSVs for every non-ignored operand of the op."""
  op_qsvs: qtyping.QSV = {}
  tensors = graph_info.subgraph.tensors
  inputs_to_ignore = list(inputs_to_ignore or [])
  outputs_to_ignore = list(outputs_to_ignore or [])
  for pos, tid in enumerate(op_info.op.inputs):
    if tid >= 0 and engine.is_quantized_tensor(tensors[tid]):
      inputs_to_ignore.append(pos)
  for pos, tid in enumerate(op_info.op.inputs):
    if tid < 0 or pos in inputs_to_ignore:
      continue
    t = tensors[tid]
    op_qsvs[t.name] = init_tensor_min_max(
        engine.tensor_data_of(graph_info, t), op_info)
  for pos, tid in enumerate(op_info.op.outputs):
    if tid < 0 or pos in outputs_to_ignore:
      continue
    t = tensors[tid]
    op_qsvs[t.name] = init_tensor_min_max(
        engine.tensor_data_of(graph_info, t), op_info)
  return op_qsvs


def min_max_calibrate(
    op,
    graph_info: qtyping.GraphInfo,
    tensor_content_map: dict,
    inputs_to_ignore: Optional[list] = None,
    outputs_to_ignore: Optional[list] = None,
) -> dict:
  """Collect activation min/max for one op from captured tensor contents."""
  op_qsvs: dict = {}
  tensors = graph_info.subgraph.tensors
  lo, hi = _CALIBRATION_VALID_RANGE

  def collect(tid: int) -> None:
    t = tensors[tid]
    if engine.tensor_data_of(graph_info, t) is not None:
      return  # constants are not calibrated
    content = tensor_content_map.get(t.name)
    if content is None:
      return
    content = np.asarray(content)
    qsv_shape = (1,) * content.ndim
    mask = (content > lo) & (content < hi)
    vals = content[mask] if np.any(mask) else content
    op_qsvs[t.name] = {
        'min': np.min(vals).reshape(qsv_shape),
        'max': np.max(vals).reshape(qsv_shape),
    }

  inputs_to_ignore = list(inputs_to_ignore or [])
  for pos, tid in enumerate(op.inputs):
    if tid >= 0 and engine.is_quantized_tensor(tensors[tid]):
      inputs_to_ignore.append(pos)
  outputs_to_ignore = outputs_to_ignore or []
  for pos, tid in enumerate(op.inputs):
    if tid >= 0 and pos not in inputs_to_ignore:
      collect(tid)
  for pos, tid in enumerate(op.outputs):
    if tid >= 0 and pos not in outputs_to_ignore:
      collect(tid)
  return op_qsvs
