"""OCTAV: optimal clipping threshold via Newton-Raphson (arXiv:2206.06501).

Weights only; activations fall back to min/max. The clipping constant per
channel/block solves eq. (6) of the paper:

  s = E[|x| · 1{|x|>s}] / (4^-B/3 · E[1{|x|<=s}-count-complement ...])

iterated to a fixed point, then fed into the standard zp/scale computation
as a symmetric clipping bound.

Parity: reference `algorithms/uniform_quantize/octav.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/octav.py`: the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import min_max
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn

ALGORITHM_KEY = 'OCTAV'


def compute_clipping_octav(
    data: np.ndarray,
    num_bits: int,
    reduce_axes,
    max_iterations: int = 10,
    exponent_divisor: float = 3.0,
) -> np.ndarray:
  """Per-group optimal |clipping| constants (keepdims over reduce_axes)."""
  if reduce_axes is not None:
    axes = (reduce_axes,) if isinstance(reduce_axes, int) else tuple(
        reduce_axes)
    count = float(np.prod([data.shape[a] for a in axes]))
  else:
    axes = None
    count = float(data.size)
  abs_x = np.abs(data.astype(np.float32))
  guess = np.ones(
      tuple(1 if (axes is not None and k in axes) else d
            for k, d in enumerate(data.shape)) if axes is not None else (1,),
      dtype=np.float32)
  rate = np.float32(4.0 ** (-num_bits) / exponent_divisor)
  for _ in range(max_iterations):
    prev = guess
    over = abs_x >= prev
    clipped_mass = np.sum(abs_x, axis=axes, keepdims=True, where=over,
                          dtype=np.float32)
    n_over = np.count_nonzero(over, axis=axes, keepdims=True).astype(
        np.float32)
    denom = n_over * (1.0 - rate) + rate * count
    guess = clipped_mass / np.maximum(denom, 1e-12)
    if np.allclose(prev, guess):
      break
  return guess


def get_tensor_quant_params(
    op_info: qtyping.OpInfo,
    tensor_quant_config: qtyping.TensorQuantizationConfig,
    tensor_content: Optional[np.ndarray] = None,
    tensor_qsv: Optional[dict[str, Any]] = None,
) -> qtyping.UniformQuantParams:
  if tensor_content is None:
    # Activations: plain min/max.
    return min_max.get_tensor_quant_params(
        op_info, tensor_quant_config, tensor_content, tensor_qsv)
  if not tensor_quant_config.symmetric:
    raise ValueError('OCTAV supports symmetric quantization only.')

  if tensor_qsv and 'min' in tensor_qsv:
    tensor_min_max = tensor_qsv
  else:
    tensor_min_max = min_max.init_tensor_min_max(tensor_content, op_info)

  gran = tensor_quant_config.granularity
  if qtyping.is_blockwise_granularity(gran):
    qdim = qn.OP_BLOCKWISE_WEIGHT_QUANTIZED_DIM[op_info.op_name]
    view = tensor_content.reshape(
        qn.blockwise_shape(tensor_content.shape, qdim,
                           tensor_quant_config.block_size))
    clipping = compute_clipping_octav(
        view, tensor_quant_config.num_bits, (qdim + 1,))
    clipping = clipping.reshape(np.asarray(tensor_min_max['min']).shape)
  elif gran == qtyping.QuantGranularity.CHANNELWISE:
    qdim = qn.weight_quantized_dim(op_info.op_name, op_info.op.attrs)
    qdim = qdim % tensor_content.ndim
    reduce_dims = tuple(d for d in range(tensor_content.ndim) if d != qdim)
    clipping = compute_clipping_octav(
        tensor_content, tensor_quant_config.num_bits, reduce_dims)
  else:
    qdim = None
    clipping = compute_clipping_octav(
        tensor_content, tensor_quant_config.num_bits, None)

  zp, scale = qn.compute_zp_scale(
      tensor_min_max['min'], tensor_min_max['max'],
      tensor_quant_config.num_bits, True, gran,
      clipping=np.broadcast_to(
          clipping, np.asarray(tensor_min_max['min']).shape),
  )
  if gran == qtyping.QuantGranularity.CHANNELWISE:
    scale, zp = scale.reshape(-1), zp.reshape(-1)
  elif gran == qtyping.QuantGranularity.TENSORWISE:
    scale, zp = scale.reshape(-1)[:1], zp.reshape(-1)[:1]
  params = qtyping.UniformQuantParams(
      num_bits=tensor_quant_config.num_bits,
      quantized_dimension=qdim,
      scale=scale, zero_point=zp, symmetric=True,
      block_size=tensor_quant_config.block_size,
  )
  qdata = qn.quantize_array(tensor_content, params)
  return dataclasses.replace(params, quantized_data=qdata)
