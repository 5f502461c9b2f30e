"""MSE-optimal closed-form scales: scale = c(bits) * RMS(weights).

Coefficients from offline numeric analysis assuming ~Gaussian weights.
Weights only, symmetric only, no blockwise; activations fall back to
min/max. Parity: reference `algorithms/uniform_quantize/mse.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/mse.py`: the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import min_max
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn

ALGORITHM_KEY = 'MSE'

_MSE_QUANT_MULS = {
    8: 0.05408,
    4: 0.37755,
}


def get_tensor_quant_params(
    op_info: qtyping.OpInfo,
    tensor_quant_config: qtyping.TensorQuantizationConfig,
    tensor_content: Optional[np.ndarray] = None,
    tensor_qsv: Optional[dict[str, Any]] = None,
) -> qtyping.UniformQuantParams:
  if qtyping.is_blockwise_granularity(tensor_quant_config.granularity):
    raise ValueError('Blockwise quantization is not supported for MSE.')
  if tensor_content is None:
    return min_max.get_tensor_quant_params(
        op_info, tensor_quant_config, tensor_content, tensor_qsv)
  if not tensor_quant_config.symmetric:
    raise ValueError('MSE supports symmetric quantization only.')
  if tensor_quant_config.num_bits not in _MSE_QUANT_MULS:
    raise ValueError(
        f'MSE has no coefficient for {tensor_quant_config.num_bits} bits.')

  if tensor_quant_config.granularity == qtyping.QuantGranularity.CHANNELWISE:
    qdim = qn.weight_quantized_dim(op_info.op_name, op_info.op.attrs)
    qdim = qdim % tensor_content.ndim
    reduce_dims = tuple(d for d in range(tensor_content.ndim) if d != qdim)
  else:
    qdim = None
    reduce_dims = None

  mul = _MSE_QUANT_MULS[tensor_quant_config.num_bits]
  rms = np.sqrt(np.mean(
      tensor_content.astype(np.float32) ** 2, axis=reduce_dims))
  scale = np.maximum(mul * rms, 1e-9).astype(np.float32)
  if qdim is None:
    scale = scale.reshape(1)
  zp = np.zeros_like(scale, dtype=np.int8)
  params = qtyping.UniformQuantParams(
      num_bits=tensor_quant_config.num_bits,
      quantized_dimension=qdim,
      scale=scale, zero_point=zp, symmetric=True,
  )
  qdata = qn.quantize_array(tensor_content, params)
  return dataclasses.replace(params, quantized_data=qdata)
