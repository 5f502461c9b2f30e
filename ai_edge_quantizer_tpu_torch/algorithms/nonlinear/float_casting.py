"""fp16 float-casting "quantization": weights cast to float16, explicit
dequantize at runtime, all compute stays float.

Strict config: FLOAT compute precision, explicit_dequantize, 16-bit FLOAT
weight config, no activation config; weight-bearing ops only.

Parity: reference `algorithms/nonlinear_quantize/float_casting.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/nonlinear/float_casting.py`: the
port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping

ALGORITHM_KEY = 'float_casting'

SUPPORTED_OPS = frozenset([
    qtyping.OpName.FULLY_CONNECTED,
    qtyping.OpName.CONV_2D,
    qtyping.OpName.DEPTHWISE_CONV_2D,
    qtyping.OpName.CONV_2D_TRANSPOSE,
    qtyping.OpName.EMBEDDING_LOOKUP,
])


def check_config(op_name, op_quant_config, policy=None) -> None:
  del policy
  op_name = qtyping.OpName(op_name)
  cfg = op_quant_config
  if cfg.compute_precision != qtyping.ComputePrecision.FLOAT:
    raise ValueError(
        'Float casting requires FLOAT compute precision, got '
        f'{cfg.compute_precision}.')
  if not cfg.explicit_dequantize:
    raise ValueError('Float casting requires explicit_dequantize=True.')
  if cfg.activation_tensor_config is not None:
    raise ValueError(
        'Activation quantization is incompatible with float casting.')
  w = cfg.weight_tensor_config
  if w is None or w.num_bits != 16 or w.dtype != qtyping.TensorDataType.FLOAT:
    raise ValueError(
        'Float casting requires a 16-bit FLOAT weight config, got '
        f'{w}.')
  if op_name not in SUPPORTED_OPS:
    raise ValueError(f'Unsupported op for float casting: {op_name}.')


def get_tensor_quant_params(
    op_info: qtyping.OpInfo,
    tensor_quant_config: qtyping.TensorQuantizationConfig,
    tensor_content: Optional[np.ndarray] = None,
    tensor_qsv: Optional[dict[str, Any]] = None,
):
  """fp16 cast for constants; activations carry no params."""
  del tensor_qsv
  if tensor_content is None:
    return None
  return qtyping.NonLinearQuantParams(
      num_bits=16,
      quantized_data=tensor_content.astype(np.float16),
      data_type=qtyping.TensorDataType.FLOAT,
  )
