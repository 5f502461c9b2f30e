"""Declarative per-op materialization table.

One row per supported op: which engine path materializes it, its scale
constraint, and which operands are never quantized. The registration in
`algorithms/manager.py` turns each row into a materialize function bound to a
specific algorithm's `get_tensor_quant_params`.

Parity: the ~55 per-op wrapper functions of reference
`algorithms/uniform_quantize/common_quantize.py`, collapsed into a table.
Per-op references cited inline.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/op_library.py`: the port
keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine

_Op = qtyping.OpName
_C = engine.OpQuantConstraint


def _softmax_logistic_fixed_params() -> dict:
  """Kernel-pinned output ranges for softmax/logistic (ref common_quantize.py:194-230)."""
  return {
      8: qtyping.UniformQuantParams(
          num_bits=8, quantized_dimension=None,
          scale=np.array(1.0 / 256, np.float32),
          zero_point=np.array(-128), symmetric=False),
      16: qtyping.UniformQuantParams(
          num_bits=16, quantized_dimension=None,
          scale=np.array(1.0 / 32768, np.float32),
          zero_point=np.array(0), symmetric=True),
  }


def _tanh_fixed_params() -> dict:
  """Tanh output in [-1, 1): scale 2^-(b-1) (ref common_quantize.py:648-675)."""
  return {
      b: qtyping.UniformQuantParams(
          num_bits=b, quantized_dimension=None,
          scale=np.array(1.0 / (1 << (b - 1)), np.float32),
          zero_point=np.array(0), symmetric=(b == 16))
      for b in (8, 16)
  }


@dataclasses.dataclass(frozen=True)
class OpMaterializeSpec:
  """How one op materializes."""

  kind: str = 'standard'  # standard | fc_conv | fixed_output | sum
  constraint: _C = _C.NO_CONSTRAIN
  inputs_to_ignore: tuple = ()
  outputs_to_ignore: tuple = ()
  # fc_conv operand positions.
  input_index: int = 0
  weight_index: int = 1
  bias_index: int = 2
  # fixed_output params factory: num_bits -> UniformQuantParams.
  fixed_params_factory: Optional[Callable[[], dict]] = None


_SAI = _C.SAME_AS_INPUT_SCALE
_SAO = _C.SAME_AS_OUTPUT_SCALE

# The master table. Ignore lists name operands that carry structure (shapes,
# axes, indices, conditions) rather than values; non-float32 operands are
# additionally auto-ignored by the engine.
OP_SPECS: dict = {
    _Op.INPUT: OpMaterializeSpec(),
    _Op.OUTPUT: OpMaterializeSpec(),
    _Op.FULLY_CONNECTED: OpMaterializeSpec(kind='fc_conv'),
    _Op.CONV_2D: OpMaterializeSpec(kind='fc_conv'),
    _Op.DEPTHWISE_CONV_2D: OpMaterializeSpec(kind='fc_conv'),
    # conv2d_transpose operand order: [output_shape, weight, input, bias]
    # (ref common_quantize.py:588-645).
    _Op.CONV_2D_TRANSPOSE: OpMaterializeSpec(
        kind='fc_conv', inputs_to_ignore=(0,), input_index=2, weight_index=1,
        bias_index=3),
    _Op.BATCH_MATMUL: OpMaterializeSpec(),
    _Op.EMBEDDING_LOOKUP: OpMaterializeSpec(inputs_to_ignore=(0,)),
    _Op.RESHAPE: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.AVERAGE_POOL_2D: OpMaterializeSpec(constraint=_SAI),
    _Op.MAX_POOL_2D: OpMaterializeSpec(constraint=_SAI),
    _Op.RESIZE_BILINEAR: OpMaterializeSpec(
        constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.RESIZE_NEAREST_NEIGHBOR: OpMaterializeSpec(
        constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.SLICE: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1, 2)),
    _Op.STRIDED_SLICE: OpMaterializeSpec(
        constraint=_SAI, inputs_to_ignore=(1, 2, 3)),
    _Op.TRANSPOSE: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.SPLIT: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(0,)),
    _Op.PAD: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.MIRROR_PAD: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.SPACE_TO_DEPTH: OpMaterializeSpec(constraint=_SAI),
    _Op.GATHER: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.GATHER_ND: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.UNPACK: OpMaterializeSpec(constraint=_SAI),
    _Op.BROADCAST_TO: OpMaterializeSpec(
        constraint=_SAI, inputs_to_ignore=(1,)),
    _Op.REDUCE_MIN: OpMaterializeSpec(constraint=_SAI, inputs_to_ignore=(1,)),
    # SUM: the 8-bit kernel has no input/output scale tie; wider bits do
    # (ref common_quantize.py:500-525).
    _Op.SUM: OpMaterializeSpec(kind='sum', inputs_to_ignore=(1,)),
    _Op.CONCATENATION: OpMaterializeSpec(constraint=_SAO),
    _Op.PACK: OpMaterializeSpec(constraint=_SAO),
    _Op.SELECT: OpMaterializeSpec(constraint=_SAO, inputs_to_ignore=(0,)),
    _Op.SELECT_V2: OpMaterializeSpec(constraint=_SAO, inputs_to_ignore=(0,)),
    _Op.DYNAMIC_UPDATE_SLICE: OpMaterializeSpec(
        constraint=_SAO, inputs_to_ignore=(2,)),
    _Op.PADV2: OpMaterializeSpec(constraint=_SAO, inputs_to_ignore=(1,)),
    _Op.MAXIMUM: OpMaterializeSpec(constraint=_SAO),
    _Op.SOFTMAX: OpMaterializeSpec(
        kind='fixed_output', fixed_params_factory=_softmax_logistic_fixed_params),
    _Op.LOGISTIC: OpMaterializeSpec(
        kind='fixed_output', fixed_params_factory=_softmax_logistic_fixed_params),
    _Op.TANH: OpMaterializeSpec(
        kind='fixed_output', fixed_params_factory=_tanh_fixed_params),
    _Op.ADD: OpMaterializeSpec(),
    _Op.SUB: OpMaterializeSpec(),
    _Op.MUL: OpMaterializeSpec(),
    _Op.DIV: OpMaterializeSpec(),
    _Op.MEAN: OpMaterializeSpec(inputs_to_ignore=(1,)),
    _Op.GELU: OpMaterializeSpec(),
    _Op.RSQRT: OpMaterializeSpec(),
    _Op.SQRT: OpMaterializeSpec(),
    _Op.SQUARED_DIFFERENCE: OpMaterializeSpec(),
    _Op.HARD_SWISH: OpMaterializeSpec(),
    _Op.RELU: OpMaterializeSpec(),
    _Op.EQUAL: OpMaterializeSpec(),      # bool output auto-ignored
    _Op.NOT_EQUAL: OpMaterializeSpec(),  # bool output auto-ignored
    _Op.STABLEHLO_COMPOSITE: OpMaterializeSpec(),
    # TPU-side ops.
    _Op.RMS_NORM: OpMaterializeSpec(inputs_to_ignore=(1,)),
}


def materialize_with_spec(
    spec: OpMaterializeSpec,
    get_params_fn,
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    cache: Optional[engine.ParamsCache] = None,
) -> list:
  """Dispatch one op through the engine according to its table row."""
  if spec.kind == 'fc_conv':
    return engine.materialize_fc_conv(
        op_info, graph_info, qsvs, get_params_fn, cache,
        input_index=spec.input_index, weight_index=spec.weight_index,
        bias_index=spec.bias_index,
    )
  if spec.kind == 'fixed_output':
    return engine.materialize_op_with_fixed_output_params(
        op_info, graph_info, qsvs, spec.fixed_params_factory(),
        get_params_fn, cache,
    )
  if spec.kind == 'sum':
    act_cfg = op_info.op_quant_config.activation_tensor_config
    constraint = (
        _C.NO_CONSTRAIN
        if act_cfg is not None and act_cfg.num_bits == 8
        else _SAI
    )
    return engine.materialize_standard_op(
        op_info, graph_info, qsvs, get_params_fn, cache,
        constraint=constraint,
        inputs_to_ignore=spec.inputs_to_ignore,
        outputs_to_ignore=spec.outputs_to_ignore,
    )
  return engine.materialize_standard_op(
      op_info, graph_info, qsvs, get_params_fn, cache,
      constraint=spec.constraint,
      inputs_to_ignore=spec.inputs_to_ignore,
      outputs_to_ignore=spec.outputs_to_ignore,
  )
