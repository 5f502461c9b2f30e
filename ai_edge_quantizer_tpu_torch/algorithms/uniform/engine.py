"""Materialize engine: turns (op, recipe config, QSVs) into per-tensor
transformation requests.

This is the shared machinery every uniform algorithm plugs its
`get_tensor_quant_params` function into. For each op it decides, per tensor:
which graph transformations apply (quantize-in-place / insert quantize /
insert dequantize / nothing) and with which quantization parameters, honoring
scale-propagation constraints (SAME_AS_INPUT_SCALE / SAME_AS_OUTPUT_SCALE /
fixed output scales) and fused-bias rules.

Capability parity: reference `algorithms/utils/common_utils.py` (materialize
engine) + the per-op wrappers of
`algorithms/uniform_quantize/common_quantize.py`, re-organized as a single
declarative dispatch (`op_library.py` holds the per-op table).

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/engine.py`: the port
keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn

_QT = qtyping.QuantTransformation

# Ops whose constant operands use the weight (not activation) config.
WEIGHT_BEARING_OPS = frozenset([
    qtyping.OpName.FULLY_CONNECTED,
    qtyping.OpName.CONV_2D,
    qtyping.OpName.BATCH_MATMUL,
    qtyping.OpName.EMBEDDING_LOOKUP,
    qtyping.OpName.DEPTHWISE_CONV_2D,
    qtyping.OpName.CONV_2D_TRANSPOSE,
])

BLOCKWISE_CAPABLE_OPS = frozenset([
    qtyping.OpName.FULLY_CONNECTED,
    qtyping.OpName.EMBEDDING_LOOKUP,
])


class OpQuantConstraint(enum.Enum):
  NO_CONSTRAIN = 0
  SAME_AS_INPUT_SCALE = 1
  SAME_AS_OUTPUT_SCALE = 2
  FIXED_OUTPUT_SCALE = 3


class ParamsCache:
  """(buffer id, tensor config) -> computed quant params.

  Shared-weight tensors hit the cache so both consumers get identical params
  (and the expensive weight quantization runs once).
  """

  def __init__(self):
    self._cache: dict = {}

  def lookup(self, buffer_id: int, cfg) -> Optional[Any]:
    if buffer_id is None or buffer_id < 0:
      return None
    return self._cache.get((buffer_id, cfg))

  def insert(self, buffer_id: int, cfg, params) -> None:
    if buffer_id is not None and buffer_id >= 0:
      self._cache[(buffer_id, cfg)] = params


def is_quantized_tensor(tensor) -> bool:
  return tensor.quantization is not None


def tensor_data_of(graph_info: qtyping.GraphInfo, tensor) -> Optional[np.ndarray]:
  if tensor.buffer < 0:
    return None
  buf = graph_info.buffers[tensor.buffer]
  if buf.data is None:
    return None
  data = buf.data
  if data.size == tensor.num_elements and data.shape != tensor.shape:
    data = data.reshape(tensor.shape)
  return data


def select_transformations(
    op_quant_config: qtyping.OpQuantizationConfig,
    is_inbounding_tensor: bool,
    is_constant: bool,
) -> list:
  """The execution-mode -> transformation mapping.

  SRQ: inbounding constants quantize in place, activations get a quantize op,
  outputs get a dequantize op (peephole pass later removes redundant pairs).
  DRQ: only inbounding constants quantize in place. WEIGHT_ONLY: inbounding
  constants become quantized-storage + explicit dequantize.
  """
  cfg = op_quant_config
  is_srq = (
      cfg.compute_precision == qtyping.ComputePrecision.INTEGER
      and cfg.activation_tensor_config is not None
  )
  is_drq = (
      cfg.compute_precision == qtyping.ComputePrecision.INTEGER
      and cfg.activation_tensor_config is None
  )
  is_weight_only = (
      cfg.compute_precision == qtyping.ComputePrecision.FLOAT
      and cfg.explicit_dequantize
  )
  if is_srq:
    if is_inbounding_tensor:
      return [_QT.QUANTIZE_TENSOR] if is_constant else [_QT.ADD_QUANTIZE]
    return [_QT.ADD_DEQUANTIZE]
  if is_drq:
    if is_inbounding_tensor and is_constant:
      return [_QT.QUANTIZE_TENSOR]
    return [_QT.NO_QUANTIZE]
  if is_weight_only:
    if is_inbounding_tensor and is_constant:
      # ADD_DEQUANTIZE implies quantized storage: int tensor -> DEQUANTIZE op
      # -> float tensor.
      return [_QT.ADD_DEQUANTIZE]
    return [_QT.NO_QUANTIZE]
  raise ValueError(
      f'Unsupported compute precision: {cfg.compute_precision}'
  )


def make_tensor_params(
    tensor_name: str,
    op_info: qtyping.OpInfo,
    is_inbounding_tensor: bool,
    quant_params=None,
    is_constant: bool = False,
    transformations: Optional[list] = None,
) -> qtyping.TensorTransformationParams:
  """Wrap params+transformations into producer/consumer view for one tensor."""
  if transformations is None:
    transformations = select_transformations(
        op_info.op_quant_config, is_inbounding_tensor, is_constant
    )
  o2t = qtyping.OpToTensorParams(
      subgraph_op_id=op_info.subgraph_op_index,
      transformations=transformations,
      parameters=quant_params,
  )
  if is_inbounding_tensor:
    return qtyping.TensorTransformationParams(
        tensor_name=tensor_name, consumers=[o2t]
    )
  return qtyping.TensorTransformationParams(
      tensor_name=tensor_name, producer=o2t
  )


def _no_quantize_params(
    tensor_name: str, op_info: qtyping.OpInfo, is_inbounding_tensor: bool
) -> qtyping.TensorTransformationParams:
  o2t = qtyping.OpToTensorParams(
      subgraph_op_id=op_info.subgraph_op_index,
      transformations=[_QT.NO_QUANTIZE],
  )
  if is_inbounding_tensor:
    return qtyping.TensorTransformationParams(tensor_name, consumers=[o2t])
  return qtyping.TensorTransformationParams(tensor_name, producer=o2t)


def min_max_from_quant_params(params: qtyping.UniformQuantParams):
  """Reconstruct representable (min, max) from quant params."""
  qmin, qmax = qn.quantized_range(params.num_bits, signed=True)
  fmin = qn.dequantize_array(np.array(qmin), params)
  fmax = qn.dequantize_array(np.array(qmax), params)
  if params.symmetric:
    fmin = -fmax  # scale derives from qmax for symmetric quantization.
  return fmin, fmax


def _qsv_for_tensor(
    tensor_name: str,
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
) -> Optional[dict]:
  """Tensor QSV, with the op's input-activation QSV nested for algorithms
  (GPTQ) that need activation statistics while quantizing weights."""
  val = qsvs.get(tensor_name)
  if op_info.op is not None and op_info.op.inputs:
    first = op_info.op.inputs[0]
    if first >= 0:
      act_name = graph_info.subgraph.tensors[first].name
      act_qsv = qsvs.get(act_name)
      if act_qsv is not None:
        val = dict(val) if val is not None else {}
        val['activation_tensor_qsv'] = act_qsv
  return val


def _compute_tensor_params(
    tensor,
    is_inbounding_tensor: bool,
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    get_params_fn,
    cache: ParamsCache,
    forced_params=None,
) -> qtyping.TensorTransformationParams:
  """Params+transformations for one active (non-ignored) tensor."""
  data = tensor_data_of(graph_info, tensor)
  is_constant = data is not None
  cfg = op_info.op_quant_config.activation_tensor_config
  if is_constant and op_info.op_name in WEIGHT_BEARING_OPS:
    cfg = op_info.op_quant_config.weight_tensor_config
  quant_params = forced_params
  if quant_params is None and cfg is not None:
    quant_params = cache.lookup(tensor.buffer, cfg) if is_constant else None
    if quant_params is None:
      try:
        qsv = _qsv_for_tensor(tensor.name, op_info, graph_info, qsvs)
        quant_params = get_params_fn(op_info, cfg, data, qsv)
      except Exception as e:
        raise ValueError(
            f'Failed to get quantization parameters for tensor '
            f'{tensor.name!r}: {e}'
        ) from e
      if is_constant:
        cache.insert(tensor.buffer, cfg, quant_params)
  return make_tensor_params(
      tensor.name, op_info, is_inbounding_tensor, quant_params, is_constant
  )


def _forced_params_with_data(
    tensor, graph_info, params: Optional[qtyping.UniformQuantParams]
):
  """Re-quantize constant data under propagated params (same-as-X cases)."""
  if params is None:
    return None
  params = dataclasses.replace(params, quantized_data=None)
  data = tensor_data_of(graph_info, tensor)
  if data is None:
    return params
  return dataclasses.replace(
      params, quantized_data=qn.quantize_array(data, params)
  )


@dataclasses.dataclass
class _OpTensors:
  """Op operands split into active / ignored, order preserved."""

  # Each entry: (slot, tensor, ignored) where slot is the output index into
  # the final params list.
  inputs: list
  outputs: list


def _collect_op_tensors(
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    inputs_to_ignore: Sequence[int],
    outputs_to_ignore: Sequence[int],
) -> _OpTensors:
  """Split operands by ignore lists; auto-ignore non-float32 tensors.

  Index semantics: ignore lists refer to operand positions in op.inputs /
  op.outputs (before dropping -1 entries).
  """
  tensors = graph_info.subgraph.tensors

  def build(ids, ignore_list):
    out = []
    for pos, tid in enumerate(ids):
      if tid < 0:
        continue
      t = tensors[tid]
      ignored = pos in ignore_list or t.dtype != 'float32'
      out.append((t, ignored))
    return out

  return _OpTensors(
      inputs=build(op_info.op.inputs, set(inputs_to_ignore)),
      outputs=build(op_info.op.outputs, set(outputs_to_ignore)),
  )


def materialize_standard_op(
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    get_params_fn,
    cache: Optional[ParamsCache] = None,
    constraint: OpQuantConstraint = OpQuantConstraint.NO_CONSTRAIN,
    inputs_to_ignore: Optional[Sequence[int]] = None,
    outputs_to_ignore: Optional[Sequence[int]] = None,
) -> list:
  """Materialize every tensor of an op.

  Returns [input_0_params, ..., input_n_params, output_0_params, ...] in
  operand order (absent -1 operands skipped; ignored operands present with
  NO_QUANTIZE).
  """
  cache = cache if cache is not None else ParamsCache()
  ts = _collect_op_tensors(
      op_info, graph_info, inputs_to_ignore or [], outputs_to_ignore or []
  )
  active_inputs = [t for t, ign in ts.inputs if not ign]
  active_outputs = [t for t, ign in ts.outputs if not ign]

  computed: dict = {}  # tensor name -> TensorTransformationParams

  if active_inputs or active_outputs:
    if constraint == OpQuantConstraint.SAME_AS_INPUT_SCALE:
      if len(active_inputs) != 1:
        raise ValueError(
            f'SAME_AS_INPUT_SCALE op {op_info.op_name} must have exactly one '
            f'active input, got {len(active_inputs)}.'
        )
      src = _compute_tensor_params(
          active_inputs[0], True, op_info, graph_info, qsvs, get_params_fn,
          cache)
      computed[active_inputs[0].name] = src
      src_params = src.consumers[0].parameters
      if src_params is not None and not isinstance(
          src_params, qtyping.UniformQuantParams):
        raise ValueError(
            'SAME_AS_INPUT_SCALE requires UniformQuantParams, got '
            f'{type(src_params)} for {src.tensor_name}.')
      for out_t in active_outputs:
        computed[out_t.name] = make_tensor_params(
            out_t.name, op_info, False,
            _forced_params_with_data(out_t, graph_info, src_params),
            is_constant=tensor_data_of(graph_info, out_t) is not None,
        )
      # Propagate the input QSV to outputs so downstream consumers see
      # consistent ranges (graph is acyclic, safe).
      in_qsv = qsvs.get(active_inputs[0].name)
      if in_qsv is None:
        if tensor_data_of(graph_info, active_inputs[0]) is None:
          raise ValueError(
              f'Input tensor QSV is None for {active_inputs[0].name!r} under '
              'SAME_AS_INPUT_SCALE.')
        if src_params is not None:
          mn, mx = min_max_from_quant_params(src_params)
          in_qsv = {'min': mn, 'max': mx}
      if in_qsv is not None:
        for out_t in active_outputs:
          qsvs[out_t.name] = in_qsv

    elif constraint == OpQuantConstraint.SAME_AS_OUTPUT_SCALE:
      if len(active_outputs) != 1:
        raise ValueError(
            f'SAME_AS_OUTPUT_SCALE op {op_info.op_name} must have exactly '
            f'one active output, got {len(active_outputs)}.'
        )
      dst = _compute_tensor_params(
          active_outputs[0], False, op_info, graph_info, qsvs, get_params_fn,
          cache)
      computed[active_outputs[0].name] = dst
      dst_params = dst.producer.parameters if dst.producer else None
      if dst_params is not None and not isinstance(
          dst_params, qtyping.UniformQuantParams):
        raise ValueError(
            'SAME_AS_OUTPUT_SCALE requires UniformQuantParams, got '
            f'{type(dst_params)} for {dst.tensor_name}.')
      for in_t in active_inputs:
        computed[in_t.name] = make_tensor_params(
            in_t.name, op_info, True,
            _forced_params_with_data(in_t, graph_info, dst_params),
            is_constant=tensor_data_of(graph_info, in_t) is not None,
        )

    else:  # NO_CONSTRAIN / FIXED_OUTPUT_SCALE (fixed handled by caller).
      for in_t in active_inputs:
        computed[in_t.name] = _compute_tensor_params(
            in_t, True, op_info, graph_info, qsvs, get_params_fn, cache)
      for out_t in active_outputs:
        computed[out_t.name] = _compute_tensor_params(
            out_t, False, op_info, graph_info, qsvs, get_params_fn, cache)

  result = []
  for t, ignored in ts.inputs:
    result.append(
        _no_quantize_params(t.name, op_info, True)
        if ignored else computed[t.name]
    )
  for t, ignored in ts.outputs:
    result.append(
        _no_quantize_params(t.name, op_info, False)
        if ignored else computed[t.name]
    )
  return result


def materialize_op_with_fixed_output_params(
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    fixed_params_by_bits: dict,
    get_params_fn,
    cache: Optional[ParamsCache] = None,
) -> list:
  """Fixed-output-scale ops (softmax/logistic/tanh): override output params.

  The op's kernel produces a known output range, so the output scale/zp are
  pinned regardless of calibration, and the QSV store is rewritten to match.
  """
  if len(op_info.op.outputs) != 1:
    raise ValueError(
        'Fixed-output-scale materialization supports single-output ops only.')
  tensor_params = materialize_standard_op(
      op_info, graph_info, qsvs, get_params_fn, cache,
      constraint=OpQuantConstraint.FIXED_OUTPUT_SCALE,
  )
  out_params = tensor_params[-1]
  act_cfg = op_info.op_quant_config.activation_tensor_config
  if act_cfg is not None and out_params.producer is not None:
    if act_cfg.num_bits not in fixed_params_by_bits:
      raise ValueError(
          f'No fixed output params for {act_cfg.num_bits}-bit activations on '
          f'{op_info.op_name}.')
    fixed = fixed_params_by_bits[act_cfg.num_bits]
    out_params.producer = qtyping.OpToTensorParams(
        subgraph_op_id=out_params.producer.subgraph_op_id,
        transformations=out_params.producer.transformations,
        parameters=fixed,
    )
    mn, mx = min_max_from_quant_params(fixed)
    if out_params.tensor_name in qsvs:
      qsvs[out_params.tensor_name]['min'] = mn
      qsvs[out_params.tensor_name]['max'] = mx
  return tensor_params


def materialize_fc_conv(
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    get_params_fn,
    cache: Optional[ParamsCache] = None,
    input_index: int = 0,
    weight_index: int = 1,
    bias_index: int = 2,
) -> list:
  """FC / CONV_2D / DEPTHWISE_CONV_2D / CONV_2D_TRANSPOSE with fused bias.

  The bias is excluded from standard materialization and quantized afterward
  at scale = input_scale * weight_scale (SRQ only). Pre-quantized or
  too-small (< min_weight_elements) weights are left untouched.
  """
  cache = cache if cache is not None else ParamsCache()
  tensors = graph_info.subgraph.tensors
  ignored = [bias_index]
  w_tid = op_info.op.inputs[weight_index]
  w_tensor = tensors[w_tid] if w_tid >= 0 else None
  if w_tensor is not None:
    w_data = tensor_data_of(graph_info, w_tensor)
    too_small = (
        w_data is not None
        and w_data.size < op_info.op_quant_config.min_weight_elements
    )
    if is_quantized_tensor(w_tensor) or too_small:
      ignored.append(weight_index)

  params = materialize_standard_op(
      op_info, graph_info, qsvs, get_params_fn, cache,
      inputs_to_ignore=ignored,
  )

  # Fused-bias handling.
  b_tid = op_info.op.inputs[bias_index] if bias_index < len(
      op_info.op.inputs) else -1
  if b_tid >= 0:
    bias_tensor = tensors[b_tid]
    if not is_quantized_tensor(bias_tensor):
      is_srq = (
          op_info.op_quant_config.compute_precision
          == qtyping.ComputePrecision.INTEGER
          and op_info.op_quant_config.activation_tensor_config is not None
      )
      bias_qparams = None
      if is_srq:
        # Positions in the result list: operand order with -1 skipped.
        in_slot = _operand_slot(op_info.op.inputs, input_index)
        w_slot = _operand_slot(op_info.op.inputs, weight_index)
        in_params = params[in_slot].consumers[0].parameters
        w_params = params[w_slot].consumers[0].parameters
        if w_params is None and w_tensor is not None and is_quantized_tensor(
            w_tensor):
          q = w_tensor.quantization
          w_cfg = op_info.op_quant_config.weight_tensor_config
          if w_cfg is None:
            raise ValueError(
                'weight_tensor_config required when weight is pre-quantized.')
          w_params = qtyping.UniformQuantParams(
              num_bits=w_cfg.num_bits, scale=np.asarray(q.scale),
              zero_point=np.asarray(q.zero_point),
              quantized_dimension=q.quantized_dimension,
          )
        try:
          bias_qparams = qn.quantize_bias(
              tensor_data_of(graph_info, bias_tensor), in_params, w_params
          )
        except Exception as e:
          raise ValueError(
              f'Failed to quantize bias for op {op_info.op_name} '
              f'(op id {op_info.subgraph_op_index}).'
          ) from e
      b_slot = _operand_slot(op_info.op.inputs, bias_index)
      params[b_slot] = make_tensor_params(
          bias_tensor.name, op_info, is_inbounding_tensor=True,
          quant_params=bias_qparams,
          # Bias quantizes in place only under SRQ; DRQ / weight-only leave
          # it float.
          is_constant=is_srq,
      )
  return params


def _operand_slot(input_ids: Sequence[int], operand_index: int) -> int:
  """Map an operand position to its slot in the materialized params list
  (absent -1 operands occupy no slot)."""
  return sum(1 for i in input_ids[:operand_index] if i >= 0)
