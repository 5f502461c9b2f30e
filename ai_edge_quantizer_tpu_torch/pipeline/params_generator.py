"""Params generator: the MATERIALIZE pass.

Walks every op of every subgraph (plus virtual INPUT/OUTPUT ops), queries the
recipe for its (algorithm, config), dispatches the algorithm's materialize
function, and merges the per-op tensor views into one
`TensorTransformationParams` per tensor. A post-pass detects constant
tensors/buffers that received conflicting quantization from different
consumers and marks them for duplication (non-constant conflicts are errors).

Parity: reference `params_generator.py`.

A copy of `ai_edge_quantizer_tpu/pipeline/params_generator.py`: the port
keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms import manager as algorithm_manager
from ai_edge_quantizer_tpu_torch.algorithms.registry import AlgorithmName
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.recipe import default_policy
from ai_edge_quantizer_tpu_torch.recipe import recipe_manager as rm

_QT = qtyping.QuantTransformation

# Transformations whose downstream view of the tensor is float.
_FLOAT_SOURCE_TRANSFORMATIONS = (
    _QT.ADD_QUANTIZE,
    _QT.NO_QUANTIZE,
    _QT.INSERT_HADAMARD_ROTATION,
    _QT.INSERT_DECOMPOSED_HADAMARD_ROTATION,
)
# Transformations whose downstream view is quantized storage.
_QUANT_SOURCE_TRANSFORMATIONS = (
    _QT.QUANTIZE_TENSOR,
    _QT.ADD_DEQUANTIZE,
)


class ParamsGenerator:
  """Generates per-tensor transformation params for a whole model."""

  def __init__(self, graph: ir.Graph):
    self.graph = graph
    if not ir.is_float_model(graph):
      # Reference behavior (params_generator.py:42-47): a partially
      # quantized input model is re-quantized with a warning; tensors that
      # already carry quantization stay untouched (the engine ignores
      # pre-quantized weights regardless of the selected recipe).
      warnings.warn(
          'Input model is already partially quantized. Proceeding with '
          're-quantization; existing quantized tensors will remain '
          'unchanged regardless of the selected recipe.'
      )
    ir.graph_unique_tensor_names_check(graph)
    self.buffer_to_tensors = ir.buffer_to_tensors(graph)
    self.model_quant_results: dict = {}
    self._params_cache = engine.ParamsCache()

  def generate_quantization_parameters(
      self,
      model_recipe_manager: rm.RecipeManager,
      model_qsvs: Optional[dict] = None,
  ) -> dict:
    """tensor name -> TensorTransformationParams for the whole model."""
    if model_qsvs is None:
      model_qsvs = {}
    skip_subgraphs: set = set()

    for sg_index, subgraph in enumerate(self.graph.subgraphs):
      graph_info = qtyping.GraphInfo(
          subgraph=subgraph, buffers=self.graph.buffers
      )
      # Real ops first, then virtual IO ops modeling graph inputs/outputs.
      work_items = [(i, op) for i, op in enumerate(subgraph.ops)]
      work_items.append((
          qtyping.VIRTUAL_INPUT_OP_ID,
          ir.Op(opcode=qtyping.OpName.INPUT.value, inputs=[],
                outputs=list(subgraph.inputs)),
      ))
      work_items.append((
          qtyping.VIRTUAL_INPUT_OP_ID,
          ir.Op(opcode=qtyping.OpName.OUTPUT.value,
                inputs=list(subgraph.outputs), outputs=[]),
      ))

      from ai_edge_quantizer_tpu_torch.utils import progress_utils
      bar = progress_utils.ProgressBar(
          len(work_items), description=f'Generating params (sg {sg_index})',
          disappear_on_finish=True)
      for op_id, op in work_items:
        bar.update_single_step()
        try:
          op_key = qtyping.OpName(op.opcode)
        except ValueError:
          # Unknown op: never quantize.
          self._update_results(self._no_quant_op_params(op_id, op, subgraph))
          continue

        scope = ir.get_op_scope(subgraph, op)
        algorithm_name, op_quant_config = (
            model_recipe_manager.get_quantization_configs(op_key, scope)
        )
        if (
            sg_index in skip_subgraphs
            or default_policy.is_non_quantizable_composite_op(op)
        ):
          algorithm_name = AlgorithmName.NO_QUANTIZE

        if algorithm_name == AlgorithmName.NO_QUANTIZE:
          # Opaque composites keep their side-effect subgraphs float too.
          skip_subgraphs.update(op.side_effect_subgraphs)
          op_results = self._no_quant_op_params(op_id, op, subgraph)
        else:
          op_info = qtyping.OpInfo(
              op=op, op_name=op_key, subgraph_op_index=op_id,
              op_quant_config=op_quant_config,
          )
          materialize_fn = algorithm_manager.get_quantization_func(
              algorithm_name, op_key, qtyping.QuantizeMode.MATERIALIZE
          )
          op_results = materialize_fn(
              op_info=op_info,
              graph_info=graph_info,
              qsvs=model_qsvs,
              cache=self._params_cache,
          )
        self._update_results(op_results)
      bar.close()

    self._check_and_fix_buffer_sharing()
    return self.model_quant_results

  # -- helpers --------------------------------------------------------------

  def _no_quant_op_params(self, op_id: int, op: ir.Op,
                          subgraph: ir.Subgraph) -> list:
    def no_quant():
      return qtyping.OpToTensorParams(
          subgraph_op_id=op_id, transformations=[_QT.NO_QUANTIZE])

    out = []
    for tid in op.inputs:
      if tid >= 0:
        out.append(qtyping.TensorTransformationParams(
            tensor_name=subgraph.tensors[tid].name, consumers=[no_quant()]))
    for tid in op.outputs:
      if tid >= 0:
        out.append(qtyping.TensorTransformationParams(
            tensor_name=subgraph.tensors[tid].name, producer=no_quant()))
    return out

  def _update_results(self, op_tensor_results: list) -> None:
    for res in op_tensor_results:
      existing = self.model_quant_results.get(res.tensor_name)
      if existing is None:
        self.model_quant_results[res.tensor_name] = copy.copy(res)
        continue
      if res.producer is not None:
        if existing.producer is not None:
          raise RuntimeError(
              f'Tensor {res.tensor_name!r} received producer params twice; a '
              'tensor has exactly one producing op.'
          )
        existing.producer = res.producer
      if res.consumers is not None:
        existing.consumers = (existing.consumers or []) + list(res.consumers)

  # -- shared buffer / tensor conflict resolution ---------------------------

  def _check_and_fix_buffer_sharing(self) -> None:
    """Mark conflicting shared constants for duplication; raise otherwise."""
    buffers_to_duplicate = []
    tensor_names_to_duplicate = []
    for buffer_idx, tensor_refs in self.buffer_to_tensors.items():
      tensors = [
          self.graph.subgraphs[sg].tensors[tid] for sg, tid in tensor_refs
      ]
      if not tensors:
        continue
      for tensor in tensors:
        if not self._tensor_self_compatible(tensor):
          tensor_names_to_duplicate.append(tensor.name)
      first = tensors[0]
      if first.name in tensor_names_to_duplicate:
        buffers_to_duplicate.append(buffer_idx)
        continue
      for other in tensors[1:]:
        if (
            other.name in tensor_names_to_duplicate
            or not self._tensors_mutually_compatible(first, other)
        ):
          buffers_to_duplicate.append(buffer_idx)
          break

    for buffer_idx in buffers_to_duplicate:
      # All but the last tensor of the buffer get fresh buffers; the last
      # keeps the original.
      for sg, tid in self.buffer_to_tensors[buffer_idx][:-1]:
        name = self.graph.subgraphs[sg].tensors[tid].name
        for c in self.model_quant_results[name].consumers or []:
          c.transformations.insert(0, _QT.DUPLICATE_BUFFER)
    for name in tensor_names_to_duplicate:
      for c in self.model_quant_results[name].consumers or []:
        c.transformations.insert(0, _QT.DUPLICATE_TENSOR)

  def _is_constant(self, tensor) -> bool:
    return (
        tensor.buffer >= 0
        and self.graph.buffers[tensor.buffer].data is not None
    )

  def _tensor_self_compatible(self, tensor) -> bool:
    params = self.model_quant_results.get(tensor.name)
    if params is None:
      return True
    if _consumers_compatible(params):
      return True
    if self._is_constant(tensor):
      return False
    raise RuntimeError(
        f'Tensor {tensor.name!r} has consumers with conflicting quantization '
        'parameters and is not constant; adjust the recipe so its consumers '
        'agree.'
    )

  def _tensors_mutually_compatible(self, t1, t2) -> bool:
    p1 = self.model_quant_results.get(t1.name)
    p2 = self.model_quant_results.get(t2.name)
    if p1 is None or p2 is None:
      return True
    if _self_compatible_pair_compatible(p1, p2):
      return True
    if self._is_constant(t1):
      return False
    raise RuntimeError(
        f'Tensors {t1.name!r} and {t2.name!r} share one buffer but have '
        'conflicting quantization parameters; adjust the recipe.'
    )


def _same_params_except_op_id(
    a: qtyping.OpToTensorParams, b: qtyping.OpToTensorParams
) -> bool:
  return a.transformations == b.transformations and (
      a.parameters == b.parameters
      or (a.parameters is None and b.parameters is None)
  )


def _params_pair_compatible(
    a: qtyping.OpToTensorParams, b: qtyping.OpToTensorParams
) -> bool:
  """Two consumer views coexist iff their first transformation leaves the
  tensor in the same (float vs quantized+same-params) state."""
  if _same_params_except_op_id(a, b):
    return True
  if (
      a.transformations[0] in _FLOAT_SOURCE_TRANSFORMATIONS
      and b.transformations[0] in _FLOAT_SOURCE_TRANSFORMATIONS
  ):
    return True
  if (
      a.transformations[0] in _QUANT_SOURCE_TRANSFORMATIONS
      and b.transformations[0] in _QUANT_SOURCE_TRANSFORMATIONS
      and a.parameters == b.parameters
  ):
    return True
  return False


def _consumers_compatible(params: qtyping.TensorTransformationParams) -> bool:
  if params.consumers is None or len(params.consumers) < 2:
    return True
  first = params.consumers[0]
  return all(
      _params_pair_compatible(c, first) for c in params.consumers[1:]
  )


def _self_compatible_pair_compatible(
    p1: qtyping.TensorTransformationParams,
    p2: qtyping.TensorTransformationParams,
) -> bool:
  if p1.producer is None or p2.producer is None:
    if p1.producer != p2.producer:
      return False
  elif not _params_pair_compatible(p1.producer, p2.producer):
    return False
  if p1.consumers is None or p2.consumers is None:
    if p1.consumers != p2.consumers:
      return False
  elif not _params_pair_compatible(p1.consumers[0], p2.consumers[0]):
    return False
  return True
