"""Instruction generator: per-tensor transformation params -> ordered,
optimized rewrite instructions.

Optimizations (parity: reference `transformation_instruction_generator.py`):
  * horizontal — consumers requesting identical transformations with equal
    params at the same depth share one instruction (one inserted op serves
    all of them);
  * vertical — a producer ADD_DEQUANTIZE meeting a consumer ADD_QUANTIZE
    with equal params cancels into QUANTIZE_TENSOR; with different params it
    becomes QUANTIZE_TENSOR + requantize (ADD_QUANTIZE on the quantized
    tensor); meeting NO_QUANTIZE consumers it stays a dequantize serving just
    those consumers;
  * duplication cleanup — the last DUPLICATE_TENSOR reuses the original
    tensor; DUPLICATE_BUFFER subsumed by DUPLICATE_TENSOR is dropped;
  * requantize fusion — [QUANTIZE_TENSOR, ADD_QUANTIZE] collapses into one
    QUANTIZE_TENSOR when the producer has no scale constraint;
  * validity — within each duplication subset a tensor cannot be both
    quantized and left float.

A copy of `ai_edge_quantizer_tpu/pipeline/instruction_generator.py`: the
port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.algorithms.uniform import op_library
from ai_edge_quantizer_tpu_torch.graph import ir

_QT = qtyping.QuantTransformation


def check_horizontal_optimization(
    param1: qtyping.OpToTensorParams,
    param2: qtyping.OpToTensorParams,
    index: int,
) -> bool:
  """Can two consumers' transformations at `index` merge into one?"""
  p1, p2 = param1.parameters, param2.parameters
  if (
      isinstance(p1, qtyping.UniformQuantParams)
      and p1.hadamard is not None
      and isinstance(p2, qtyping.UniformQuantParams)
      and p2.hadamard is not None
  ):
    return True
  return (
      p1 == p2
      and len(param1.transformations) > index
      and len(param2.transformations) > index
      and param1.transformations[index] == param2.transformations[index]
  )


def check_dq_q_elimination(producer_inst, consumer_inst) -> bool:
  return (
      producer_inst.transformation == _QT.ADD_DEQUANTIZE
      and consumer_inst.transformation == _QT.ADD_QUANTIZE
      and producer_inst.parameters == consumer_inst.parameters
  )


def check_replace_dq_q_with_rq(producer_inst, consumer_inst) -> bool:
  return (
      producer_inst.transformation == _QT.ADD_DEQUANTIZE
      and consumer_inst.transformation == _QT.ADD_QUANTIZE
      and producer_inst.parameters != consumer_inst.parameters
  )


def check_dq_no_quant_elimination(producer_inst, consumer_inst) -> bool:
  return (
      producer_inst.transformation == _QT.ADD_DEQUANTIZE
      and consumer_inst.transformation == _QT.NO_QUANTIZE
  )


@dataclasses.dataclass(frozen=True)
class TensorGraphInfo:
  tensor_id: int
  subgraph_id: int
  producer: int  # op id, -1 for graph inputs / constants
  consumers: tuple  # op ids; -1 marks "consumed as graph output"


class TransformationInstructionsGenerator:
  """Converts params-generator output into per-tensor instruction lists."""

  def __init__(self, graph: ir.Graph):
    self.graph = graph
    self._tensor_info: dict = {}
    for sg_id, sg in enumerate(graph.subgraphs):
      consumers = collections.defaultdict(list)
      producer_of: dict = {}
      for tid in sg.outputs:
        consumers[tid].append(-1)
      for op_id, op in enumerate(sg.ops):
        for tid in op.inputs:
          consumers[tid].append(op_id)
        for tid in op.outputs:
          producer_of[tid] = op_id
      for tid, tensor in enumerate(sg.tensors):
        self._tensor_info[tensor.name] = TensorGraphInfo(
            tensor_id=tid,
            subgraph_id=sg_id,
            producer=producer_of.get(tid, -1),
            consumers=tuple(consumers[tid]),
        )

  # -- public entry ---------------------------------------------------------

  def quant_params_to_transformation_insts(self, params: dict) -> dict:
    return {
        name: self._tensor_insts(p) for name, p in params.items()
    }

  # -- per-tensor pipeline --------------------------------------------------

  def _tensor_insts(
      self, param: qtyping.TensorTransformationParams
  ) -> qtyping.TensorTransformationInsts:
    info = self._tensor_info[param.tensor_name]
    insts = qtyping.TensorTransformationInsts(
        tensor_name=param.tensor_name, subgraph_id=info.subgraph_id,
        instructions=[],
    )

    # Producer rules target every graph consumer of the tensor.
    transformations: list = []
    if param.producer:
      for t in param.producer.transformations:
        transformations.append(qtyping.TransformationInst(
            transformation=t, tensor_id=info.tensor_id,
            producer=info.producer, consumers=list(info.consumers),
            parameters=param.producer.parameters,
        ))

    groups = self._group_consumers_by_depth(param)
    vertical_candidates = self._first_depth_instructions(groups, param, info)
    deeper = self._deeper_instructions(groups, param, info)

    if transformations:
      transformations += self._apply_vertical_optimization(
          transformations.pop(), vertical_candidates
      )
    else:
      transformations += vertical_candidates
    transformations += deeper
    insts.instructions = transformations

    self._drop_last_tensor_duplication(insts)
    self._drop_redundant_buffer_duplication(insts)
    self._check_valid(insts)
    self._fuse_quantize_requantize(insts)
    return insts

  # -- horizontal grouping --------------------------------------------------

  def _group_consumers_by_depth(
      self, param: qtyping.TensorTransformationParams
  ) -> list:
    """groups[d] = list of sets of consumer indices whose transformation at
    depth d-1 merges; groups[0] is the trivial all-consumers set."""
    if not param or not param.consumers:
      return []
    n = len(param.consumers)
    groups = [[set(range(n))]]
    max_depth = max(len(c.transformations) for c in param.consumers)
    for depth in range(max_depth):
      next_groups: list = []
      for i, consumer in enumerate(param.consumers):
        if len(consumer.transformations) <= depth:
          continue
        for prev_group in groups[depth]:
          if i not in prev_group:
            continue
          placed = False
          for g in next_groups:
            rep = next(iter(g))
            if rep in prev_group and check_horizontal_optimization(
                param.consumers[rep], consumer, depth
            ):
              g.add(i)
              placed = True
              break
          if not placed:
            next_groups.append({i})
      groups.append(next_groups)
    return groups

  def _first_depth_instructions(self, groups, param, info) -> list:
    """Depth-0 consumer instructions (eligible for vertical optimization)."""
    out = []
    if len(groups) > 1:
      for g in groups[1]:
        idxs = list(g)
        out.append(qtyping.TransformationInst(
            transformation=param.consumers[idxs[0]].transformations[0],
            tensor_id=info.tensor_id,
            producer=info.producer,
            consumers=[param.consumers[i].subgraph_op_id for i in idxs],
            parameters=param.consumers[idxs[0]].parameters,
        ))
    return out

  def _deeper_instructions(self, groups, param, info) -> list:
    """Depth >= 1 consumer instructions (never vertically optimized)."""
    out = []
    for depth in range(2, len(groups)):
      for g in groups[depth]:
        idxs = list(g)
        if len(param.consumers[idxs[0]].transformations) <= depth - 1:
          continue
        out.append(qtyping.TransformationInst(
            transformation=param.consumers[idxs[0]].transformations[depth - 1],
            tensor_id=info.tensor_id,
            producer=info.producer,
            consumers=[param.consumers[i].subgraph_op_id for i in idxs],
            parameters=param.consumers[idxs[0]].parameters,
        ))
    return out

  # -- vertical optimization ------------------------------------------------

  def _apply_vertical_optimization(
      self, producer_rule, consumer_rules
  ) -> list:
    out = []
    for rule in consumer_rules:
      if check_dq_q_elimination(producer_rule, rule):
        # Producer DQ + consumer Q, equal params: the tensor just stays
        # quantized for these consumers.
        for cid in rule.consumers:
          if cid in producer_rule.consumers:
            producer_rule.consumers.remove(cid)
        out.append(qtyping.TransformationInst(
            transformation=_QT.QUANTIZE_TENSOR,
            tensor_id=rule.tensor_id, producer=rule.producer,
            consumers=rule.consumers, parameters=rule.parameters,
        ))
      elif check_replace_dq_q_with_rq(producer_rule, rule):
        # Different params: keep quantized at producer params, requantize for
        # these consumers.
        for cid in rule.consumers:
          producer_rule.consumers.remove(cid)
        out.append(qtyping.TransformationInst(
            transformation=_QT.QUANTIZE_TENSOR,
            tensor_id=rule.tensor_id, producer=rule.producer,
            consumers=rule.consumers, parameters=producer_rule.parameters,
        ))
        out.append(qtyping.TransformationInst(
            transformation=_QT.ADD_QUANTIZE,
            tensor_id=rule.tensor_id, producer=rule.producer,
            consumers=rule.consumers, parameters=rule.parameters,
        ))
      elif check_dq_no_quant_elimination(producer_rule, rule):
        # Float consumers get a dequantize scoped to just them.
        for cid in rule.consumers:
          if cid in producer_rule.consumers:
            producer_rule.consumers.remove(cid)
        out.append(qtyping.TransformationInst(
            transformation=_QT.ADD_DEQUANTIZE,
            tensor_id=rule.tensor_id, producer=rule.producer,
            consumers=rule.consumers, parameters=producer_rule.parameters,
        ))
      else:
        out.append(rule)
    if producer_rule.consumers:
      out.insert(0, producer_rule)
    return out

  # -- duplication cleanup --------------------------------------------------

  def _drop_last_tensor_duplication(self, insts) -> None:
    instructions = insts.instructions
    if not instructions:
      return
    for i in range(len(instructions) - 1, -1, -1):
      if instructions[i].transformation == _QT.DUPLICATE_TENSOR:
        instructions.pop(i)
        return

  def _drop_redundant_buffer_duplication(self, insts) -> None:
    """A duplicated tensor already owns a fresh buffer."""
    instructions = insts.instructions
    if not instructions:
      return
    dup_tensor_consumers: set = set()
    for inst in instructions:
      if inst.transformation == _QT.DUPLICATE_TENSOR:
        dup_tensor_consumers.update(inst.consumers)
    if not dup_tensor_consumers:
      return
    for i in range(len(instructions) - 1, -1, -1):
      inst = instructions[i]
      if (
          inst.transformation == _QT.DUPLICATE_BUFFER
          and dup_tensor_consumers.issuperset(inst.consumers)
      ):
        instructions.pop(i)

  # -- requantize fusion ----------------------------------------------------

  def _producer_is_constrained(self, subgraph_id: int, op_id: int) -> bool:
    op = self.graph.subgraphs[subgraph_id].ops[op_id]
    try:
      spec = op_library.OP_SPECS[qtyping.OpName(op.opcode)]
    except (KeyError, ValueError):
      return False
    return (
        spec.constraint != engine.OpQuantConstraint.NO_CONSTRAIN
        or spec.kind in ('fixed_output', 'sum')
    )

  def _fuse_quantize_requantize(self, insts) -> None:
    """[QUANTIZE_TENSOR, ADD_QUANTIZE] -> QUANTIZE_TENSOR at the second
    params, when the producer's scales are unconstrained."""
    instructions = insts.instructions
    if instructions is None or len(instructions) != 2:
      return
    first, second = instructions
    p0, p1 = first.parameters, second.parameters
    if (
        not isinstance(p0, qtyping.UniformQuantParams)
        or not isinstance(p1, qtyping.UniformQuantParams)
        or first.transformation != _QT.QUANTIZE_TENSOR
        or second.transformation != _QT.ADD_QUANTIZE
        or first.consumers != second.consumers
        or first.producer == -1  # graph-input tensors keep the requantize
        or self._producer_is_constrained(insts.subgraph_id, first.producer)
    ):
      return
    # Params must agree in everything but scale/zp.
    if not _params_compatible_modulo_scale(p0, p1):
      return
    first.parameters = dataclasses.replace(
        p0, scale=p1.scale, zero_point=p1.zero_point
    )
    instructions.pop(1)

  # -- validity -------------------------------------------------------------

  def _split_by_tensor_duplication(self, insts) -> list:
    """Partition instructions by target tensor (original vs duplicates)."""
    subsets: list = [[]]
    consumer_to_subset: dict = {}
    for inst in insts.instructions:
      if inst.transformation == _QT.DUPLICATE_TENSOR:
        subsets.append([inst])
        idx = len(subsets) - 1
        for c in inst.consumers:
          if consumer_to_subset.setdefault(c, idx) != idx:
            raise ValueError(
                f'Tensor {insts.tensor_name}: DUPLICATE_TENSOR must be the '
                'first instruction for its consumers.'
            )
      else:
        idx = consumer_to_subset.setdefault(inst.consumers[0], 0)
        subsets[idx].append(inst)
    return subsets

  def _check_valid(self, insts) -> None:
    for subset in self._split_by_tensor_duplication(insts):
      unquantized = any(
          i.transformation == _QT.NO_QUANTIZE for i in subset)
      quantized = any(
          i.transformation in (_QT.QUANTIZE_TENSOR, _QT.ADD_DEQUANTIZE)
          for i in subset)
      if unquantized and quantized:
        raise ValueError(
            f'Tensor {insts.tensor_name} cannot be simultaneously quantized '
            'and unquantized.'
        )


def _params_compatible_modulo_scale(
    p0: qtyping.UniformQuantParams, p1: qtyping.UniformQuantParams
) -> bool:
  """Equal in every field except scale/zero_point (arrays compared by value)."""
  import numpy as np

  if (
      p0.num_bits != p1.num_bits
      or p0.quantized_dimension != p1.quantized_dimension
      or p0.symmetric != p1.symmetric
      or p0.block_size != p1.block_size
      or p0.hadamard != p1.hadamard
  ):
    return False
  a, b = p0.quantized_data, p1.quantized_data
  if a is None or b is None:
    return a is b
  return np.array_equal(a, b)
