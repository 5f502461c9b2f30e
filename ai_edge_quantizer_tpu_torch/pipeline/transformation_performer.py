"""Transformation performer: applies instruction lists to the Graph.

Tracks op-id shifts as ops are inserted (original -> current id maps per
subgraph) and updates not-yet-applied instructions whose source tensor was
replaced by an inserted op or duplicated tensor.

Parity: reference `transformation_performer.py`.

A copy of `ai_edge_quantizer_tpu/pipeline/transformation_performer.py`: the
port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.pipeline import transformations

_QT = qtyping.QuantTransformation

def _emulated_subchannel_removed(*_args, **_kwargs):
  raise ValueError(
      'EMULATED_SUBCHANNEL is deprecated; use blockwise granularity '
      'instead (ref transformation_performer.py:73-75).')


_TRANSFORMATION_FNS = {
    _QT.EMULATED_SUBCHANNEL: _emulated_subchannel_removed,
    _QT.QUANTIZE_TENSOR: transformations.quantize_tensor,
    _QT.ADD_DEQUANTIZE: transformations.insert_dequantize,
    _QT.ADD_QUANTIZE: transformations.insert_quantize,
    _QT.DUPLICATE_BUFFER: transformations.duplicate_buffer,
    _QT.DUPLICATE_TENSOR: transformations.duplicate_tensor,
    _QT.INSERT_HADAMARD_ROTATION: transformations.insert_hadamard_rotation,
    _QT.INSERT_DECOMPOSED_HADAMARD_ROTATION:
        transformations.insert_decomposed_hadamard_rotation,
}


class TransformationPerformer:
  """Applies all tensors' instructions to a Graph in place."""

  def __init__(self):
    self._original_op_id_map: list = []
    self._added_op_id_map: list = []
    self._buffer_origin: dict = {}

  def _init_op_id_maps(self, graph: ir.Graph) -> None:
    self._original_op_id_map = [
        list(range(len(sg.ops))) for sg in graph.subgraphs
    ]
    self._added_op_id_map = [[] for _ in graph.subgraphs]

  def _map_producer(self, subgraph_id: int, original_id) -> int:
    if original_id is None or original_id < 0:
      return -1
    omap = self._original_op_id_map[subgraph_id]
    if original_id < len(omap):
      return omap[original_id]
    return self._added_op_id_map[subgraph_id][original_id - len(omap)]

  def _map_consumers(self, subgraph_id: int, original_ids: list) -> list:
    return [
        -1 if c == -1 else self._original_op_id_map[subgraph_id][c]
        for c in original_ids
    ]

  def _apply_one(
      self,
      insts: qtyping.TensorTransformationInsts,
      index: int,
      graph: ir.Graph,
  ) -> None:
    inst = insts.instructions[index]
    sg_id = insts.subgraph_id
    t_input = transformations.TransformationInput(
        tensor_id=inst.tensor_id,
        graph=graph,
        subgraph=graph.subgraphs[sg_id],
        producer=self._map_producer(sg_id, inst.producer),
        consumers=self._map_consumers(sg_id, inst.consumers),
        quant_params=inst.parameters,
        buffer_origin=self._buffer_origin,
    )
    info = _TRANSFORMATION_FNS[inst.transformation](t_input)

    # Update later instructions that touch the same consumers: they must now
    # read the transformation's output tensor, produced by the added op.
    was_op_added = info.num_ops_added > 0
    if was_op_added:
      self._added_op_id_map[sg_id].append(
          info.op_id + info.num_ops_added - 1)
    if was_op_added or inst.transformation == _QT.DUPLICATE_TENSOR:
      n_orig = len(self._original_op_id_map[sg_id])
      for j in range(index + 1, len(insts.instructions)):
        later = insts.instructions[j]
        if any(c in inst.consumers for c in later.consumers):
          if was_op_added:
            later.producer = n_orig + len(self._added_op_id_map[sg_id]) - 1
          later.tensor_id = info.output_tensor_id

    # Shift original op ids by the number of inserted ops.
    if was_op_added:
      real_consumers = [c for c in inst.consumers if c >= 0]
      shift_from = (
          min(real_consumers) if real_consumers else inst.producer + 1
      )
      omap = self._original_op_id_map[sg_id]
      for i in range(len(omap)):
        if i >= shift_from:
          omap[i] += info.num_ops_added

  def transform_graph(
      self,
      instructions: dict,
      graph: ir.Graph,
      tensor_processing_order: Optional[Sequence[str]] = None,
  ) -> None:
    self._init_op_id_maps(graph)
    self._buffer_origin = {}
    order = (
        tensor_processing_order
        if tensor_processing_order is not None
        else list(instructions.keys())
    )
    from ai_edge_quantizer_tpu_torch.utils import progress_utils
    bar = progress_utils.ProgressBar(
        len(order), description='Applying transformations',
        disappear_on_finish=True)
    for tensor_name in order:
      bar.update_single_step()
      insts = instructions[tensor_name]
      if not insts.instructions:
        continue
      for index, inst in enumerate(insts.instructions):
        if inst.transformation == _QT.NO_QUANTIZE:
          continue
        self._apply_one(insts, index, graph)
    bar.close()
    self._buffer_origin = {}
