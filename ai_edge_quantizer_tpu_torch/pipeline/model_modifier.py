"""Model modifier: drives instruction generation + graph rewrite.

Takes the float Graph plus the params-generator output and produces the
quantized Graph. Handles shared-buffer processing order (a shared buffer's
keeper tensor rewrites last so duplicators copy the float data first) and
re-syncs signature IO maps after output tensors are rewired.

Parity: reference `model_modifier.py` (minus FlatBuffer serialization — our
serializer lives in graph/serialize.py).

A copy of `ai_edge_quantizer_tpu/pipeline/model_modifier.py`: the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.pipeline import instruction_generator
from ai_edge_quantizer_tpu_torch.pipeline import transformation_performer


class ModelModifier:
  """Applies quantization params to a float Graph, yielding the quantized
  Graph."""

  def __init__(self, float_graph: ir.Graph):
    self._float_graph = float_graph

  def modify_model(self, params: dict) -> ir.Graph:
    """params: tensor name -> TensorTransformationParams."""
    graph = self._float_graph.clone()
    gen = instruction_generator.TransformationInstructionsGenerator(graph)
    instructions = gen.quant_params_to_transformation_insts(params)
    order = self._tensor_processing_order(instructions, graph)
    performer = transformation_performer.TransformationPerformer()
    performer.transform_graph(instructions, graph,
                              tensor_processing_order=order)
    self._resync_signatures(graph)
    return graph

  def _tensor_processing_order(self, instructions: dict,
                               graph: ir.Graph) -> list:
    """Defer each shared buffer's keeper tensor until after its siblings.

    The params generator marks all but the last tensor of a shared buffer
    for duplication; processing the keeper last lets duplicators copy the
    original float data before the keeper's buffer is quantized in place.
    """
    b2t = ir.buffer_to_tensors(graph)
    keepers = set()
    for refs in b2t.values():
      if len(refs) > 1:
        sg, tid = refs[-1]
        keepers.add(graph.subgraphs[sg].tensors[tid].name)
    order = [n for n in instructions if n not in keepers]
    order += [n for n in instructions if n in keepers]
    return order

  def _resync_signatures(self, graph: ir.Graph) -> None:
    """Follow rewired graph outputs in the signature IO maps.

    When ADD_DEQUANTIZE/ADD_QUANTIZE rewires a graph output, the subgraph's
    `outputs` list is updated positionally; signatures re-derive their tensor
    ids from it. (Parity: reference model_modifier.py:219-288 signature
    fix.)
    """
    for sig in graph.signatures:
      sg = graph.subgraphs[sig.subgraph_index]
      # Positional re-derivation: a signature output's original tensor id may
      # have been replaced in sg.outputs; map by position.
      old_ids = list(sig.outputs.values())
      # Build original-position lookup: signature outputs were created from
      # sg.outputs, so re-map any id that no longer appears.
      for key, tid in list(sig.outputs.items()):
        if tid in sg.outputs:
          continue
        # Find the replacement: an output whose tensor name derives from the
        # original tensor's name (dequant/quantized suffix chain).
        orig_name = sg.tensors[tid].name
        for out_tid in sg.outputs:
          if out_tid in old_ids:
            continue
          name = sg.tensors[out_tid].name
          if name.startswith(orig_name):
            sig.outputs[key] = out_tid
            break
      # Inputs keep their tensor ids (input tensors are never replaced; ops
      # are inserted after them).
