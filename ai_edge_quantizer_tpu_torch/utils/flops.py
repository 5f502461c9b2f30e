"""Analytic FLOPs accounting over the Graph IR.

Counts multiply-accumulate FLOPs (2 * MACs) of the matmul-class ops (FC,
the convolutions, BATCH_MATMUL) per subgraph, which a benchmark divides by
a measured call time and the device's peak to give an MFU fraction.
Elementwise and reduction ops are not counted: on the matmul-bound models
they are under 1% of the FLOPs.

A copy of `ai_edge_quantizer_tpu/utils/flops.py` over the port's IR (the
same counts).
"""

from __future__ import annotations

from ai_edge_quantizer_tpu_torch.graph import ir


def _prod(shape) -> int:
  n = 1
  for s in shape:
    n *= int(s)
  return n


def op_flops(subgraph: ir.Subgraph, op: ir.Op) -> int:
  """Matmul-class FLOPs (2 * MACs) for one op; 0 for other ops."""
  t = subgraph.tensors

  def out_elems(i: int = 0) -> int:
    return _prod(t[op.outputs[i]].shape)

  if op.opcode == 'FULLY_CONNECTED':
    w = t[op.inputs[1]]
    k = int(w.shape[-1])  # weight layout [N, K] (reference FC convention)
    return 2 * out_elems() * k
  if op.opcode == 'CONV_2D':
    w = t[op.inputs[1]]  # [out_c, kh, kw, in_c]
    return 2 * out_elems() * int(w.shape[1]) * int(w.shape[2]) * int(
        w.shape[3])
  if op.opcode == 'DEPTHWISE_CONV_2D':
    w = t[op.inputs[1]]  # [1, kh, kw, ch]
    return 2 * out_elems() * int(w.shape[1]) * int(w.shape[2])
  if op.opcode == 'CONV_2D_TRANSPOSE':
    # Every input pixel scatters a kh x kw x out_c stencil.
    w = t[op.inputs[1]]  # [out_c, kh, kw, in_c]
    x = t[op.inputs[2]]  # operand order: output_shape, weights, input, bias?
    return 2 * _prod(x.shape) * int(w.shape[0]) * int(w.shape[1]) * int(
        w.shape[2])
  if op.opcode == 'BATCH_MATMUL':
    x = t[op.inputs[0]]
    k = int(x.shape[-2] if op.attrs.get('adj_x', False) else x.shape[-1])
    return 2 * out_elems() * k
  return 0


def subgraph_flops(subgraph: ir.Subgraph) -> int:
  return sum(op_flops(subgraph, op) for op in subgraph.ops)


def graph_flops(graph: ir.Graph, signature_key=None) -> int:
  """Total matmul-class FLOPs of one forward pass.

  With `signature_key`, counts only that signature's subgraph; otherwise
  counts the main subgraph.
  """
  if signature_key is not None:
    sg = graph.subgraph_for_signature(signature_key)
  else:
    sg = graph.main_subgraph()
  return subgraph_flops(sg)
