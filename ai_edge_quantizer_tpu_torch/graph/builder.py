"""Convenience builder for constructing Graph IR models (PyTorch port).

A copy of `ai_edge_quantizer_tpu/graph/builder.py` (numpy only).

Used by the model zoo (`models/`), test fixtures, and the JAX importer.
Weight layout conventions follow the reference vocabulary so per-op
quantized-dimension tables carry over (reference
tfl_flatbuffer_utils.py:95-106):

  FULLY_CONNECTED: weight [out, in], quantized dim 0; y = x @ w.T + b
  CONV_2D:         weight [out_c, kh, kw, in_c] (NHWC acts), quantized dim 0
  DEPTHWISE_CONV_2D: weight [1, kh, kw, ch_mult*in_c], quantized dim 3
  CONV_2D_TRANSPOSE: weight [out_c, kh, kw, in_c], quantized dim 0
  EMBEDDING_LOOKUP: weight [vocab, dim], quantized dim 0
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ai_edge_quantizer_tpu_torch.graph import ir


class GraphBuilder:
  """Builds one subgraph; `finalize` attaches it to a Graph with a signature."""

  def __init__(self, name: str = 'main', graph: Optional[ir.Graph] = None):
    self.graph = graph if graph is not None else ir.Graph()
    self.subgraph = ir.Subgraph(name=name)
    self.graph.subgraphs.append(self.subgraph)
    self.subgraph_index = len(self.graph.subgraphs) - 1
    self._sig_inputs: dict = {}
    self._sig_outputs: dict = {}
    self._counter = 0

  # -- tensors --------------------------------------------------------------

  def input(self, name: str, shape: Sequence[int],
            dtype: str = 'float32',
            user_name: Optional[str] = None) -> int:
    tid = self.subgraph.add_tensor(ir.Tensor(name=name, shape=tuple(shape),
                                             dtype=dtype))
    self.subgraph.inputs.append(tid)
    self._sig_inputs[user_name or name.split('/')[-1]] = tid
    return tid

  def constant(self, name: str, data: np.ndarray,
               dtype: Optional[str] = None) -> int:
    data = np.asarray(data)
    if dtype is None:
      dtype = str(data.dtype)
    buf = self.graph.add_buffer(data)
    tid = self.subgraph.add_tensor(
        ir.Tensor(name=name, shape=data.shape, dtype=dtype, buffer=buf))
    return tid

  def shared_constant(self, name: str, buffer_id: int, shape: Sequence[int],
                      dtype: str) -> int:
    """A constant tensor aliasing an existing buffer (shared-weight case)."""
    return self.subgraph.add_tensor(
        ir.Tensor(name=name, shape=tuple(shape), dtype=dtype,
                  buffer=buffer_id))

  def activation(self, name: str, shape: Sequence[int],
                 dtype: str = 'float32') -> int:
    return self.subgraph.add_tensor(
        ir.Tensor(name=name, shape=tuple(shape), dtype=dtype))

  def _auto_name(self, base: str) -> str:
    self._counter += 1
    return f'{base}_{self._counter}'

  # -- ops ------------------------------------------------------------------

  def op(
      self,
      opcode: str,
      inputs: Sequence[int],
      output_shapes: Sequence[Sequence[int]],
      output_names: Optional[Sequence[str]] = None,
      attrs: Optional[dict] = None,
      output_dtypes: Optional[Sequence[str]] = None,
  ) -> Union[int, list]:
    """Append an op; creates its output tensors. Returns output tensor id(s)."""
    if output_names is None:
      output_names = [self._auto_name(opcode.lower())
                      for _ in output_shapes]
    if output_dtypes is None:
      output_dtypes = ['float32'] * len(output_shapes)
    out_ids = [
        self.subgraph.add_tensor(
            ir.Tensor(name=n, shape=tuple(s), dtype=d))
        for n, s, d in zip(output_names, output_shapes, output_dtypes)
    ]
    self.subgraph.ops.append(
        ir.Op(opcode=opcode, inputs=list(inputs), outputs=list(out_ids),
              attrs=dict(attrs or {})))
    return out_ids[0] if len(out_ids) == 1 else out_ids

  # -- common layers --------------------------------------------------------

  def fully_connected(self, x: int, weight: np.ndarray,
                      bias: Optional[np.ndarray] = None,
                      name: str = 'fc', activation: str = 'NONE') -> int:
    """weight is [out, in]."""
    w = self.constant(f'{name}/w', np.asarray(weight, np.float32))
    b = self.constant(f'{name}/b', np.asarray(bias, np.float32)) \
        if bias is not None else -1
    in_shape = self.subgraph.tensors[x].shape
    out_shape = tuple(in_shape[:-1]) + (weight.shape[0],)
    return self.op(
        'FULLY_CONNECTED', [x, w, b], [out_shape],
        output_names=[f'{name}/out'],
        attrs={'fused_activation': activation},
    )

  def conv2d(self, x: int, weight: np.ndarray,
             bias: Optional[np.ndarray] = None, stride: int = 1,
             padding: str = 'SAME', name: str = 'conv',
             activation: str = 'NONE') -> int:
    """NHWC input; weight [out_c, kh, kw, in_c]."""
    w = self.constant(f'{name}/w', np.asarray(weight, np.float32))
    b = self.constant(f'{name}/b', np.asarray(bias, np.float32)) \
        if bias is not None else -1
    n, h, wdt, _ = self.subgraph.tensors[x].shape
    out_c, kh, kw, _ = weight.shape
    if padding == 'SAME':
      oh, ow = -(-h // stride), -(-wdt // stride)
    else:
      oh, ow = (h - kh) // stride + 1, (wdt - kw) // stride + 1
    return self.op(
        'CONV_2D', [x, w, b], [(n, oh, ow, out_c)],
        output_names=[f'{name}/out'],
        attrs={'stride': stride, 'padding': padding,
               'fused_activation': activation},
    )

  def depthwise_conv2d(self, x: int, weight: np.ndarray,
                       bias: Optional[np.ndarray] = None, stride: int = 1,
                       padding: str = 'SAME', name: str = 'dwconv',
                       activation: str = 'NONE') -> int:
    """weight [1, kh, kw, channels]."""
    w = self.constant(f'{name}/w', np.asarray(weight, np.float32))
    b = self.constant(f'{name}/b', np.asarray(bias, np.float32)) \
        if bias is not None else -1
    n, h, wdt, _ = self.subgraph.tensors[x].shape
    _, kh, kw, ch = weight.shape
    if padding == 'SAME':
      oh, ow = -(-h // stride), -(-wdt // stride)
    else:
      oh, ow = (h - kh) // stride + 1, (wdt - kw) // stride + 1
    return self.op(
        'DEPTHWISE_CONV_2D', [x, w, b], [(n, oh, ow, ch)],
        output_names=[f'{name}/out'],
        attrs={'stride': stride, 'padding': padding,
               'fused_activation': activation},
    )

  def embedding_lookup(self, ids: int, table: np.ndarray,
                       name: str = 'embedding') -> int:
    w = self.constant(f'{name}/w', np.asarray(table, np.float32))
    ids_shape = self.subgraph.tensors[ids].shape
    out_shape = tuple(ids_shape) + (table.shape[-1],)
    return self.op('EMBEDDING_LOOKUP', [ids, w], [out_shape],
                   output_names=[f'{name}/out'])

  def unary(self, opcode: str, x: int, name: Optional[str] = None,
            attrs: Optional[dict] = None,
            out_shape: Optional[Sequence[int]] = None) -> int:
    shape = out_shape if out_shape is not None \
        else self.subgraph.tensors[x].shape
    return self.op(opcode, [x], [shape],
                   output_names=[name] if name else None, attrs=attrs)

  def binary(self, opcode: str, a: int, b: int,
             name: Optional[str] = None,
             out_shape: Optional[Sequence[int]] = None) -> int:
    if out_shape is None:
      sa = self.subgraph.tensors[a].shape
      sb = self.subgraph.tensors[b].shape
      out_shape = np.broadcast_shapes(sa, sb)
    return self.op(opcode, [a, b], [out_shape],
                   output_names=[name] if name else None)

  # -- finalize -------------------------------------------------------------

  def output(self, tensor_id: int, user_name: Optional[str] = None) -> None:
    self.subgraph.outputs.append(tensor_id)
    key = user_name or self.subgraph.tensors[tensor_id].name.split('/')[-1]
    self._sig_outputs[key] = tensor_id

  def finalize(self, signature_key: str = 'serving_default') -> ir.Graph:
    self.graph.signatures.append(
        ir.SignatureDef(
            signature_key=signature_key,
            subgraph_index=self.subgraph_index,
            inputs=dict(self._sig_inputs),
            outputs=dict(self._sig_outputs),
        )
    )
    ir.graph_unique_tensor_names_check(self.graph)
    return self.graph
