"""Graph rewrite primitives applied by the transformation performer.

Each function mutates the Graph in place and reports what changed
(`TransformationInfo`) so the performer can re-map op ids in later
instructions.

Parity: reference `transformations/` package (quantize_tensor,
dequant_insert, quant_insert, duplicate_buffer, duplicate_tensor), on our IR
instead of FlatBuffers. Sub-byte packing happens at serialization /
kernel-launch time, not here — buffers hold logical int8 containers.

A copy of `ai_edge_quantizer_tpu/pipeline/transformations.py`: the port
keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.graph import ir


@dataclasses.dataclass
class TransformationInput:
  """Everything a rewrite needs. `producer`/`consumers` are CURRENT op ids."""

  tensor_id: int
  graph: ir.Graph
  subgraph: ir.Subgraph
  producer: int
  consumers: list
  quant_params: Optional[qtyping.TensorQuantParams]
  # buffer id -> id(quant params applied); prevents double-quantizing shared
  # buffers and catches conflicting shared-buffer writes.
  buffer_origin: dict


@dataclasses.dataclass
class TransformationInfo:
  """What a rewrite did."""

  op_id: int = 0          # insertion position of the first added op
  num_ops_added: int = 0
  output_tensor_id: int = 0  # tensor later instructions should target


def _storage_dtype_for_params(params: qtyping.TensorQuantParams) -> str:
  if isinstance(params, qtyping.NonLinearQuantParams):
    return 'float16'
  return ir.dtype_for_bits(params.num_bits)


def _quantization_info_from_params(
    params: qtyping.UniformQuantParams) -> ir.QuantizationInfo:
  return ir.QuantizationInfo(
      scale=np.asarray(params.scale, np.float32),
      zero_point=np.asarray(params.zero_point),
      quantized_dimension=params.quantized_dimension,
      num_bits=params.num_bits,
      block_size=params.block_size,
  )


def quantize_tensor(t: TransformationInput) -> TransformationInfo:
  """Convert a tensor to quantized storage in place.

  Constants get their buffer rewritten with quantized data (once per shared
  buffer); activations just change dtype and carry the params.
  """
  tensor = t.subgraph.tensors[t.tensor_id]
  params = t.quant_params
  if isinstance(params, qtyping.NonLinearQuantParams):
    tensor.dtype = 'float16'
    if params.quantized_data is not None and tensor.buffer >= 0:
      if t.buffer_origin.get(tensor.buffer) is None:
        t.graph.buffers[tensor.buffer].data = np.asarray(
            params.quantized_data)
        t.buffer_origin[tensor.buffer] = id(params)
    return TransformationInfo(op_id=0, num_ops_added=0,
                              output_tensor_id=t.tensor_id)
  if not isinstance(params, qtyping.UniformQuantParams):
    raise ValueError(
        f'QUANTIZE_TENSOR requires quant params, got {type(params)} for '
        f'tensor {tensor.name!r}.')
  tensor.quantization = _quantization_info_from_params(params)
  tensor.dtype = _storage_dtype_for_params(params)
  if params.quantized_data is not None and tensor.buffer >= 0:
    if t.buffer_origin.get(tensor.buffer) is None:
      t.graph.buffers[tensor.buffer].data = np.asarray(params.quantized_data)
      t.buffer_origin[tensor.buffer] = id(params)
  return TransformationInfo(op_id=0, num_ops_added=0,
                            output_tensor_id=t.tensor_id)


def _insertion_position(t: TransformationInput) -> int:
  real_consumers = [c for c in t.consumers if c >= 0]
  if real_consumers:
    return min(real_consumers)
  return t.producer + 1


def _rewire_consumers(t: TransformationInput, new_tensor_id: int) -> None:
  """Point the instructed consumers (and graph outputs for -1) at the new
  tensor."""
  old = t.tensor_id
  for c in t.consumers:
    if c == -1:
      for i, out_tid in enumerate(t.subgraph.outputs):
        if out_tid == old:
          t.subgraph.outputs[i] = new_tensor_id
    else:
      op = t.subgraph.ops[c]
      op.inputs = [new_tensor_id if tid == old else tid for tid in op.inputs]


def insert_dequantize(t: TransformationInput) -> TransformationInfo:
  """quantized tensor -> DEQUANTIZE -> float tensor feeding the consumers."""
  quantize_tensor(t)  # source becomes quantized storage
  src = t.subgraph.tensors[t.tensor_id]
  new_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_dequant', shape=src.shape, dtype='float32'))
  pos = _insertion_position(t)
  _rewire_consumers(t, new_tid)
  t.subgraph.ops.insert(pos, ir.Op(
      opcode=qtyping.OpName.DEQUANTIZE.value,
      inputs=[t.tensor_id], outputs=[new_tid]))
  return TransformationInfo(op_id=pos, num_ops_added=1,
                            output_tensor_id=new_tid)


def insert_quantize(t: TransformationInput) -> TransformationInfo:
  """tensor -> QUANTIZE -> quantized tensor feeding the consumers.

  Serves both activation quantization (float source) and requantization
  (already-quantized source with different params).
  """
  params = t.quant_params
  if not isinstance(params, qtyping.UniformQuantParams):
    raise ValueError('ADD_QUANTIZE requires UniformQuantParams.')
  src = t.subgraph.tensors[t.tensor_id]
  new_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_quantized', shape=src.shape,
      dtype=_storage_dtype_for_params(params)))
  t.subgraph.tensors[new_tid].quantization = \
      _quantization_info_from_params(params)
  pos = _insertion_position(t)
  _rewire_consumers(t, new_tid)
  t.subgraph.ops.insert(pos, ir.Op(
      opcode=qtyping.OpName.QUANTIZE.value,
      inputs=[t.tensor_id], outputs=[new_tid]))
  return TransformationInfo(op_id=pos, num_ops_added=1,
                            output_tensor_id=new_tid)


def duplicate_buffer(t: TransformationInput) -> TransformationInfo:
  """Give this tensor a private copy of its (shared) buffer."""
  tensor = t.subgraph.tensors[t.tensor_id]
  data = t.graph.buffers[tensor.buffer].data
  if data is None:
    raise ValueError(
        f'DUPLICATE_BUFFER on tensor {tensor.name!r} without constant data.')
  tensor.buffer = t.graph.add_buffer(np.array(data))
  return TransformationInfo(op_id=0, num_ops_added=0,
                            output_tensor_id=t.tensor_id)


def duplicate_tensor(t: TransformationInput) -> TransformationInfo:
  """Split a constant tensor: instructed consumers get a private clone."""
  src = t.subgraph.tensors[t.tensor_id]
  data = t.graph.buffers[src.buffer].data if src.buffer >= 0 else None
  if data is None:
    raise ValueError(
        f'DUPLICATE_TENSOR on tensor {src.name!r} without constant data.')
  new_buffer = t.graph.add_buffer(np.array(data))
  new_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_duplicated_{t.tensor_id}',
      shape=src.shape, dtype=src.dtype, buffer=new_buffer))
  _rewire_consumers(t, new_tid)
  return TransformationInfo(op_id=0, num_ops_added=0,
                            output_tensor_id=new_tid)


def insert_hadamard_rotation(t: TransformationInput) -> TransformationInfo:
  """float tensor -> HADAMARD_ROTATION custom op -> rotated float tensor.

  Executed by the fused Pallas rotation kernel at runtime.
  """
  params = t.quant_params
  if (
      not isinstance(params, qtyping.UniformQuantParams)
      or params.hadamard is None
  ):
    raise ValueError('INSERT_HADAMARD_ROTATION requires hadamard params.')
  src = t.subgraph.tensors[t.tensor_id]
  new_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_rotated', shape=src.shape, dtype='float32'))
  pos = _insertion_position(t)
  _rewire_consumers(t, new_tid)
  t.subgraph.ops.insert(pos, ir.Op(
      opcode=qtyping.OpName.HADAMARD_ROTATION.value,
      inputs=[t.tensor_id], outputs=[new_tid],
      attrs={'hadamard_size': params.hadamard.hadamard_size,
             'random_binary_vector': params.hadamard.random_binary_vector}))
  return TransformationInfo(op_id=pos, num_ops_added=1,
                            output_tensor_id=new_tid)


def insert_decomposed_hadamard_rotation(
    t: TransformationInput) -> TransformationInfo:
  """Express the rotation with stock ops: reshape -> batch_matmul(H) ->
  reshape, for runtimes without the fused kernel."""
  params = t.quant_params
  if (
      not isinstance(params, qtyping.UniformQuantParams)
      or params.hadamard is None
  ):
    raise ValueError(
        'INSERT_DECOMPOSED_HADAMARD_ROTATION requires hadamard params.')
  src = t.subgraph.tensors[t.tensor_id]
  hsize = params.hadamard.hadamard_size
  dim = src.shape[-1]
  if dim % hsize != 0:
    raise ValueError(
        f'Tensor last dim {dim} not divisible by hadamard size {hsize}.')
  n_blocks = dim // hsize
  lead = int(np.prod(src.shape[:-1])) if len(src.shape) > 1 else 1
  # Normalized Hadamard matrix constant (shared across insertions via
  # content-addressing is future work; one constant per insertion for now).
  hmat = _normalized_hadamard(hsize).astype(np.float32)
  h_buf = t.graph.add_buffer(hmat)
  h_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_hadamard_mat_{hsize}', shape=hmat.shape,
      dtype='float32', buffer=h_buf))
  r1_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_had_reshape0', shape=(lead * n_blocks, hsize),
      dtype='float32'))
  mm_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_had_matmul', shape=(lead * n_blocks, hsize),
      dtype='float32'))
  out_tid = t.subgraph.add_tensor(ir.Tensor(
      name=f'{src.name}_rotated', shape=src.shape, dtype='float32'))
  pos = _insertion_position(t)
  _rewire_consumers(t, out_tid)
  ops = [
      ir.Op(opcode=qtyping.OpName.RESHAPE.value, inputs=[t.tensor_id],
            outputs=[r1_tid],
            attrs={'new_shape': [lead * n_blocks, hsize]}),
      ir.Op(opcode=qtyping.OpName.BATCH_MATMUL.value,
            inputs=[r1_tid, h_tid], outputs=[mm_tid], attrs={}),
      ir.Op(opcode=qtyping.OpName.RESHAPE.value, inputs=[mm_tid],
            outputs=[out_tid], attrs={'new_shape': list(src.shape)}),
  ]
  for i, op in enumerate(ops):
    t.subgraph.ops.insert(pos + i, op)
  return TransformationInfo(op_id=pos, num_ops_added=len(ops),
                            output_tensor_id=out_tid)


def _normalized_hadamard(size: int) -> np.ndarray:
  """Sylvester-construction Hadamard matrix scaled to be orthonormal."""
  if size & (size - 1) != 0:
    raise ValueError(f'Hadamard size must be a power of 2, got {size}.')
  h = np.array([[1.0]])
  while h.shape[0] < size:
    h = np.block([[h, h], [h, -h]])
  return h / np.sqrt(size)
