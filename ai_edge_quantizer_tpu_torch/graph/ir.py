"""Graph IR: the model substrate of the quantizer (PyTorch port).

A copy of `ai_edge_quantizer_tpu/graph/ir.py` (numpy only): the port keeps
its own so that it never imports the JAX package.

A `Graph` is a device-agnostic, mutable description of a model: subgraphs of
ops over named tensors, with constant data held in a shared buffer table
(several tensors may alias one buffer — required for the shared-weight
conflict semantics of the quantization planner). The executor
(`execution.executor`) lowers a Graph to a single jitted JAX function; the
serializer (`graph.serialize`) round-trips it to a compact on-disk format.

Capability parity: reference model object layer
(`ai_edge_quantizer/utils/tfl_flatbuffer_utils.py` over LiteRT FlatBuffers) —
re-designed: no FlatBuffer schema, tensors carry quantization info directly,
and ops are JAX-lowerable by construction.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterator, Optional

import numpy as np

# Dtypes a tensor may have. Sub-byte dtypes ('int4', 'int2') have packed
# storage in buffers (see utils.packing) but logical shapes here.
TENSOR_DTYPES = (
    'float32',
    'float16',
    'bfloat16',
    'int64',
    'int32',
    'int16',
    'int8',
    'int4',
    'int2',
    'uint8',
    'bool',
)

_DTYPE_BITS = {
    'float32': 32, 'float16': 16, 'bfloat16': 16, 'int64': 64, 'int32': 32,
    'int16': 16, 'int8': 8, 'int4': 4, 'int2': 2, 'uint8': 8, 'bool': 8,
}


def dtype_bits(dtype: str) -> int:
  return _DTYPE_BITS[dtype]


def dtype_for_bits(num_bits: int, signed: bool = True) -> str:
  """Storage dtype for an integer bit-width (sub-byte widths kept logical)."""
  if num_bits <= 2:
    return 'int2'
  if num_bits <= 4:
    return 'int4'
  if num_bits <= 8:
    return 'int8' if signed else 'uint8'
  if num_bits <= 16:
    return 'int16'
  if num_bits <= 32:
    return 'int32'
  return 'int64'


@dataclasses.dataclass
class Buffer:
  """Constant storage, shareable by several tensors.

  `data` is the logical numpy array for >=8-bit dtypes. For sub-byte tensor
  dtypes the array is stored UNPACKED here (int8 container) and packed only
  at serialization / kernel-launch time; this keeps pipeline passes simple
  while the on-disk and on-device formats stay dense.
  """

  data: Optional[np.ndarray] = None

  @property
  def nbytes(self) -> int:
    return 0 if self.data is None else self.data.nbytes


@dataclasses.dataclass
class QuantizationInfo:
  """Quantization parameters stamped on a tensor.

  x_float = (q - zero_point) * scale, broadcast along `quantized_dimension`
  (channelwise) or block-expanded with `block_size` along the last dimension
  (blockwise; scales have one entry per block and fp16 storage semantics).
  """

  scale: np.ndarray
  zero_point: np.ndarray
  quantized_dimension: Optional[int] = None
  num_bits: int = 8
  block_size: int = 0

  def clone(self) -> 'QuantizationInfo':
    return QuantizationInfo(
        scale=np.array(self.scale),
        zero_point=np.array(self.zero_point),
        quantized_dimension=self.quantized_dimension,
        num_bits=self.num_bits,
        block_size=self.block_size,
    )


@dataclasses.dataclass
class Tensor:
  """One value in a subgraph. Activation if buffer < 0, constant otherwise."""

  name: str
  shape: tuple
  dtype: str = 'float32'
  buffer: int = -1
  quantization: Optional[QuantizationInfo] = None

  def __post_init__(self):
    self.shape = tuple(int(s) for s in self.shape)
    if self.dtype not in TENSOR_DTYPES:
      raise ValueError(f'Unknown dtype {self.dtype!r} for tensor {self.name!r}')

  @property
  def is_constant(self) -> bool:
    return self.buffer >= 0

  @property
  def num_elements(self) -> int:
    n = 1
    for s in self.shape:
      n *= s
    return n

  def storage_bits(self) -> int:
    return dtype_bits(self.dtype) * self.num_elements


@dataclasses.dataclass
class Op:
  """One operation: `opcode` names an entry in ops.registry."""

  opcode: str
  inputs: list  # tensor ids into the owning subgraph; -1 marks absent input.
  outputs: list
  attrs: dict = dataclasses.field(default_factory=dict)
  # For STABLEHLO_COMPOSITE-style ops: indices of subgraphs this op executes.
  side_effect_subgraphs: list = dataclasses.field(default_factory=list)

  @property
  def name(self) -> str:
    return self.opcode


@dataclasses.dataclass
class Subgraph:
  name: str
  tensors: list = dataclasses.field(default_factory=list)
  ops: list = dataclasses.field(default_factory=list)
  inputs: list = dataclasses.field(default_factory=list)
  outputs: list = dataclasses.field(default_factory=list)

  def add_tensor(self, tensor: Tensor) -> int:
    self.tensors.append(tensor)
    return len(self.tensors) - 1

  def tensor_by_name(self, name: str) -> Optional[Tensor]:
    for t in self.tensors:
      if t.name == name:
        return t
    return None

  def tensor_id_by_name(self, name: str) -> int:
    for i, t in enumerate(self.tensors):
      if t.name == name:
        return i
    return -1


@dataclasses.dataclass
class SignatureDef:
  """A callable entry point: user-facing IO names -> tensor ids."""

  signature_key: str
  subgraph_index: int
  inputs: dict  # user input name -> tensor id
  outputs: dict  # user output name -> tensor id


@dataclasses.dataclass
class Graph:
  """A whole model: subgraphs + shared buffer table + signatures."""

  subgraphs: list = dataclasses.field(default_factory=list)
  buffers: list = dataclasses.field(default_factory=list)
  signatures: list = dataclasses.field(default_factory=list)
  metadata: dict = dataclasses.field(default_factory=dict)

  # -- construction helpers -------------------------------------------------

  def add_buffer(self, data: Optional[np.ndarray]) -> int:
    self.buffers.append(Buffer(data=data))
    return len(self.buffers) - 1

  def main_subgraph(self) -> Subgraph:
    return self.subgraphs[0]

  def signature_by_key(self, key: str) -> SignatureDef:
    for sig in self.signatures:
      if sig.signature_key == key:
        return sig
    raise KeyError(f'No signature {key!r}; have '
                   f'{[s.signature_key for s in self.signatures]}')

  def signature_keys(self) -> list:
    return [s.signature_key for s in self.signatures]

  def subgraph_for_signature(self, key: str) -> Subgraph:
    return self.subgraphs[self.signature_by_key(key).subgraph_index]

  # -- queries used by the quantization pipeline ----------------------------

  def tensor_data(self, tensor: Tensor) -> Optional[np.ndarray]:
    """Logical (unpacked) constant data for a tensor, or None."""
    if tensor.buffer < 0:
      return None
    data = self.buffers[tensor.buffer].data
    if data is None:
      return None
    return data.reshape(tensor.shape) if data.size == tensor.num_elements \
        else data

  def set_tensor_data(self, tensor: Tensor, data: np.ndarray) -> None:
    if tensor.buffer < 0:
      tensor.buffer = self.add_buffer(np.asarray(data))
    else:
      self.buffers[tensor.buffer].data = np.asarray(data)

  def clone(self) -> 'Graph':
    """Structural deep copy that shares (does not duplicate) buffer arrays."""
    new = Graph(
        subgraphs=copy.deepcopy(self.subgraphs),
        buffers=[Buffer(data=b.data) for b in self.buffers],
        signatures=copy.deepcopy(self.signatures),
        metadata=copy.deepcopy(self.metadata),
    )
    return new

  def total_constant_bits(self) -> int:
    """Model 'size' = sum of constant tensor storage bits (dedup by buffer)."""
    seen = set()
    bits = 0
    for sg in self.subgraphs:
      for t in sg.tensors:
        if t.buffer >= 0 and self.buffers[t.buffer].data is not None:
          key = (t.buffer,)
          if key in seen:
            continue
          seen.add(key)
          bits += t.storage_bits()
          q = t.quantization
          if q is not None:
            bits += np.asarray(q.scale).size * 16  # fp16 scales on disk
            if not np.all(np.asarray(q.zero_point) == 0):
              bits += np.asarray(q.zero_point).size * 32
    return bits


# ---------------------------------------------------------------------------
# Traversal utilities (parity: tfl_flatbuffer_utils accessors).
# ---------------------------------------------------------------------------


def get_op_scope(subgraph: Subgraph, op: Op, max_len: int = 10000) -> str:
  """Scope string for recipe regex matching.

  Same contract as the reference (tfl_flatbuffer_utils.py:371-417): the op's
  output tensor names joined with ';' plus a trailing ';', truncated at
  `max_len` characters. Tensor names should carry module paths
  (e.g. 'model/block_1/ffw/out') so scope regexes select model regions.
  """
  names = []
  for tid in op.outputs:
    if tid >= 0:
      names.append(subgraph.tensors[tid].name)
  scope = ';'.join(names) + ';' if names else ''
  return scope[:max_len]


def buffer_to_tensors(graph: Graph) -> dict:
  """buffer id -> list of (subgraph_index, tensor_id) aliasing that buffer."""
  out: dict = {}
  for sg_idx, sg in enumerate(graph.subgraphs):
    for t_idx, t in enumerate(sg.tensors):
      if t.buffer >= 0:
        out.setdefault(t.buffer, []).append((sg_idx, t_idx))
  return out


def tensor_consumers(subgraph: Subgraph, tensor_id: int) -> list:
  """Op ids (positions in subgraph.ops) that read `tensor_id`."""
  return [
      i for i, op in enumerate(subgraph.ops) if tensor_id in op.inputs
  ]


def tensor_producer(subgraph: Subgraph, tensor_id: int) -> int:
  """Op id producing `tensor_id`, or -1 if it is a graph input / constant."""
  for i, op in enumerate(subgraph.ops):
    if tensor_id in op.outputs:
      return i
  return -1


def iterate_ops(graph: Graph) -> Iterator:
  for sg_idx, sg in enumerate(graph.subgraphs):
    for op_idx, op in enumerate(sg.ops):
      yield sg_idx, op_idx, op


def is_float_model(graph: Graph) -> bool:
  """True if no tensor carries quantization info."""
  for sg in graph.subgraphs:
    for t in sg.tensors:
      if t.quantization is not None:
        return False
  return True


def graph_unique_tensor_names_check(graph: Graph) -> None:
  """The pipeline keys state by tensor name; enforce per-subgraph uniqueness."""
  for sg in graph.subgraphs:
    seen: dict = {}
    for t in sg.tensors:
      if t.name in seen:
        raise ValueError(
            f'Duplicate tensor name {t.name!r} in subgraph {sg.name!r}; '
            'tensor names must be unique for quantization.'
        )
      seen[t.name] = True
