"""Shared type system for the TPU-native quantizer.

This is the cross-cutting data model of the framework: op vocabulary, recipe
configuration dataclasses, quantization-parameter containers, and the
transformation-instruction types produced by the planning passes.

Capability parity target: reference `ai_edge_quantizer/qtyping.py` (op enum,
quant modes/granularities, QuantTransformation kinds, UniformQuantParams,
recipe config dataclasses, GraphInfo/OpInfo). The graph substrate here is our
own TPU-side IR (`ai_edge_quantizer_tpu_torch.graph.ir`) instead of TFLite
FlatBuffer object types.

A copy of `ai_edge_quantizer_tpu/qtyping.py`: the port keeps its own so that
it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Union

import numpy as np


class OpName(str, enum.Enum):
  """Operation vocabulary understood by the recipe/quantization layers.

  Names are shared vocabulary with the reference recipe JSON schema
  (reference qtyping.py:80-134) so recipes written for the reference resolve
  here unchanged.
  """

  ALL_SUPPORTED = '*'
  INPUT = 'INPUT'
  OUTPUT = 'OUTPUT'
  FULLY_CONNECTED = 'FULLY_CONNECTED'
  BATCH_MATMUL = 'BATCH_MATMUL'
  DEPTHWISE_CONV_2D = 'DEPTHWISE_CONV_2D'
  CONV_2D = 'CONV_2D'
  CONV_2D_TRANSPOSE = 'CONV_2D_TRANSPOSE'
  AVERAGE_POOL_2D = 'AVERAGE_POOL_2D'
  RESHAPE = 'RESHAPE'
  CUSTOM_OP = 'CUSTOM_OP'
  EMBEDDING_LOOKUP = 'EMBEDDING_LOOKUP'
  SOFTMAX = 'SOFTMAX'
  TANH = 'TANH'
  TRANSPOSE = 'TRANSPOSE'
  GELU = 'GELU'
  ADD = 'ADD'
  SUB = 'SUB'
  MUL = 'MUL'
  MEAN = 'MEAN'
  RSQRT = 'RSQRT'
  CONCATENATION = 'CONCATENATION'
  STRIDED_SLICE = 'STRIDED_SLICE'
  SPLIT = 'SPLIT'
  LOGISTIC = 'LOGISTIC'
  SLICE = 'SLICE'
  SUM = 'SUM'
  SELECT = 'SELECT'
  SELECT_V2 = 'SELECT_V2'
  DYNAMIC_UPDATE_SLICE = 'DYNAMIC_UPDATE_SLICE'
  STABLEHLO_COMPOSITE = 'STABLEHLO_COMPOSITE'
  PAD = 'PAD'
  SQUARED_DIFFERENCE = 'SQUARED_DIFFERENCE'
  MAX_POOL_2D = 'MAX_POOL_2D'
  RESIZE_BILINEAR = 'RESIZE_BILINEAR'
  RESIZE_NEAREST_NEIGHBOR = 'RESIZE_NEAREST_NEIGHBOR'
  GATHER_ND = 'GATHER_ND'
  PACK = 'PACK'
  UNPACK = 'UNPACK'
  DIV = 'DIV'
  BROADCAST_TO = 'BROADCAST_TO'
  SQRT = 'SQRT'
  GATHER = 'GATHER'
  HARD_SWISH = 'HARD_SWISH'
  MAXIMUM = 'MAXIMUM'
  PADV2 = 'PADV2'
  REDUCE_MIN = 'REDUCE_MIN'
  EQUAL = 'EQUAL'
  NOT_EQUAL = 'NOT_EQUAL'
  MIRROR_PAD = 'MIRROR_PAD'
  SPACE_TO_DEPTH = 'SPACE_TO_DEPTH'
  RELU = 'RELU'
  # TPU-side additions (not in the reference vocabulary): ops needed by the
  # JAX graph importer for transformer models.
  RMS_NORM = 'RMS_NORM'
  ROPE = 'ROPE'
  QUANTIZE = 'QUANTIZE'
  DEQUANTIZE = 'DEQUANTIZE'
  HADAMARD_ROTATION = 'HADAMARD_ROTATION'


# Alias used by code written against the reference naming.
TFLOperationName = OpName


class QuantizeMode(enum.Enum):
  """Which stage of the pipeline a registered algorithm function serves."""

  CALIBRATE = 2
  MATERIALIZE = 3


class OpExecutionMode(str, enum.Enum):
  """How a quantized op executes at runtime."""

  WEIGHT_ONLY = 'WEIGHT_ONLY'  # int weights, explicit dequantize, float math.
  DRQ = 'DRQ'  # int weights, activations quantized on the fly.
  SRQ = 'SRQ'  # full static range quantization (calibrated activations).


class ComputePrecision(str, enum.Enum):
  INTEGER = 'INTEGER'
  FLOAT = 'FLOAT'


class TensorDataType(str, enum.Enum):
  INT = 'INT'
  FLOAT = 'FLOAT'


class QuantGranularity(str, enum.Enum):
  TENSORWISE = 'TENSORWISE'
  CHANNELWISE = 'CHANNELWISE'
  BLOCKWISE_32 = 'BLOCKWISE_32'
  BLOCKWISE_64 = 'BLOCKWISE_64'
  BLOCKWISE_128 = 'BLOCKWISE_128'
  BLOCKWISE_256 = 'BLOCKWISE_256'


_BLOCK_SIZES = {
    QuantGranularity.BLOCKWISE_32: 32,
    QuantGranularity.BLOCKWISE_64: 64,
    QuantGranularity.BLOCKWISE_128: 128,
    QuantGranularity.BLOCKWISE_256: 256,
}


def granularity_block_size(granularity: QuantGranularity) -> int:
  """Block size implied by a granularity (0 for non-blockwise)."""
  return _BLOCK_SIZES.get(QuantGranularity(granularity), 0)


def granularity_from_block_size(block_size: int) -> QuantGranularity:
  for gran, size in _BLOCK_SIZES.items():
    if size == block_size:
      return gran
  raise ValueError(f'Unsupported block size: {block_size}')


def is_blockwise_granularity(granularity: QuantGranularity) -> bool:
  return QuantGranularity(granularity) in _BLOCK_SIZES


class QuantTransformation(enum.Enum):
  """Graph-rewrite primitives attachable to a tensor edge."""

  NO_QUANTIZE = 0
  ADD_QUANTIZE = 1       # float tensor -> Quantize op -> quantized tensor.
  ADD_DEQUANTIZE = 2     # quantized tensor -> Dequantize op -> float tensor.
  QUANTIZE_TENSOR = 3    # quantize the tensor in place (constants / edges).
  EMULATED_SUBCHANNEL = 4  # deprecated (ref transformation_utils.py:286-290).
  DUPLICATE_BUFFER = 5   # split a shared buffer before conflicting quant.
  DUPLICATE_TENSOR = 6   # split a shared tensor before conflicting quant.
  INSERT_HADAMARD_ROTATION = 7          # fused pallas rotation kernel op.
  INSERT_DECOMPOSED_HADAMARD_ROTATION = 8  # reshape/matmul/reshape expansion.


@dataclasses.dataclass(frozen=True)
class HadamardRotationParams:
  """Parameters of a block-diagonal Hadamard rotation applied to a weight."""

  random_binary_vector: np.ndarray
  hadamard_size: int

  def __eq__(self, other):
    if not isinstance(other, HadamardRotationParams):
      return False
    return self.hadamard_size == other.hadamard_size and np.array_equal(
        self.random_binary_vector, other.random_binary_vector
    )


@dataclasses.dataclass(frozen=True)
class UniformQuantParams:
  """Affine (uniform) quantization parameters for one tensor.

  q = clip(round(x / scale) + zero_point); x' = (q - zero_point) * scale.
  Scales/zero-points are broadcastable against the tensor along
  `quantized_dimension` (channelwise) or block-expanded (blockwise).
  """

  num_bits: int
  quantized_dimension: Optional[int]
  scale: np.ndarray
  zero_point: np.ndarray
  symmetric: bool = True
  quantized_data: Optional[np.ndarray] = None
  block_size: int = 0
  hadamard: Optional[HadamardRotationParams] = None

  @classmethod
  def from_quant_info(cls, q, data: Optional[np.ndarray] = None):
    """Build from an IR-level TensorQuantInfo (graph.ir.QuantizationInfo)."""
    return cls(
        num_bits=q.num_bits,
        quantized_dimension=q.quantized_dimension,
        scale=np.asarray(q.scale),
        zero_point=np.asarray(q.zero_point),
        symmetric=bool(np.all(np.asarray(q.zero_point) == 0)),
        quantized_data=data,
        block_size=q.block_size,
    )

  def __eq__(self, other):
    if not isinstance(other, UniformQuantParams):
      return False
    return (
        self.num_bits == other.num_bits
        and self.quantized_dimension == other.quantized_dimension
        and np.array_equal(self.scale, other.scale)
        and np.array_equal(self.zero_point, other.zero_point)
        and self.symmetric == other.symmetric
        and self.block_size == other.block_size
        and _array_like_equal(self.quantized_data, other.quantized_data)
        and self.hadamard == other.hadamard
    )


@dataclasses.dataclass(frozen=True)
class NonLinearQuantParams:
  """Parameters for non-linear quantization (currently fp16 casting)."""

  num_bits: int
  quantized_data: Optional[np.ndarray]
  data_type: TensorDataType = TensorDataType.FLOAT

  def __eq__(self, other):
    if not isinstance(other, NonLinearQuantParams):
      return False
    return (
        self.num_bits == other.num_bits
        and self.data_type == other.data_type
        and _array_like_equal(self.quantized_data, other.quantized_data)
    )


def _array_like_equal(a, b) -> bool:
  if a is None or b is None:
    return a is b
  return np.array_equal(a, b)


TensorQuantParams = Union[UniformQuantParams, NonLinearQuantParams]


@dataclasses.dataclass(frozen=True)
class OpToTensorParams:
  """How one op (by subgraph op id) touches a tensor.

  `transformations` is ordered: earlier entries apply closer to the tensor.
  """

  subgraph_op_id: int
  transformations: list[QuantTransformation]
  parameters: Optional[TensorQuantParams] = None


@dataclasses.dataclass
class TensorTransformationParams:
  """All requested transformations for one tensor (producer + consumers)."""

  tensor_name: str
  producer: Optional[OpToTensorParams] = None
  consumers: Optional[list[OpToTensorParams]] = None


@dataclasses.dataclass(frozen=True)
class TensorQuantizationConfig:
  """Recipe-level quantization spec for one tensor class (weight or act)."""

  num_bits: int
  symmetric: bool = True
  granularity: QuantGranularity = QuantGranularity.TENSORWISE
  dtype: TensorDataType = TensorDataType.INT

  @property
  def block_size(self) -> int:
    return granularity_block_size(self.granularity)

  def to_dict(self) -> dict[str, Any]:
    return {
        'num_bits': self.num_bits,
        'symmetric': self.symmetric,
        'granularity': self.granularity.value,
        'dtype': self.dtype.value,
    }

  @classmethod
  def from_dict(cls, d: dict[str, Any]) -> 'TensorQuantizationConfig':
    d = dict(d)
    # Legacy schema: {"channel_wise": bool} or {"block_size": N} instead of
    # granularity (reference qtyping.py:405-452 migration behavior).
    if 'granularity' not in d:
      block_size = d.pop('block_size', 0)
      if block_size:
        d['granularity'] = granularity_from_block_size(block_size)
      elif d.pop('channel_wise', False):
        d['granularity'] = QuantGranularity.CHANNELWISE
      else:
        d['granularity'] = QuantGranularity.TENSORWISE
    else:
      d.pop('block_size', None)
      d.pop('channel_wise', None)
    return cls(
        num_bits=int(d['num_bits']),
        symmetric=bool(d.get('symmetric', True)),
        granularity=QuantGranularity(d['granularity']),
        dtype=TensorDataType(d.get('dtype', 'INT')),
    )


@dataclasses.dataclass(frozen=True)
class OpQuantizationConfig:
  """Recipe-level spec for quantizing one op.

  Mirrors the reference recipe JSON schema (weight/activation tensor configs,
  compute precision, explicit dequantize, skip_checks, min_weight_elements,
  algorithm-specific free-form params).
  """

  activation_tensor_config: Optional[TensorQuantizationConfig] = None
  weight_tensor_config: Optional[TensorQuantizationConfig] = None
  compute_precision: ComputePrecision = ComputePrecision.FLOAT
  explicit_dequantize: bool = False
  skip_checks: bool = False
  min_weight_elements: int = 0
  # Free-form algorithm knobs, e.g. {"hadamard": {"max_size": 512}} or
  # GPTQ block size. Stored as a tuple-of-items so the dataclass stays
  # hashable; access through `algorithm_params`.
  _algorithm_params_items: Optional[tuple] = None

  def __post_init__(self):
    if self.min_weight_elements < 0:
      raise ValueError('min_weight_elements must be non-negative.')

  @property
  def algorithm_params(self) -> Optional[dict[str, Any]]:
    if self._algorithm_params_items is None:
      return None
    return _items_to_dict(self._algorithm_params_items)

  @classmethod
  def create(cls, *, algorithm_params: Optional[dict[str, Any]] = None, **kw):
    items = _dict_to_items(algorithm_params) if algorithm_params else None
    return cls(_algorithm_params_items=items, **kw)

  @property
  def execution_mode(self) -> OpExecutionMode:
    """Derived runtime execution mode (reference encodes this implicitly)."""
    if self.compute_precision == ComputePrecision.INTEGER:
      if self.activation_tensor_config is None:
        return OpExecutionMode.DRQ
      return OpExecutionMode.SRQ
    if self.explicit_dequantize:
      return OpExecutionMode.WEIGHT_ONLY
    return OpExecutionMode.WEIGHT_ONLY

  def to_dict(self) -> dict[str, Any]:
    out: dict[str, Any] = {}
    if self.activation_tensor_config is not None:
      out['activation_tensor_config'] = self.activation_tensor_config.to_dict()
    if self.weight_tensor_config is not None:
      out['weight_tensor_config'] = self.weight_tensor_config.to_dict()
    out['compute_precision'] = self.compute_precision.value
    out['explicit_dequantize'] = self.explicit_dequantize
    out['skip_checks'] = self.skip_checks
    out['min_weight_elements'] = self.min_weight_elements
    if self._algorithm_params_items is not None:
      out['algorithm_params'] = self.algorithm_params
    return out

  @classmethod
  def from_dict(cls, d: dict[str, Any]) -> 'OpQuantizationConfig':
    act = d.get('activation_tensor_config')
    w = d.get('weight_tensor_config')
    # Legacy key: execution_mode ('WEIGHT_ONLY'/'DRQ'/'SRQ') instead of
    # compute_precision + explicit_dequantize.
    if 'compute_precision' in d:
      precision = ComputePrecision(d['compute_precision'])
      explicit_dq = bool(d.get('explicit_dequantize', False))
    else:
      mode = OpExecutionMode(d.get('execution_mode', 'WEIGHT_ONLY'))
      precision = (
          ComputePrecision.FLOAT
          if mode == OpExecutionMode.WEIGHT_ONLY
          else ComputePrecision.INTEGER
      )
      explicit_dq = mode == OpExecutionMode.WEIGHT_ONLY
    return cls.create(
        activation_tensor_config=(
            TensorQuantizationConfig.from_dict(act) if act else None
        ),
        weight_tensor_config=(
            TensorQuantizationConfig.from_dict(w) if w else None
        ),
        compute_precision=precision,
        explicit_dequantize=explicit_dq,
        skip_checks=bool(d.get('skip_checks', False)),
        min_weight_elements=int(d.get('min_weight_elements', 0)),
        algorithm_params=d.get('algorithm_params'),
    )


def _dict_to_items(d):
  return tuple(
      (k, _dict_to_items(v) if isinstance(v, dict) else v)
      for k, v in sorted(d.items())
  )


def _items_to_dict(items):
  return {
      k: _items_to_dict(v) if isinstance(v, tuple) else v for k, v in items
  }


# ---------------------------------------------------------------------------
# Graph-facing info structs used by the pipeline passes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphInfo:
  """A view of one subgraph handed to the planning passes.

  `subgraph` is a graph.ir.Subgraph; `buffers` the owning graph's buffer
  table (buffer id -> graph.ir.Buffer).
  """

  subgraph: Any
  buffers: Any


@dataclasses.dataclass
class OpInfo:
  """One op instance under quantization."""

  op: Any  # graph.ir.Op
  op_name: OpName
  subgraph_op_index: int
  op_quant_config: OpQuantizationConfig


# Virtual op ids for graph inputs/outputs (they have no producing/consuming
# op inside the subgraph; the params generator models them as virtual ops).
VIRTUAL_INPUT_OP_ID = -1
VIRTUAL_OUTPUT_OP_ID = -2


# ---------------------------------------------------------------------------
# Instruction types produced by the instruction generator.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransformationInst:
  """One rewrite to perform on a tensor edge.

  Attributes:
    transformation: which rewrite primitive.
    tensor_id: tensor index in the subgraph.
    producer: producing op id (-1 for graph inputs).
    consumers: consuming op ids this instruction applies to.
    parameters: quant params to use.
  """

  transformation: QuantTransformation
  tensor_id: int
  producer: Optional[int]
  consumers: list[int]
  parameters: Optional[TensorQuantParams] = None

  def __eq__(self, other):
    if not isinstance(other, TransformationInst):
      return False
    return (
        self.transformation == other.transformation
        and self.tensor_id == other.tensor_id
        and self.producer == other.producer
        and self.consumers == other.consumers
        and self.parameters == other.parameters
    )


@dataclasses.dataclass
class TensorTransformationInsts:
  """All rewrites for one tensor, ordered for the performer."""

  tensor_name: str
  subgraph_id: int
  instructions: Optional[list[TransformationInst]]


# Quantization statistic values collected during calibration: tensor name ->
# {"min": arr, "max": arr} (or algorithm-specific content, e.g. GPTQ Hessian).
QSV = dict[str, Any]
ModelQSV = dict[str, QSV]

# Signature of `get_tensor_quant_params` implemented by every uniform
# algorithm: (op_info, tensor_quant_config, tensor_content?, tensor_qsv?)
# -> UniformQuantParams.
GetTensorQuantParamsFuncSignature = Callable[..., UniformQuantParams]
