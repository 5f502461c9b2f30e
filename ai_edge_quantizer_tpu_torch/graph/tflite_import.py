"""TFLite (.tflite) FlatBuffer importer -> Graph IR.

The migration path for reference (AEQ) users: their float .tflite models
load directly into this framework's IR and quantize with the same recipes.
Uses the TFLite schema bundled with TensorFlow (no LiteRT dependency);
gated so environments without TF still import the package.

Covers the reference's op vocabulary (SURVEY.md §2, ~50 builtins); unknown
ops import as CUSTOM_OP and stay unquantized (same behavior as the
reference's unknown-op handling, params_generator.py).

A copy of `ai_edge_quantizer_tpu/graph/tflite_import.py` behind the same
gate: tensorflow supplies the schema and is imported inside `_schema()`
only, at a call, so importing this module loads neither tensorflow nor
ml_dtypes. Where tensorflow is absent (the H100 host has none) a call
raises the reference's ImportError.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn
from ai_edge_quantizer_tpu_torch.graph import ir


def _schema():
  try:
    from tensorflow.lite.python import schema_py_generated as s
  except Exception as e:  # pragma: no cover
    raise ImportError(
        'TFLite import requires tensorflow (for the schema).') from e
  return s


# TFLite BuiltinOperator code -> OpName value. Codes are stable schema
# constants.
def _builtin_table(s) -> dict:
  B = s.BuiltinOperator
  pairs = {
      B.FULLY_CONNECTED: 'FULLY_CONNECTED',
      B.BATCH_MATMUL: 'BATCH_MATMUL',
      B.CONV_2D: 'CONV_2D',
      B.DEPTHWISE_CONV_2D: 'DEPTHWISE_CONV_2D',
      B.TRANSPOSE_CONV: 'CONV_2D_TRANSPOSE',
      B.AVERAGE_POOL_2D: 'AVERAGE_POOL_2D',
      B.MAX_POOL_2D: 'MAX_POOL_2D',
      B.RESHAPE: 'RESHAPE',
      B.EMBEDDING_LOOKUP: 'EMBEDDING_LOOKUP',
      B.SOFTMAX: 'SOFTMAX',
      B.TANH: 'TANH',
      B.TRANSPOSE: 'TRANSPOSE',
      B.GELU: 'GELU',
      B.ADD: 'ADD',
      B.SUB: 'SUB',
      B.MUL: 'MUL',
      B.DIV: 'DIV',
      B.MEAN: 'MEAN',
      B.RSQRT: 'RSQRT',
      B.SQRT: 'SQRT',
      B.CONCATENATION: 'CONCATENATION',
      B.STRIDED_SLICE: 'STRIDED_SLICE',
      B.SLICE: 'SLICE',
      B.SPLIT: 'SPLIT',
      B.LOGISTIC: 'LOGISTIC',
      B.SUM: 'SUM',
      B.SELECT: 'SELECT',
      B.SELECT_V2: 'SELECT_V2',
      B.DYNAMIC_UPDATE_SLICE: 'DYNAMIC_UPDATE_SLICE',
      B.PAD: 'PAD',
      B.PADV2: 'PADV2',
      B.MIRROR_PAD: 'MIRROR_PAD',
      B.SQUARED_DIFFERENCE: 'SQUARED_DIFFERENCE',
      B.RESIZE_BILINEAR: 'RESIZE_BILINEAR',
      B.RESIZE_NEAREST_NEIGHBOR: 'RESIZE_NEAREST_NEIGHBOR',
      B.GATHER: 'GATHER',
      B.GATHER_ND: 'GATHER_ND',
      B.PACK: 'PACK',
      B.UNPACK: 'UNPACK',
      B.BROADCAST_TO: 'BROADCAST_TO',
      B.HARD_SWISH: 'HARD_SWISH',
      B.MAXIMUM: 'MAXIMUM',
      B.REDUCE_MIN: 'REDUCE_MIN',
      B.EQUAL: 'EQUAL',
      B.NOT_EQUAL: 'NOT_EQUAL',
      B.SPACE_TO_DEPTH: 'SPACE_TO_DEPTH',
      B.RELU: 'RELU',
      B.QUANTIZE: 'QUANTIZE',
      B.DEQUANTIZE: 'DEQUANTIZE',
      B.STABLEHLO_COMPOSITE: 'STABLEHLO_COMPOSITE',
  }
  # Every other builtin falls back to its schema enum name (TRANSPOSE_CONV
  # above is the only rename) — keeps WHILE/IF/LESS/CAST etc. identified
  # even when the executor has no kernel for them yet.
  for attr in dir(B):
    if attr.startswith('_'):
      continue
    code = getattr(B, attr)
    if isinstance(code, int) and code not in pairs:
      pairs[code] = attr
  return pairs


_TENSORTYPE_TO_DTYPE = {
    0: 'float32', 1: 'float16', 2: 'int32', 3: 'uint8', 4: 'int64',
    6: 'bool', 7: 'int16', 9: 'int8', 16: 'bfloat16', 17: 'int4',
}

_ACTIVATIONS = {0: 'NONE', 1: 'RELU', 2: 'RELU_N1_TO_1', 3: 'RELU6',
                4: 'TANH'}
_PADDINGS = {0: 'SAME', 1: 'VALID'}


def _np_dtype(dtype: str):
  return {
      'float32': np.float32, 'float16': np.float16, 'int32': np.int32,
      'uint8': np.uint8, 'int64': np.int64, 'bool': np.bool_,
      'int16': np.int16, 'int8': np.int8,
      'bfloat16': np.uint16,  # raw container
  }[dtype]


def _decode_buffer(raw: Optional[np.ndarray], dtype: str,
                   num_elements: int) -> Optional[np.ndarray]:
  if raw is None or len(raw) == 0:
    return None
  raw = np.frombuffer(bytes(raw), dtype=np.uint8)
  if dtype == 'int4':
    return qn.unpack_subbyte(raw, 4, num_elements)
  return np.frombuffer(raw.tobytes(), dtype=_np_dtype(dtype))[:num_elements]


def _op_attrs(s, op, opcode_name: str) -> dict:
  """Extract the option fields the executor understands."""
  attrs: dict = {}
  opts = op.builtinOptions
  if opts is None:
    return attrs
  def act(o):
    return _ACTIVATIONS.get(getattr(o, 'fusedActivationFunction', 0), 'NONE')
  name = type(opts).__name__
  if name == 'FullyConnectedOptionsT':
    attrs['fused_activation'] = act(opts)
  elif name in ('Conv2DOptionsT', 'DepthwiseConv2DOptionsT'):
    attrs['fused_activation'] = act(opts)
    attrs['stride'] = int(getattr(opts, 'strideW', 1))
    attrs['padding'] = _PADDINGS.get(getattr(opts, 'padding', 0), 'SAME')
  elif name == 'TransposeConvOptionsT':
    attrs['stride'] = int(getattr(opts, 'strideW', 1))
    attrs['padding'] = _PADDINGS.get(getattr(opts, 'padding', 0), 'SAME')
  elif name == 'Pool2DOptionsT':
    attrs['filter_size'] = int(getattr(opts, 'filterWidth', 2))
    attrs['stride'] = int(getattr(opts, 'strideW', 2))
    attrs['padding'] = _PADDINGS.get(getattr(opts, 'padding', 0), 'VALID')
  elif name == 'ConcatenationOptionsT':
    attrs['axis'] = int(getattr(opts, 'axis', -1))
  elif name == 'PackOptionsT':
    attrs['axis'] = int(getattr(opts, 'axis', 0))
  elif name == 'UnpackOptionsT':
    attrs['axis'] = int(getattr(opts, 'axis', 0))
  elif name == 'SplitOptionsT':
    attrs['num_splits'] = int(getattr(opts, 'numSplits', 1))
  elif name == 'BatchMatMulOptionsT':
    attrs['adj_x'] = bool(getattr(opts, 'adjX', False))
    attrs['adj_y'] = bool(getattr(opts, 'adjY', False))
  elif name in ('ReducerOptionsT', 'SumOptionsT', 'MeanOptionsT'):
    attrs['keep_dims'] = bool(getattr(opts, 'keepDims', False))
  elif name == 'SoftmaxOptionsT':
    attrs['beta'] = float(getattr(opts, 'beta', 1.0))
  elif name == 'SpaceToDepthOptionsT':
    attrs['block_size'] = int(getattr(opts, 'blockSize', 2))
  elif name == 'StableHLOCompositeOptionsT':
    cname = getattr(opts, 'name', b'')
    attrs['composite_name'] = (
        cname.decode() if isinstance(cname, bytes) else str(cname))
    attrs['_side_effect_subgraphs'] = [
        int(getattr(opts, 'decompositionSubgraphIndex', 0))]
  elif name == 'WhileOptionsT':
    attrs['_side_effect_subgraphs'] = [
        int(getattr(opts, 'condSubgraphIndex', 0)),
        int(getattr(opts, 'bodySubgraphIndex', 0))]
  elif name == 'IfOptionsT':
    attrs['_side_effect_subgraphs'] = [
        int(getattr(opts, 'thenSubgraphIndex', 0)),
        int(getattr(opts, 'elseSubgraphIndex', 0))]
  return attrs


def load_tflite(model: Union[str, bytes]) -> ir.Graph:
  """Parse a .tflite file (path or bytes) into Graph IR."""
  s = _schema()
  if isinstance(model, str):
    with open(model, 'rb') as f:
      data = f.read()
  else:
    data = bytes(model)
  fb = s.ModelT.InitFromPackedBuf(bytearray(data), 0)
  table = _builtin_table(s)

  graph = ir.Graph(metadata={'source': 'tflite'})

  # Buffers decode lazily per tensor (dtype lives on the tensor).
  raw_buffers = [b.data for b in (fb.buffers or [])]
  decoded: dict = {}

  opcode_names = []
  for oc in fb.operatorCodes or []:
    code = max(int(oc.builtinCode), int(getattr(oc, 'deprecatedBuiltinCode',
                                                0)))
    if code == s.BuiltinOperator.CUSTOM:
      cname = oc.customCode
      opcode_names.append(
          cname.decode() if isinstance(cname, bytes) else str(cname))
    else:
      opcode_names.append(table.get(code, f'UNKNOWN_{code}'))

  for sg_idx, sg_fb in enumerate(fb.subgraphs or []):
    name = sg_fb.name
    sg = ir.Subgraph(
        name=(name.decode() if isinstance(name, bytes) else name)
        or f'subgraph_{sg_idx}')
    for t_fb in sg_fb.tensors or []:
      dtype = _TENSORTYPE_TO_DTYPE.get(int(t_fb.type))
      if dtype is None:
        raise ValueError(f'Unsupported tflite tensor type {t_fb.type}.')
      shape = tuple(int(d) for d in (t_fb.shape
                                     if t_fb.shape is not None else []))
      n_elem = int(np.prod(shape)) if shape else 1
      buf_idx = int(t_fb.buffer)
      buffer_id = -1
      if buf_idx > 0 and buf_idx < len(raw_buffers) and \
          raw_buffers[buf_idx] is not None and len(raw_buffers[buf_idx]):
        if buf_idx not in decoded:
          arr = _decode_buffer(raw_buffers[buf_idx], dtype, n_elem)
          decoded[buf_idx] = graph.add_buffer(arr)
        buffer_id = decoded[buf_idx]
      q = None
      q_fb = t_fb.quantization
      if q_fb is not None and q_fb.scale is not None and len(q_fb.scale):
        q = ir.QuantizationInfo(
            scale=np.asarray(q_fb.scale, np.float32),
            zero_point=np.asarray(q_fb.zeroPoint
                                  if q_fb.zeroPoint is not None else [0]),
            quantized_dimension=int(q_fb.quantizedDimension or 0),
            num_bits=ir.dtype_bits(dtype) if dtype.startswith('int') else 8,
        )
      tname = t_fb.name
      sg.tensors.append(ir.Tensor(
          name=(tname.decode() if isinstance(tname, bytes) else str(tname)),
          shape=shape, dtype=dtype, buffer=buffer_id, quantization=q))
    sg.inputs = [int(i) for i in (sg_fb.inputs
                                  if sg_fb.inputs is not None else [])]
    sg.outputs = [int(i) for i in (sg_fb.outputs
                                   if sg_fb.outputs is not None else [])]
    for op_fb in sg_fb.operators or []:
      opcode = opcode_names[int(op_fb.opcodeIndex)]
      attrs = _op_attrs(s, op_fb, opcode)
      side_effects = attrs.pop('_side_effect_subgraphs', [])
      sg.ops.append(ir.Op(
          opcode=opcode,
          inputs=[int(i) for i in (op_fb.inputs
                                   if op_fb.inputs is not None else [])],
          outputs=[int(i) for i in (op_fb.outputs
                                    if op_fb.outputs is not None else [])],
          attrs=attrs,
          side_effect_subgraphs=side_effects))
    graph.subgraphs.append(sg)

  for sig_fb in fb.signatureDefs or []:
    key = sig_fb.signatureKey
    graph.signatures.append(ir.SignatureDef(
        signature_key=(key.decode() if isinstance(key, bytes) else str(key)),
        subgraph_index=int(sig_fb.subgraphIndex),
        inputs={
            (io.name.decode() if isinstance(io.name, bytes)
             else str(io.name)): int(io.tensorIndex)
            for io in (sig_fb.inputs or [])},
        outputs={
            (io.name.decode() if isinstance(io.name, bytes)
             else str(io.name)): int(io.tensorIndex)
            for io in (sig_fb.outputs or [])},
    ))
  if not graph.signatures and graph.subgraphs:
    # Models without signature defs: synthesize one over subgraph 0.
    sg = graph.subgraphs[0]
    graph.signatures.append(ir.SignatureDef(
        signature_key='serving_default', subgraph_index=0,
        inputs={sg.tensors[t].name.split('/')[-1] or f'in{j}': t
                for j, t in enumerate(sg.inputs)},
        outputs={sg.tensors[t].name.split('/')[-1] or f'out{j}': t
                 for j, t in enumerate(sg.outputs)},
    ))
  return graph
