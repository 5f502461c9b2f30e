"""Graph serialization: the `.aeqg` container.

Layout: magic + header-length + JSON header + 64-byte-aligned binary
payload. Constant buffers and quantization arrays (scales/zero-points) live
in the payload; sub-byte (int4/int2) tensors are bit-packed on disk and
unpacked to int8 containers at load. Buffer payloads are written via mmap
for large models and deduplicated by id (shared buffers serialize once).

Parity: reference model serialization (`model_modifier._serialize_model` +
flatbuffers + mmap_utils), re-designed: JSON-structural header instead of a
FlatBuffer schema, checkpoint-style aligned payload.

A copy of `ai_edge_quantizer_tpu/graph/serialize.py`: the files are the
same byte for byte. Sub-byte tensors pack with numpy (the JAX package's
optional C++ packer writes the same bytes), and `.tflite` input is not
ported (`load_model` raises NotImplementedError for it).
"""

from __future__ import annotations

import json
import mmap
from typing import Optional

import numpy as np

from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn
from ai_edge_quantizer_tpu_torch.graph import ir

_MAGIC = b'AEQG'
_VERSION = 1
_ALIGN = 64


def _json_safe_attrs(attrs: dict) -> dict:
  out = {}
  for k, v in attrs.items():
    if isinstance(v, np.ndarray):
      out[k] = {'__ndarray__': v.tolist(), 'dtype': str(v.dtype)}
    elif isinstance(v, (np.integer, np.floating)):
      out[k] = v.item()
    else:
      out[k] = v
  return out


def _attrs_from_json(attrs: dict) -> dict:
  out = {}
  for k, v in attrs.items():
    if isinstance(v, dict) and '__ndarray__' in v:
      out[k] = np.asarray(v['__ndarray__'], dtype=v.get('dtype', 'float32'))
    else:
      out[k] = v
  return out


class _PayloadWriter:
  """Accumulates aligned array blobs; returns per-array descriptors."""

  def __init__(self):
    self.entries: list = []
    self.chunks: list = []
    self.offset = 0

  def add(self, arr: Optional[np.ndarray],
          packed_bits: int = 0) -> Optional[dict]:
    if arr is None:
      return None
    arr = np.ascontiguousarray(arr)
    shape = list(arr.shape)
    if packed_bits in (2, 4):
      arr = qn.pack_subbyte(arr, packed_bits)
      dtype = 'uint8'
    else:
      dtype = str(arr.dtype)
      packed_bits = 0
    nbytes = arr.nbytes
    pad = (-self.offset) % _ALIGN
    if pad:
      self.chunks.append(b'\x00' * pad)
      self.offset += pad
    entry = {
        'offset': self.offset,
        'nbytes': nbytes,
        'dtype': dtype,
        'shape': shape,
        'packed_bits': packed_bits,
    }
    # Keep the ARRAY (no tobytes copy); written straight into the mmap.
    self.chunks.append(arr)
    self.offset += nbytes
    return entry


def save_graph(graph: ir.Graph, path: str) -> None:
  payload = _PayloadWriter()

  # Which logical dtype does each buffer store? (First aliasing tensor wins;
  # the params generator guarantees shared buffers agree.)
  buffer_bits: dict = {}
  for sg in graph.subgraphs:
    for t in sg.tensors:
      if t.buffer >= 0 and t.buffer not in buffer_bits:
        buffer_bits[t.buffer] = ir.dtype_bits(t.dtype) if t.dtype in (
            'int2', 'int4') else 0

  buffer_entries = []
  for i, buf in enumerate(graph.buffers):
    buffer_entries.append(
        payload.add(buf.data, packed_bits=buffer_bits.get(i, 0)))

  def quant_entry(q: Optional[ir.QuantizationInfo]) -> Optional[dict]:
    if q is None:
      return None
    return {
        'scale': payload.add(np.asarray(q.scale, np.float32)),
        'zero_point': payload.add(np.asarray(q.zero_point)),
        'quantized_dimension': q.quantized_dimension,
        'num_bits': q.num_bits,
        'block_size': q.block_size,
    }

  header = {
      'version': _VERSION,
      'metadata': graph.metadata,
      'buffers': buffer_entries,
      'subgraphs': [
          {
              'name': sg.name,
              'inputs': list(sg.inputs),
              'outputs': list(sg.outputs),
              'tensors': [
                  {
                      'name': t.name,
                      'shape': list(t.shape),
                      'dtype': t.dtype,
                      'buffer': t.buffer,
                      'quantization': quant_entry(t.quantization),
                  }
                  for t in sg.tensors
              ],
              'ops': [
                  {
                      'opcode': op.opcode,
                      'inputs': list(op.inputs),
                      'outputs': list(op.outputs),
                      'attrs': _json_safe_attrs(op.attrs),
                      'side_effect_subgraphs': list(op.side_effect_subgraphs),
                  }
                  for op in sg.ops
              ],
          }
          for sg in graph.subgraphs
      ],
      'signatures': [
          {
              'signature_key': s.signature_key,
              'subgraph_index': s.subgraph_index,
              'inputs': s.inputs,
              'outputs': s.outputs,
          }
          for s in graph.signatures
      ],
  }
  header_bytes = json.dumps(header).encode('utf-8')
  pre = _MAGIC + _VERSION.to_bytes(4, 'little') + len(header_bytes).to_bytes(
      8, 'little')
  payload_start = len(pre) + len(header_bytes)
  pad = (-payload_start) % _ALIGN
  total = payload_start + pad + payload.offset

  # Write to a temp file + atomic rename: overwriting the path in place
  # would truncate pages still referenced by zero-copy mmap loads of the
  # SAME file (e.g. quantize-and-save-back) -> SIGBUS. The rename keeps
  # the old inode alive for existing mappings and makes saves atomic.
  tmp_path = path + '.tmp'
  with open(tmp_path, 'w+b') as f:
    f.truncate(total)
    if total > 0:
      with mmap.mmap(f.fileno(), total) as mm:
        pos = 0
        for blob in (pre, header_bytes, b'\x00' * pad, *payload.chunks):
          if isinstance(blob, np.ndarray):
            n = blob.nbytes
            mm[pos:pos + n] = memoryview(blob).cast('B')
          else:
            n = len(blob)
            mm[pos:pos + n] = blob
          pos += n
  import os
  os.replace(tmp_path, path)


def _read_array(mm, payload_base: int, entry: Optional[dict],
                zero_copy: bool = False):
  if entry is None:
    return None
  start = payload_base + entry['offset']
  if entry['packed_bits'] in (2, 4):
    raw = mm[start:start + entry['nbytes']]
    packed = np.frombuffer(raw, dtype=np.uint8)
    n = int(np.prod(entry['shape'])) if entry['shape'] else 1
    arr = qn.unpack_subbyte(packed, entry['packed_bits'], n)
  elif zero_copy and isinstance(mm, mmap.mmap):
    # Read-only view straight into the mapping: pages fault in lazily.
    arr = np.frombuffer(mm, dtype=np.dtype(entry['dtype']),
                        count=entry['nbytes'] // np.dtype(
                            entry['dtype']).itemsize,
                        offset=start)
  else:
    raw = mm[start:start + entry['nbytes']]
    arr = np.frombuffer(raw, dtype=np.dtype(entry['dtype'])).copy()
  return arr.reshape(entry['shape'])


def load_graph(path: str, zero_copy: bool = True) -> ir.Graph:
  """Load an .aeqg model.

  zero_copy: buffers become read-only views into an mmap of the file (no
  page-in until touched, no copies — the multi-GB load path). The mapping
  is kept alive on the returned Graph. Pass False to materialize copies.
  """
  f = open(path, 'rb')
  if zero_copy:
    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
  else:
    mm = f.read()
    f.close()
  if mm[:4] != _MAGIC:
    raise ValueError(f'{path} is not an .aeqg model file.')
  header_len = int.from_bytes(mm[8:16], 'little')
  header = json.loads(mm[16:16 + header_len].decode('utf-8'))
  payload_base = 16 + header_len
  payload_base += (-payload_base) % _ALIGN

  graph = ir.Graph(metadata=header.get('metadata', {}))
  zc = zero_copy and isinstance(mm, mmap.mmap)
  if zc:
    graph._mmap = mm  # keep the mapping alive with the graph
  for entry in header['buffers']:
    graph.buffers.append(ir.Buffer(
        data=_read_array(mm, payload_base, entry, zero_copy=zc)))

  for sg_h in header['subgraphs']:
    sg = ir.Subgraph(name=sg_h['name'], inputs=list(sg_h['inputs']),
                     outputs=list(sg_h['outputs']))
    for t_h in sg_h['tensors']:
      q = None
      if t_h.get('quantization') is not None:
        q_h = t_h['quantization']
        q = ir.QuantizationInfo(
            scale=_read_array(mm, payload_base, q_h['scale']),
            zero_point=_read_array(mm, payload_base, q_h['zero_point']),
            quantized_dimension=q_h['quantized_dimension'],
            num_bits=q_h['num_bits'],
            block_size=q_h['block_size'],
        )
      sg.tensors.append(ir.Tensor(
          name=t_h['name'], shape=tuple(t_h['shape']), dtype=t_h['dtype'],
          buffer=t_h['buffer'], quantization=q))
    for op_h in sg_h['ops']:
      sg.ops.append(ir.Op(
          opcode=op_h['opcode'], inputs=list(op_h['inputs']),
          outputs=list(op_h['outputs']),
          attrs=_attrs_from_json(op_h.get('attrs', {})),
          side_effect_subgraphs=list(op_h.get('side_effect_subgraphs', []))))
    graph.subgraphs.append(sg)

  for s_h in header['signatures']:
    graph.signatures.append(ir.SignatureDef(
        signature_key=s_h['signature_key'],
        subgraph_index=s_h['subgraph_index'],
        inputs=dict(s_h['inputs']),
        outputs=dict(s_h['outputs'])))
  return graph


def load_model(model) -> ir.Graph:
  """Load a model: .aeqg / .tflite path, or raw bytes of either format.

  Bytes dispatch by magic: .aeqg starts with AEQG at offset 0; TFLite
  FlatBuffers carry 'TFL3' at offset 4 (ref quantizer.py bytearray-input
  support).
  """
  if isinstance(model, (bytes, bytearray)):
    data = bytes(model)
    if data[:4] == _MAGIC:
      import tempfile
      with tempfile.NamedTemporaryFile(suffix='.aeqg', delete=False) as f:
        f.write(data)
        tmp = f.name
      try:
        return load_graph(tmp, zero_copy=False)
      finally:
        import os
        os.unlink(tmp)
    if data[4:8] == b'TFL3':
      raise _tflite_unported()
    raise ValueError('Unrecognized model bytes (neither .aeqg nor .tflite).')
  if model.endswith('.tflite'):
    raise _tflite_unported()
  return load_graph(model)


def _tflite_unported() -> NotImplementedError:
  return NotImplementedError(
      'TFLite import (ai_edge_quantizer_tpu/graph/tflite_import.py) is not '
      'ported yet; convert the model to .aeqg first.')


def model_size_bytes(graph: ir.Graph) -> int:
  """On-disk size estimate = packed constant bits / 8."""
  return graph.total_constant_bits() // 8
