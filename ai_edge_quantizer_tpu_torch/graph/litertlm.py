"""LiteRT-LM (.litertlm) binary container reader/writer.

The on-ramp for reference users with multi-model GenAI bundles: parses the
real binary layout (header + flatbuffer metadata + block-aligned sections),
extracts TFLite-model sections (decoded via graph.tflite_import), and
re-serializes with section-data overrides — so a reference `.litertlm` file
round-trips through this framework.

Binary layout (parity: reference `utils/litertlm_utils.py:69-178` and the
public LiteRT-LM `litertlm_header.fbs` schema; layout verified against the
reference's own fixture bundles):

  [0:8)    magic b'LITERTLM'
  [8:12)   major version (u32 LE)
  [12:16)  minor version
  [16:20)  patch version
  [20:24)  zero padding
  [24:32)  u64 LE: absolute end offset of the metadata flatbuffer
  [32:...] metadata flatbuffer (LiteRTLMMetaData table)
  ...      section payloads, each beginning at a 16 KiB-aligned offset

Metadata schema (field ids):
  LiteRTLMMetaData: 0=systemMetadata, 1=sectionMetadata
  SystemMetadata:   0=entries [KeyValuePair]
  SectionMetadata:  0=objects [SectionObject]
  SectionObject:    0=items [KeyValuePair], 1=beginOffset u64,
                    2=endOffset u64, 3=dataType ubyte
  KeyValuePair:     0=key string, 1=value_type ubyte (union tag),
                    2=value wrapper table (field 0 = payload)

The implementation is self-contained (minimal vtable walker + builder); no
litert-lm-builder dependency.

A copy of `ai_edge_quantizer_tpu/graph/litertlm.py`: pure `struct` code,
so it writes the same bytes; a TFLite section decodes through the port's
`graph/tflite_import.py` (tensorflow for the schema).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Union

MAGIC = b'LITERTLM'
HEADER_END_LOCATION_OFFSET = 24
HEADER_BEGIN_OFFSET = 32
BLOCK_SIZE = 16384
MAJOR_VERSION = 1
MINOR_VERSION = 5
PATCH_VERSION = 0

# AnySectionDataType values (from the public litertlm_header.fbs).
SECTION_GENERIC_BINARY = 1
SECTION_TFLITE_MODEL = 3

# VData union tag for string values; other tags are preserved as raw
# scalars (width + bytes) so unknown metadata round-trips.
VDATA_STRING = 9


@dataclasses.dataclass
class MetaValue:
  """A KeyValuePair value: decoded string or raw scalar."""
  type_tag: int
  value: Union[str, bytes]  # str when type_tag == VDATA_STRING

  def as_python(self):
    if self.type_tag == VDATA_STRING:
      return self.value
    return int.from_bytes(self.value, 'little')


@dataclasses.dataclass
class Section:
  begin_offset: int
  end_offset: int
  data_type: int
  items: dict  # key -> MetaValue

  @property
  def size(self) -> int:
    return self.end_offset - self.begin_offset


# -- minimal flatbuffer reading ---------------------------------------------


def _u16(b, o): return struct.unpack_from('<H', b, o)[0]
def _i32(b, o): return struct.unpack_from('<i', b, o)[0]
def _u32(b, o): return struct.unpack_from('<I', b, o)[0]
def _u64(b, o): return struct.unpack_from('<Q', b, o)[0]


def _fields(buf: bytes, tpos: int) -> dict:
  """field id -> (absolute position, scalar width if inline)."""
  vt = tpos - _i32(buf, tpos)
  vtsize = _u16(buf, vt)
  out = {}
  for fid in range((vtsize - 4) // 2):
    off = _u16(buf, vt + 4 + 2 * fid)
    if off:
      out[fid] = tpos + off
  return out


def _indirect(buf: bytes, pos: int) -> int:
  return pos + _u32(buf, pos)


def _string(buf: bytes, pos: int) -> str:
  spos = _indirect(buf, pos)
  n = _u32(buf, spos)
  return buf[spos + 4:spos + 4 + n].decode('utf-8')


def _vector(buf: bytes, pos: int) -> list:
  vpos = _indirect(buf, pos)
  n = _u32(buf, vpos)
  return [_indirect(buf, vpos + 4 + 4 * i) for i in range(n)]


def _table_byte_size(buf: bytes, tpos: int) -> int:
  vt = tpos - _i32(buf, tpos)
  return _u16(buf, vt + 2)


def _parse_kvp(buf: bytes, tpos: int) -> tuple:
  f = _fields(buf, tpos)
  key = _string(buf, f[0]) if 0 in f else ''
  tag = buf[f[1]] if 1 in f else 0
  if 2 not in f:
    return key, MetaValue(tag, b'')
  wrapper = _indirect(buf, f[2])
  wf = _fields(buf, wrapper)
  if 0 not in wf:
    return key, MetaValue(tag, b'' if tag != VDATA_STRING else '')
  if tag == VDATA_STRING:
    return key, MetaValue(tag, _string(buf, wf[0]))
  # Scalar wrapper: width = wrapper table size minus the field offset.
  width = _table_byte_size(buf, wrapper) - (wf[0] - wrapper)
  width = max(1, min(8, width))
  return key, MetaValue(tag, bytes(buf[wf[0]:wf[0] + width]))


def _parse_metadata(buf: bytes) -> tuple:
  """Returns (system_metadata dict, [Section])."""
  root = _u32(buf, 0)
  rf = _fields(buf, root)
  system: dict = {}
  sections: list = []
  if 0 in rf:
    sm = _indirect(buf, rf[0])
    smf = _fields(buf, sm)
    if 0 in smf:
      for kvp_pos in _vector(buf, smf[0]):
        k, v = _parse_kvp(buf, kvp_pos)
        system[k] = v
  if 1 in rf:
    sec = _indirect(buf, rf[1])
    secf = _fields(buf, sec)
    if 0 in secf:
      for obj_pos in _vector(buf, secf[0]):
        of = _fields(buf, obj_pos)
        items: dict = {}
        if 0 in of:
          for kvp_pos in _vector(buf, of[0]):
            k, v = _parse_kvp(buf, kvp_pos)
            items[k] = v
        sections.append(Section(
            begin_offset=_u64(buf, of[1]) if 1 in of else 0,
            end_offset=_u64(buf, of[2]) if 2 in of else 0,
            data_type=buf[of[3]] if 3 in of else 0,
            items=items,
        ))
  return system, sections


# -- minimal flatbuffer writing ---------------------------------------------


class _FBBuilder:
  """Bottom-up flatbuffer builder (tables, vectors, strings, vtable dedupe).

  Buffer grows downward (flatbuffers are built back-to-front); `_buf` holds
  bytes in reverse order of the final file.
  """

  def __init__(self):
    self._buf = bytearray()
    self._vtables: dict = {}

  def _align(self, n: int) -> None:
    while len(self._buf) % n:
      self._buf.append(0)

  def offset(self) -> int:
    return len(self._buf)

  def string(self, s: str) -> int:
    raw = s.encode('utf-8')
    self._buf.append(0)  # null terminator
    self._align(4)
    self._buf.extend(reversed(raw))
    self._buf.extend(struct.pack('>I', len(raw)))  # reversed LE
    return len(self._buf)

  def vector_of_offsets(self, offsets: list) -> int:
    self._align(4)
    # File order is [length][e0][e1]... and the buffer is reversed, so
    # append the last element first.
    for off in reversed(offsets):
      rel = len(self._buf) + 4 - off  # field position-from-end minus target
      self._buf.extend(struct.pack('>I', rel))
    self._buf.extend(struct.pack('>I', len(offsets)))
    return len(self._buf)

  @staticmethod
  def _slot_size(kind, value) -> int:
    if kind == 'offset':
      return 4
    if kind == 'u64':
      return 8
    if kind == 'u8':
      return 1
    return len(value)

  def table(self, slots: list) -> int:
    """slots: list of (field_id, kind, value) with kind in
    {'offset', 'u64', 'u8', 'raw'}; raw = little-endian scalar bytes.
    'offset' values are offsets-from-end returned by earlier builds."""
    max_fid = max((fid for fid, *_ in slots), default=-1)
    # Table layout: [soffset i32][fields], larger fields first to
    # minimize padding.
    ordered = sorted(slots, key=lambda s: (-self._slot_size(s[1], s[2]),
                                           s[0]))
    pos = 4
    field_off: dict = {}
    for fid, kind, value in ordered:
      sz = self._slot_size(kind, value)
      if sz in (2, 4, 8):
        pos += (-pos) % sz
      field_off[fid] = pos
      pos += sz
    table_size = pos
    vt = bytearray()
    vt += struct.pack('<H', 4 + 2 * (max_fid + 1))
    vt += struct.pack('<H', table_size)
    for fid in range(max_fid + 1):
      vt += struct.pack('<H', field_off.get(fid, 0))
    vt_key = bytes(vt)
    self._align(4)
    T = len(self._buf) + table_size  # offset-from-end of the table start
    tb = bytearray(table_size)
    for fid, kind, value in slots:
      fo = field_off[fid]
      if kind == 'offset':
        tb[fo:fo + 4] = struct.pack('<I', (T - fo) - value)
      elif kind == 'u64':
        tb[fo:fo + 8] = struct.pack('<Q', value)
      elif kind == 'u8':
        tb[fo] = value & 0xFF
      else:
        tb[fo:fo + len(value)] = value
    if vt_key in self._vtables:
      V = self._vtables[vt_key]
      reuse = True
    else:
      V = T + len(vt_key)  # vtable appended right after (earlier in file)
      reuse = False
    tb[0:4] = struct.pack('<i', V - T)
    self._buf.extend(reversed(tb))
    if not reuse:
      self._buf.extend(reversed(vt_key))
      self._vtables[vt_key] = V
    return T

  def finish(self, root: int) -> bytes:
    self._align(4)
    self._buf.extend(struct.pack('>I', len(self._buf) + 4 - root))
    return bytes(reversed(self._buf))


def _build_kvp(b: _FBBuilder, key: str, val: MetaValue) -> int:
  if val.type_tag == VDATA_STRING:
    s_off = b.string(str(val.value))
    wrapper = b.table([(0, 'offset', s_off)])
  elif val.value:
    wrapper = b.table([(0, 'raw', bytes(val.value))])
  else:
    wrapper = b.table([])
  k_off = b.string(key)
  return b.table([
      (0, 'offset', k_off),
      (1, 'u8', val.type_tag),
      (2, 'offset', wrapper),
  ])


def _build_metadata(system: dict, sections: list) -> bytes:
  b = _FBBuilder()
  sys_entries = [_build_kvp(b, k, v) for k, v in system.items()]
  sys_vec = b.vector_of_offsets(sys_entries)
  sys_table = b.table([(0, 'offset', sys_vec)])
  section_offs = []
  for s in sections:
    item_offs = [_build_kvp(b, k, v) for k, v in s.items.items()]
    items_vec = b.vector_of_offsets(item_offs)
    section_offs.append(b.table([
        (0, 'offset', items_vec),
        (1, 'u64', s.begin_offset),
        (2, 'u64', s.end_offset),
        (3, 'u8', s.data_type),
    ]))
  obj_vec = b.vector_of_offsets(section_offs)
  sec_table = b.table([(0, 'offset', obj_vec)])
  root = b.table([(0, 'offset', sys_table), (1, 'offset', sec_table)])
  return b.finish(root)


# -- public API --------------------------------------------------------------


class LiteRTLMFile:
  """Parses a `.litertlm` bundle: header, metadata, section table.

  API parity: reference `utils/litertlm_utils.LiteRTLMFile`
  (litertlm_utils.py:69-178).
  """

  def __init__(self, path: str):
    self._path = path
    with open(path, 'rb') as f:
      header = f.read(HEADER_BEGIN_OFFSET)
      if header[:8] != MAGIC:
        raise ValueError(f'{path!r} is not a LiteRT-LM file '
                         f'(bad magic {header[:8]!r}).')
      self.version = struct.unpack_from('<III', header, 8)
      meta_end = _u64(header, HEADER_END_LOCATION_OFFSET)
      meta_buf = f.read(meta_end - HEADER_BEGIN_OFFSET)
    self.system_metadata_raw, self._sections = _parse_metadata(meta_buf)

  @property
  def sections(self) -> list:
    return self._sections

  def get_system_metadata(self) -> dict:
    return {k: v.as_python() for k, v in self.system_metadata_raw.items()}

  def get_section_metadata(self, section_id: int) -> dict:
    return {k: v.as_python()
            for k, v in self._sections[section_id].items.items()}

  def get_model_type(self, section_id: int) -> Optional[str]:
    val = self._sections[section_id].items.get('model_type')
    return str(val.value) if val is not None else None

  def get_section_buffer(self, section_id: int) -> bytes:
    s = self._sections[section_id]
    with open(self._path, 'rb') as f:
      f.seek(s.begin_offset)
      return f.read(s.size)

  def read_model(self, section_id: int):
    """Decode a TFLiteModel section into a Graph (or None)."""
    if self._sections[section_id].data_type != SECTION_TFLITE_MODEL:
      return None
    from ai_edge_quantizer_tpu_torch.graph import tflite_import
    return tflite_import.load_tflite(self.get_section_buffer(section_id))

  def serialize(self, path: str, section_data_overrides: dict) -> int:
    """Write the bundle to `path`, replacing overridden section payloads.

    section_data_overrides: {section_id: bytes}. Offsets are recomputed
    with 16 KiB block alignment; all metadata round-trips.
    """
    sections = [dataclasses.replace(s, items=dict(s.items))
                for s in self._sections]
    payloads = []
    for sid, s in enumerate(sections):
      data = section_data_overrides.get(sid)
      if data is None:
        data = self.get_section_buffer(sid)
      payloads.append(bytes(data))
    return write_litertlm(
        path,
        [(payloads[i], sections[i].data_type, sections[i].items)
         for i in range(len(sections))],
        system_metadata=self.system_metadata_raw,
    )


def _as_meta_items(items: dict) -> dict:
  out = {}
  for k, v in items.items():
    if isinstance(v, MetaValue):
      out[k] = v
    elif isinstance(v, str):
      out[k] = MetaValue(VDATA_STRING, v)
    elif isinstance(v, int):
      out[k] = MetaValue(4, struct.pack('<i', v))  # Int32 wrapper
    else:
      raise TypeError(f'Unsupported metadata value for {k!r}: {type(v)}')
  return out


def write_litertlm(path: str, sections: list,
                   system_metadata: Optional[dict] = None) -> int:
  """Create a `.litertlm` file.

  sections: [(payload bytes, data_type int, items dict)]; items values may
  be str/int/MetaValue. Returns bytes written.
  """
  system = _as_meta_items(system_metadata or {})
  first_begin = BLOCK_SIZE
  offsets = [first_begin]
  section_objs = []
  for payload, data_type, items in sections:
    begin = offsets[-1]
    end = begin + len(payload)
    section_objs.append(Section(begin, end, data_type,
                                _as_meta_items(items)))
    offsets.append((end + BLOCK_SIZE - 1) & ~(BLOCK_SIZE - 1))
  meta = _build_metadata(system, section_objs)
  if HEADER_BEGIN_OFFSET + len(meta) > first_begin:
    raise ValueError(
        f'metadata ({len(meta)} bytes) exceeds the first section block; '
        'increase BLOCK_SIZE or trim metadata.')
  written = 0
  with open(path, 'wb') as f:
    written += f.write(MAGIC)
    written += f.write(struct.pack('<III', MAJOR_VERSION, MINOR_VERSION,
                                   PATCH_VERSION))
    written += f.write(b'\x00' * 4)
    written += f.write(struct.pack('<Q', HEADER_BEGIN_OFFSET + len(meta)))
    written += f.write(meta)
    for (payload, _, _), obj in zip(sections, section_objs):
      written += f.write(b'\x00' * (obj.begin_offset - written))
      written += f.write(payload)
  return written
