"""Multi-program GenAI bundles (.aeqb): the .litertlm analog.

A bundle packs several models (embedder / prefill / decode / ...) as named
sections, each tagged with a `model_type` so per-model-type recipe mappings
select the right quantization per program.

Format: magic + JSON section table + 64-byte-aligned concatenated .aeqg
payloads.

Parity: reference `utils/litertlm_utils.py` + the aeq.py .litertlm flow.

A copy of `ai_edge_quantizer_tpu/models/bundles.py` over the port's
`Quantizer` and `serialize` (the same `.aeqb` bytes). Quantizing is host
numpy; a recipe that needs calibration runs the float section on
`device` (the card unless the caller passes 'cpu').
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.graph import serialize

_MAGIC = b'AEQB'
_ALIGN = 64


@dataclasses.dataclass
class BundleSection:
  name: str
  model_type: str  # e.g. 'embedder', 'prefill', 'decode'
  graph: ir.Graph


@dataclasses.dataclass
class Bundle:
  sections: list
  metadata: dict = dataclasses.field(default_factory=dict)

  def section_by_name(self, name: str) -> BundleSection:
    for s in self.sections:
      if s.name == name:
        return s
    raise KeyError(f'No bundle section {name!r}.')

  def save(self, path: str) -> None:
    blobs = []
    table = []
    offset = 0
    tmpdir = tempfile.mkdtemp()
    try:
      for i, sec in enumerate(self.sections):
        tmp = os.path.join(tmpdir, f'sec{i}.aeqg')
        serialize.save_graph(sec.graph, tmp)
        with open(tmp, 'rb') as f:
          blob = f.read()
        pad = (-offset) % _ALIGN
        offset += pad
        table.append({
            'name': sec.name,
            'model_type': sec.model_type,
            'offset': offset,
            'length': len(blob),
        })
        blobs.append(b'\x00' * pad + blob)
        offset += len(blob)
    finally:
      for f in os.listdir(tmpdir):
        os.unlink(os.path.join(tmpdir, f))
      os.rmdir(tmpdir)
    header = json.dumps(
        {'sections': table, 'metadata': self.metadata}).encode('utf-8')
    with open(path, 'wb') as f:
      f.write(_MAGIC)
      f.write(len(header).to_bytes(8, 'little'))
      f.write(header)
      base = f.tell()
      pad = (-base) % _ALIGN
      f.write(b'\x00' * pad)
      for blob in blobs:
        f.write(blob)

  @classmethod
  def load(cls, path: str) -> 'Bundle':
    with open(path, 'rb') as f:
      data = f.read()
    if data[:4] != _MAGIC:
      raise ValueError(f'{path} is not an .aeqb bundle.')
    hlen = int.from_bytes(data[4:12], 'little')
    header = json.loads(data[12:12 + hlen].decode('utf-8'))
    base = 12 + hlen
    base += (-base) % _ALIGN
    sections = []
    tmpdir = tempfile.mkdtemp()
    try:
      for i, entry in enumerate(header['sections']):
        blob = data[base + entry['offset']:
                    base + entry['offset'] + entry['length']]
        tmp = os.path.join(tmpdir, f'sec{i}.aeqg')
        with open(tmp, 'wb') as f:
          f.write(blob)
        sections.append(BundleSection(
            name=entry['name'], model_type=entry['model_type'],
            graph=serialize.load_graph(tmp)))
    finally:
      for fn in os.listdir(tmpdir):
        os.unlink(os.path.join(tmpdir, fn))
      os.rmdir(tmpdir)
    return cls(sections=sections, metadata=header.get('metadata', {}))


def _graph_from_bytes(blob: bytes, fname: str) -> ir.Graph:
  tmpdir = tempfile.mkdtemp()
  try:
    tmp = os.path.join(tmpdir, fname)
    with open(tmp, 'wb') as f:
      f.write(blob)
    if blob[:4] == b'AEQG':
      return serialize.load_graph(tmp, zero_copy=False)
    from ai_edge_quantizer_tpu_torch.graph import tflite_import
    return tflite_import.load_tflite(tmp)
  finally:
    for fn in os.listdir(tmpdir):
      os.unlink(os.path.join(tmpdir, fn))
    os.rmdir(tmpdir)


def _graph_to_aeqg_bytes(graph: ir.Graph) -> bytes:
  tmpdir = tempfile.mkdtemp()
  try:
    tmp = os.path.join(tmpdir, 'g.aeqg')
    serialize.save_graph(graph, tmp)
    with open(tmp, 'rb') as f:
      return f.read()
  finally:
    for fn in os.listdir(tmpdir):
      os.unlink(os.path.join(tmpdir, fn))
    os.rmdir(tmpdir)


def _lookup_recipe(recipe_mapping: dict, model_type):
  """Exact model_type, then without the litertlm 'tf_lite_' prefix, then
  'default' (reference recipe_utils.py:179-248 mapping semantics)."""
  if model_type in recipe_mapping:
    return recipe_mapping[model_type]
  if model_type and model_type.startswith('tf_lite_'):
    stripped = model_type[len('tf_lite_'):]
    if stripped in recipe_mapping:
      return recipe_mapping[stripped]
  return recipe_mapping.get('default')


def bundle_from_litertlm(path: str) -> Bundle:
  """Import a `.litertlm` bundle: model sections (TFLite or aeqt-quantized
  `.aeqg` payloads) become bundle sections; other sections (tokenizers
  etc.) are recorded in metadata as opaque passthrough.

  The migration on-ramp for reference users (ref aeq.py:61-181 flow).
  """
  from ai_edge_quantizer_tpu_torch.graph import litertlm

  lm = litertlm.LiteRTLMFile(path)
  sections = []
  passthrough = []
  for sid in range(len(lm.sections)):
    buf = lm.get_section_buffer(sid)
    model_type = lm.get_model_type(sid) or f'section_{sid}'
    is_model = (lm.sections[sid].data_type == litertlm.SECTION_TFLITE_MODEL
                or buf[:4] == b'AEQG')
    if not is_model:
      passthrough.append({'section_id': sid, 'model_type': model_type,
                          'data_type': lm.sections[sid].data_type,
                          'length': len(buf)})
      continue
    sections.append(BundleSection(
        name=f'section_{sid}', model_type=model_type,
        graph=_graph_from_bytes(buf, f'sec{sid}.bin')))
  return Bundle(sections=sections,
                metadata={'source': 'litertlm',
                          'system_metadata': lm.get_system_metadata(),
                          'passthrough_sections': passthrough})


def quantize_litertlm(
    in_path: str,
    out_path: str,
    recipe_mapping: dict,
    calibration_data_per_section: Optional[dict] = None,
    device='cuda',
) -> list:
  """Quantize every TFLite-model section of a `.litertlm` per model_type
  and write a `.litertlm` back with quantized payloads (as `.aeqg` bytes,
  data_type GENERIC_BINARY + 'aeqt_format' marker); all other sections
  and metadata pass through byte-identically.

  Returns [(section_id, model_type, recipe_applied: bool)]. device: where
  a section that needs calibration runs.
  """
  from ai_edge_quantizer_tpu_torch import quantizer as quantizer_lib
  from ai_edge_quantizer_tpu_torch.graph import litertlm

  lm = litertlm.LiteRTLMFile(in_path)
  out_sections = []
  report = []
  for sid in range(len(lm.sections)):
    sec = lm.sections[sid]
    buf = lm.get_section_buffer(sid)
    model_type = lm.get_model_type(sid)
    if sec.data_type != litertlm.SECTION_TFLITE_MODEL:
      out_sections.append((buf, sec.data_type, sec.items))
      continue
    recipe = _lookup_recipe(recipe_mapping, model_type)
    if recipe is None:
      out_sections.append((buf, sec.data_type, sec.items))
      report.append((sid, model_type, False))
      continue
    graph = _graph_from_bytes(buf, f'sec{sid}.tflite')
    qt = quantizer_lib.Quantizer(graph, recipe)
    calibration_result = None
    if qt.need_calibration:
      data = (calibration_data_per_section or {}).get(sid)
      if data is None:
        raise ValueError(
            f'litertlm section {sid} ({model_type}) needs calibration '
            'data.')
      calibration_result = qt.calibrate(data, device=device)
    result = qt.quantize(calibration_result)
    items = dict(sec.items)
    items['aeqt_format'] = litertlm.MetaValue(litertlm.VDATA_STRING, 'aeqg')
    out_sections.append((
        _graph_to_aeqg_bytes(result.quantized_model),
        litertlm.SECTION_GENERIC_BINARY, items))
    report.append((sid, model_type, True))
  litertlm.write_litertlm(out_path, out_sections,
                          system_metadata=lm.system_metadata_raw)
  return report


def quantize_bundle(
    bundle: Bundle,
    recipe_mapping: dict,
    calibration_data_per_section: Optional[dict] = None,
    device='cuda',
) -> Bundle:
  """Quantize every section with its model_type's recipe.

  recipe_mapping: {model_type: recipe list}; 'default' is the fallback; a
  missing entry (and no default) leaves the section float. device: where
  a section that needs calibration runs.
  """
  from ai_edge_quantizer_tpu_torch import quantizer as quantizer_lib

  out_sections = []
  for sec in bundle.sections:
    recipe = recipe_mapping.get(sec.model_type,
                                recipe_mapping.get('default'))
    if recipe is None:
      out_sections.append(sec)
      continue
    qt = quantizer_lib.Quantizer(sec.graph, recipe)
    calibration_result = None
    if qt.need_calibration:
      data = (calibration_data_per_section or {}).get(sec.name)
      if data is None:
        raise ValueError(
            f'Section {sec.name!r} ({sec.model_type}) needs calibration '
            'data.')
      calibration_result = qt.calibrate(data, device=device)
    result = qt.quantize(calibration_result)
    out_sections.append(dataclasses.replace(
        sec, graph=result.quantized_model))
  return Bundle(sections=out_sections, metadata=dict(bundle.metadata))
