"""Calibration result (de)serialization and cross-signature QSV alignment.

Parity: reference `utils/calibration_utils.py` — JSON round-trip with numpy
encoding + `num_samples_calibrated` metadata, and min/max alignment of
tensors across signatures (the KV-cache prefill/decode alignment mechanism).

A copy of `ai_edge_quantizer_tpu/utils/calibration_utils.py` (numpy only):
the port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import json

import numpy as np

_METADATA_KEY = '__calibration_metadata__'


class _NumpyEncoder(json.JSONEncoder):

  def default(self, o):
    if isinstance(o, np.ndarray):
      return {'__ndarray__': o.tolist(), 'dtype': str(o.dtype)}
    if isinstance(o, (np.floating, np.integer)):
      return o.item()
    return super().default(o)


def _decode_hook(d):
  if '__ndarray__' in d:
    return np.asarray(d['__ndarray__'], dtype=d.get('dtype', 'float32'))
  return d


def qsvs_to_json(qsvs: dict, num_samples: int = 0,
                 extra_metadata: dict | None = None) -> str:
  payload = dict(qsvs)
  payload[_METADATA_KEY] = {
      'num_samples_calibrated': num_samples, **(extra_metadata or {})}
  return json.dumps(payload, cls=_NumpyEncoder)


def qsvs_from_json(text: str) -> tuple:
  payload = json.loads(text, object_hook=_decode_hook)
  metadata = payload.pop(_METADATA_KEY, {})
  return payload, metadata


def save_qsvs_to_json(qsvs: dict, path: str, num_samples: int = 0,
                      extra_metadata: dict | None = None) -> None:
  with open(path, 'w') as f:
    f.write(qsvs_to_json(qsvs, num_samples, extra_metadata))


def load_qsvs_from_json(path: str) -> tuple:
  with open(path) as f:
    return qsvs_from_json(f.read())


class CalibrationQsvAlignmentUtils:
  """Aligns QSVs of corresponding tensors across signatures.

  GenAI bundles run the same KV cache through prefill and decode programs;
  the cache tensors must share quantization parameters across both. This
  utility resolves signature IO names to tensor names (following
  SAME_AS_INPUT chains backwards through scale-transparent ops) and unifies
  their min/max.
  """

  _TRANSPARENT_OPS = frozenset([
      'RESHAPE', 'TRANSPOSE', 'SLICE', 'STRIDED_SLICE', 'BROADCAST_TO',
  ])

  def __init__(self, graph):
    self._graph = graph

  def _resolve_tensor_name(self, signature_key: str, io_name: str) -> str:
    sig = self._graph.signature_by_key(signature_key)
    sg = self._graph.subgraphs[sig.subgraph_index]
    tid = sig.inputs.get(io_name)
    if tid is None:
      tid = sig.outputs.get(io_name)
    if tid is None:
      raise ValueError(
          f'{io_name!r} is not an input or output of signature '
          f'{signature_key!r}.')
    # Walk backwards through scale-transparent producers so the aligned
    # tensor is the true source of the value range.
    from ai_edge_quantizer_tpu_torch.graph import ir as _ir
    while True:
      producer = _ir.tensor_producer(sg, tid)
      if producer < 0:
        break
      op = sg.ops[producer]
      if op.opcode not in self._TRANSPARENT_OPS:
        break
      tid = op.inputs[0]
    return sg.tensors[tid].name

  def align_quant_stats(
      self,
      qsvs: dict,
      signature_io_pairs: list,
  ) -> None:
    """signature_io_pairs: [(signature_key, io_name), ...] to unify.

    All resolved tensors get the elementwise min of mins and max of maxes.
    """
    names = [
        self._resolve_tensor_name(sig, io) for sig, io in signature_io_pairs
    ]
    stats = [qsvs[n] for n in names if n in qsvs and qsvs[n]]
    if not stats:
      return
    mn = stats[0]['min']
    mx = stats[0]['max']
    for s in stats[1:]:
      mn = np.minimum(mn, s['min'])
      mx = np.maximum(mx, s['max'])
    for n in names:
      qsvs[n] = {'min': mn, 'max': mx}
