"""Checkpoint I/O for serving weight stores.

Multi-GB quantized weights restore straight onto the device without a
host-side staging copy of the whole store: the serving analog of the
reference's mmap model loads.

The `.aeqg` container (graph/serialize.py) remains the canonical model
format; this module checkpoints the EXECUTOR's weight dict (integer
tensors + any packed layouts) for fast serving restarts.

Port of `ai_edge_quantizer_tpu/graph/checkpoint.py`, whose orbax store
imports jax. The port keeps its flat `'{sg}__{tid}'` keys and writes them
with `torch.save` into one file in the checkpoint directory; the load
maps that file (`torch.load(weights_only=True, mmap=True)`) and places
each tensor on `device`, the card unless the caller asks for the CPU.
Tensors that share storage (buffers that several tensors alias) are
saved once and come back shared.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

FILE_NAME = 'serving_weights.pt'


def _flatten(weights: dict) -> dict:
  """(sg_idx, tid) keys -> string keys."""
  return {f'{sg}__{tid}': v for (sg, tid), v in weights.items()}


def _unflatten(tree: dict) -> dict:
  out = {}
  for key, v in tree.items():
    sg, tid = key.split('__')
    out[(int(sg), int(tid))] = v
  return out


def save_serving_weights(weights: dict, path: str) -> None:
  """Checkpoint an executor weight dict to `path` (a directory, replaced
  if it holds a checkpoint)."""
  path = os.path.abspath(path)
  os.makedirs(path, exist_ok=True)
  target = os.path.join(path, FILE_NAME)
  tmp = f'{target}.{os.getpid()}.tmp'
  torch.save(_flatten(weights), tmp)
  os.replace(tmp, target)


def load_serving_weights(
    path: str,
    shardings: Optional[dict] = None,
    device='cuda',
) -> dict:
  """Restore an executor weight dict onto `device`. `shardings` (the JAX
  package's mesh placement) needs the multi-device modules, which are not
  ported yet (parallel/mesh.py, parallel/sharding.py)."""
  if shardings:
    raise NotImplementedError(
        'load_serving_weights(shardings=...): placing weights on a mesh '
        'needs the multi-device modules (parallel/mesh.py, '
        'parallel/sharding.py), not ported yet (ROADMAP.md Queue 1 item 7, '
        'multi-device).')
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'load_serving_weights: device cuda requested but no CUDA device is '
        "available; pass device='cpu'.")
  restored = torch.load(os.path.join(os.path.abspath(path), FILE_NAME),
                        map_location=device, weights_only=True, mmap=True)
  return _unflatten(restored)
