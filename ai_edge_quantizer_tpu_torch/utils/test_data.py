"""Deterministic random test/calibration data generation per signature.

Parity: reference `utils/tfl_interpreter_utils.py` random data helpers
(seeded, dtype-aware: normal/uniform for floats, bounded ints for indices,
random booleans).

A copy of `ai_edge_quantizer_tpu/utils/test_data.py` (numpy only, the same
draws from the same seed): the port keeps its own so that it never imports
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ai_edge_quantizer_tpu_torch.graph import ir

_DEFAULT_SEED = 666


def _random_for_tensor(rng: np.random.Generator, tensor: ir.Tensor,
                       method: str = 'normal') -> np.ndarray:
  shape = tensor.shape
  if tensor.dtype in ('float32', 'float16', 'bfloat16'):
    if method == 'uniform':
      return rng.uniform(-1, 1, size=shape).astype(np.float32)
    return rng.standard_normal(size=shape).astype(np.float32)
  if tensor.dtype in ('int32', 'int64', 'int16', 'int8'):
    # Index-like inputs: small non-negative values.
    hi = 10
    return rng.integers(0, hi, size=shape).astype(tensor.dtype)
  if tensor.dtype == 'bool':
    return rng.integers(0, 2, size=shape).astype(bool)
  raise ValueError(f'Unsupported input dtype {tensor.dtype!r}.')


def create_random_dataset(
    graph: ir.Graph,
    num_samples: int = 4,
    seed: int = _DEFAULT_SEED,
    method: str = 'normal',
    signature_keys: Optional[list] = None,
) -> dict:
  """{signature_key: [ {input_name: array}, ... ]} for every signature."""
  rng = np.random.default_rng(seed)
  keys = signature_keys or graph.signature_keys()
  dataset = {}
  for key in keys:
    sig = graph.signature_by_key(key)
    sg = graph.subgraphs[sig.subgraph_index]
    samples = []
    for _ in range(num_samples):
      samples.append({
          name: _random_for_tensor(rng, sg.tensors[tid], method)
          for name, tid in sig.inputs.items()
      })
    dataset[key] = samples
  return dataset
