"""Error metrics for the dual-model validator.

Parity: reference `utils/validation_utils.py` — same five metrics with the
same conventions (flatten, nan/inf sanitization, data2 treated as the
reference/true signal).

A copy of `ai_edge_quantizer_tpu/execution/validation_utils.py` (numpy
only): the port keeps its own so that it never imports the JAX package.
The values are the same; `_sanitize_pair` copies only arrays that hold a
NaN or an infinity.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _sanitize(x):
  # Only an array with a non-finite value is copied (nan_to_num changes
  # nothing else); a full-size model's tensors are gigabytes.
  if np.isfinite(x).all():
    return x
  return np.nan_to_num(x, nan=1e-9, neginf=-1e9, posinf=1e9, copy=True)


def _sanitize_pair(data1, data2):
  a = np.ravel(np.asarray(data1, dtype=np.float32))
  b = np.ravel(np.asarray(data2, dtype=np.float32))
  if a.shape != b.shape:
    raise ValueError('Compared tensors must have the same number of elements.')
  return _sanitize(a), _sanitize(b)


def mean_squared_difference(data1, data2) -> float:
  a, b = _sanitize_pair(data1, data2)
  if a.size == 0:
    return 0.0
  return float(np.mean(np.square(a - b)))


def median_diff_ratio(data1, data2, tolerance_threshold: float = 1e-6) -> float:
  a, b = _sanitize_pair(data1, data2)
  if a.size == 0:
    return 0.0
  return float(np.median(np.abs(a - b) / (np.abs(b) + tolerance_threshold)))


def cosine_similarity(data1, data2) -> float:
  a, b = _sanitize_pair(data1, data2)
  if a.size == 0:
    return 0.0
  na, nb = np.linalg.norm(a), np.linalg.norm(b)
  if na == 0 and nb == 0:
    return 1.0
  if na == 0 or nb == 0:
    return 0.0
  return float(np.dot(a, b) / (na * nb))


def kl_divergence(data1, data2, epsilon: float = 1e-9) -> float:
  """KL(P=data2 || Q=data1); negatives clipped to 0."""
  a, b = _sanitize_pair(data1, data2)
  if a.size == 0:
    return 0.0
  p = np.maximum(0, b)
  q = np.maximum(0, a)
  return float(np.sum(p * np.log((p + epsilon) / (q + epsilon))))


def signal_to_noise_ratio(noisy_signal, signal, epsilon: float = 1e-9) -> float:
  a, b = _sanitize_pair(noisy_signal, signal)
  if b.size == 0:
    return 0.0
  mse = float(np.mean(np.square(a - b)))
  power = float(np.mean(np.square(b)))
  return power / (mse + epsilon)


_METRICS = {
    'mse': mean_squared_difference,
    'median_diff_ratio': median_diff_ratio,
    'cosine_similarity': cosine_similarity,
    'kl_divergence': kl_divergence,
    'snr': signal_to_noise_ratio,
}


def get_validation_func(func_name: str) -> Callable:
  fn = _METRICS.get(func_name)
  if fn is None:
    raise ValueError(
        f'Validation function {func_name!r} not supported; '
        f'have {sorted(_METRICS)}.')
  return fn
