"""QSV (quantization statistic value) merge strategies.

Parity: reference `utils/qsv_utils.py` — EMA smoothing (default), running
min/max, and the GPTQ Hessian merge.

A copy of `ai_edge_quantizer_tpu/utils/qsv_utils.py`: the port keeps its own
so that it never imports the JAX package.
"""

from __future__ import annotations


import numpy as np

_EMA_DECAY = 0.95


def moving_average_update(qsv: dict, new_qsv: dict,
                          smoothing_factor: float = _EMA_DECAY) -> dict:
  """Exponential-moving-average update of min/max (the default policy)."""
  if not qsv:
    return dict(new_qsv)
  updated = dict(qsv)
  for key in ('min', 'max'):
    if key in qsv and key in new_qsv:
      updated[key] = smoothing_factor * np.asarray(qsv[key]) + (
          1 - smoothing_factor
      ) * np.asarray(new_qsv[key])
  return updated


def min_max_update(qsv: dict, new_qsv: dict) -> dict:
  """Running elementwise min/max update (keeps extremes)."""
  if not qsv:
    return dict(new_qsv)
  updated = dict(qsv)
  if 'min' in qsv and 'min' in new_qsv:
    updated['min'] = np.minimum(qsv['min'], new_qsv['min'])
  if 'max' in qsv and 'max' in new_qsv:
    updated['max'] = np.maximum(qsv['max'], new_qsv['max'])
  return updated


def gptq_and_moving_average_update(qsv: dict, new_qsv: dict) -> dict:
  """Merge GPTQ Hessian statistics (sample-weighted) + EMA min/max."""
  updated = moving_average_update(qsv, new_qsv)
  old_h, new_h = qsv.get('hessian'), new_qsv.get('hessian')
  old_n, new_n = qsv.get('num_samples', 0), new_qsv.get('num_samples', 0)
  if old_h is None:
    if new_h is not None:
      updated['hessian'] = new_h
      updated['num_samples'] = new_n
  elif new_h is not None:
    total = old_n + new_n
    updated['hessian'] = (
        np.asarray(old_h) * (old_n / total)
        + np.asarray(new_h) * (new_n / total)
    )
    updated['num_samples'] = total
  return updated
