"""Progress reporting: tqdm bars for large models + wall time, peak host
memory, and model-size ratio.

Parity: reference `utils/progress_utils.py` (ProgressBar auto-enabled at
>= 100 steps, ProgressReport with tracemalloc peak + size before/after).

A copy of `ai_edge_quantizer_tpu/utils/progress_utils.py`: the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

import logging
import time
import tracemalloc
from typing import Optional

from ai_edge_quantizer_tpu_torch.graph import ir


class ProgressBar:
  """tqdm progress bar, auto-disabled for small models.

  Parity: reference `utils/progress_utils.py:71` — bars appear only when
  total_steps >= 100 unless `enable` forces them. Degrades to a no-op when
  tqdm is unavailable."""

  def __init__(self, total_steps: int, description: str = '',
               disappear_on_finish: bool = False,
               enable: Optional[bool] = None):
    disable = total_steps < 100 if enable is None else not enable
    try:
      import tqdm
      self._bar = tqdm.tqdm(total=total_steps, desc=description,
                            leave=not disappear_on_finish, disable=disable)
    except ImportError:  # pragma: no cover - tqdm is a soft dependency
      self._bar = None

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc_value, traceback):
    self.close()

  def update_single_step(self) -> None:
    if self._bar is not None:
      self._bar.update(1)

  def close(self) -> None:
    if self._bar is not None:
      self._bar.close()


class ProgressReport:
  """Measures one quantization run and logs a summary."""

  def __init__(self, enable: bool = True):
    self.enable = enable
    self._start_time: Optional[float] = None
    self._size_before: int = 0
    self._tracing_started_here = False

  def start(self, float_graph: ir.Graph) -> None:
    if not self.enable:
      return
    self._start_time = time.perf_counter()
    self._size_before = float_graph.total_constant_bits() // 8
    if not tracemalloc.is_tracing():
      tracemalloc.start()
      self._tracing_started_here = True

  def finish(self, quantized_graph: ir.Graph) -> dict:
    if not self.enable or self._start_time is None:
      return {}
    elapsed = time.perf_counter() - self._start_time
    _, peak = tracemalloc.get_traced_memory()
    if self._tracing_started_here:
      tracemalloc.stop()
    size_after = quantized_graph.total_constant_bits() // 8
    ratio = size_after / max(self._size_before, 1)
    report = {
        'wall_time_s': elapsed,
        'peak_host_memory_bytes': peak,
        'model_size_before_bytes': self._size_before,
        'model_size_after_bytes': size_after,
        'size_ratio': ratio,
    }
    logging.info(
        'Quantization finished in %.2fs; peak host memory %.1f MiB; model '
        'size %.2f MiB -> %.2f MiB (%.1f%%).',
        elapsed, peak / 2**20, self._size_before / 2**20,
        size_after / 2**20, ratio * 100)
    return report
