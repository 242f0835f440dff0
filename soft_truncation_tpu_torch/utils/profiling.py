"""Tracing and step timing.

Counterpart of ``soft_truncation_tpu/utils/profiling.py``:

  * ``trace(dir)``: a context manager around ``torch.profiler`` (the CPU's
    activity, and the card's where there is one) that writes a Chrome /
    Perfetto trace, ``dir/trace.json``, on exit; a no-op for no ``dir``.
  * ``StepTimer``: rolling steps/s and imgs/s since the last report on the
    host clock, with no device sync (a step's kernels may still be running
    when it ticks; over a log interval that evens out).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
  """Trace the block with ``torch.profiler`` into ``trace_dir/trace.json``
  (no-op if ``trace_dir`` is empty or None)."""
  if not trace_dir:
    yield
    return
  os.makedirs(trace_dir, exist_ok=True)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  with torch.profiler.profile(activities=activities) as prof:
    yield
    if torch.cuda.is_available():
      torch.cuda.synchronize()
  path = os.path.join(trace_dir, TRACE_FILE)
  prof.export_chrome_trace(path)
  log.info("profiler trace written to %s", path)


class StepTimer:
  """Rolling wall-clock step timing: ``tick()`` per step; ``report()``
  returns (steps/s, imgs/s) since the last report."""

  def __init__(self, batch_size: int):
    self.batch_size = batch_size
    self._t0 = time.perf_counter()
    self._steps = 0

  def tick(self) -> None:
    self._steps += 1

  def report(self):
    now = time.perf_counter()
    sps = self._steps / max(now - self._t0, 1e-9)
    self._t0, self._steps = now, 0
    return sps, sps * self.batch_size
