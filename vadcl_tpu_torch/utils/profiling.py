"""Tracing and throughput counters (``vadcl_tpu/utils/profiling.py``).

* ``trace_steps``: a ``torch.profiler`` trace (CPU ops and, on the card,
  CUDA kernels) of a window of steps, written as a Chrome trace
  (``chrome://tracing`` or Perfetto read it);
* ``StepTimer``: clips per second from an EMA of the time between steps,
  the throughput the training log prints.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_steps(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Profile the enclosed work and write ``<logdir>/trace.json`` when it
    ends; ``enabled=False`` profiles nothing and writes nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Clips per second from an EMA of the wall time between ticks."""

    def __init__(self, clips_per_step: int, ema: float = 0.9):
        self.clips_per_step, self.ema = clips_per_step, ema
        self._last: Optional[float] = None
        self.step_time: Optional[float] = None

    def tick(self) -> None:
        now = time.time()
        if self._last is not None:
            dt = now - self._last
            self.step_time = dt if self.step_time is None else (
                self.ema * self.step_time + (1 - self.ema) * dt)
        self._last = now

    @property
    def clips_per_sec(self) -> float:
        return self.clips_per_step / self.step_time if self.step_time else 0.0
