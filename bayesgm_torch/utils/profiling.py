"""Tracing, step timing and metrics logging (port of
``bayesgm_tpu/utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``) of the
  host and, where CUDA is present, of the card;
- :class:`StepTimer`: steps per second, leaving out the first ``warmup``
  steps;
- :class:`MetricsLogger`: an append-only JSONL file, one record per event,
  safe to tail while training.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``{log_dir}/trace.json``; yields the
    ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Track steps/sec excluding the first ``warmup`` steps."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._count = 0
        self._timed = 0
        self._start: Optional[float] = None

    def step(self, n: int = 1):
        self._count += 1
        if self._count == self.warmup:
            self._start = time.perf_counter()
            self._timed = 0
        elif self._count > self.warmup:
            self._timed += n

    @property
    def steps_per_sec(self) -> float:
        if self._start is None or self._timed == 0:
            return float("nan")
        return self._timed / (time.perf_counter() - self._start)


class MetricsLogger:
    """Append-only JSONL metrics: one record per event with a timestamp;
    values are stored as floats where ``float()`` takes them."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **metrics):
        record = {"time": time.time(), "event": event}
        for k, value in metrics.items():
            try:
                record[k] = float(value)
            except (TypeError, ValueError):
                record[k] = value
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
