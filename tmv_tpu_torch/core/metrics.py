"""Training observability: step timing, throughput, profiler traces.

Port of ``tmv_tpu/core/metrics.py``: a rolling step-time / images-per-second
meter on the host clock, a JSONL metrics sink, and ``profiler_trace``, which
runs ``torch.profiler`` over the CPU and CUDA activities and writes a Chrome
trace (``jax.profiler`` in the JAX package).
"""

import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Optional


class StepTimer:
    """Rolling-window step-time and throughput meter."""

    def __init__(self, window: int = 50, batch_size: Optional[int] = None):
        self.window = deque(maxlen=window)
        self.batch_size = batch_size
        self._last = None
        self.total_steps = 0

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            dt = now - self._last
            self.window.append(dt)
            mean = sum(self.window) / len(self.window)
            out["step_time_s"] = dt
            out["step_time_mean_s"] = mean
            if self.batch_size:
                out["images_per_sec"] = self.batch_size / mean
        self._last = now
        self.total_steps += 1
        return out


class MetricsLogger:
    """JSONL metrics sink (one line per step/epoch)."""

    def __init__(self, path: Optional[str] = None, print_every: int = 0):
        self.path = path
        self.print_every = print_every
        self._file = open(path, "a") if path else None
        self._count = 0

    def log(self, step: int, metrics: Dict):
        record = {"step": int(step)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        self._count += 1
        if self.print_every and self._count % self.print_every == 0:
            print(record)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the block; the Chrome trace lands in
    ``log_dir/trace.json``. Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
