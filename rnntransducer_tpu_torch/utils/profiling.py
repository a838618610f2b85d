"""Tracing and step timing (port of ``rnntransducer_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` over the enclosed block, CPU and
  CUDA activities, written to ``logdir`` as a Chrome / Perfetto trace;
* ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``);
* ``StepTimer``: host clock per step, warm-up steps skipped, percentiles.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block: ``with trace('/tmp/trace'): run_steps()``.
    Yields the profiler; its Chrome trace is written to ``logdir`` on exit
    (view it at ui.perfetto.dev)."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """Named span in the trace of the enclosed host-side phase."""
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        """``sync_value``: a device tensor to fetch, forcing the work before
        it to finish.  A stop() without a start() returns 0.0."""
        if self._t0 is None:
            return 0.0
        if sync_value is not None:
            float(sync_value)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self._times:
            return {}
        a = np.asarray(self._times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p90_ms": float(np.percentile(a, 90) * 1e3),
            "max_ms": float(a.max() * 1e3),
        }
