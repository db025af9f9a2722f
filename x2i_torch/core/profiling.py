"""Tracing and step timing, the counterpart of
``x2i_tpu/core/profiling.py``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` scope that writes a Chrome trace into
    ``trace_dir`` (one ``<ns>.pt.trace.json`` per scope), with the card's
    kernels where CUDA is available; nothing when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{time.time_ns()}.pt.trace.json"))


class StepTimer:
    """Host-clock time per step, the first ``warmup`` steps left out; the
    caller ends each step with a device synchronization."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._n = 0
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_s": float("nan"), "steps": 0}
        ts = sorted(self.times)
        return {"mean_s": sum(ts) / len(ts), "min_s": ts[0],
                "p50_s": ts[len(ts) // 2], "max_s": ts[-1],
                "steps": len(ts)}
