"""The training loop, the counterpart of ``x2i_tpu/train/runner.py``: the
step loop, per-step metrics, an ``on_metrics`` hook and the step timer.
Checkpoint save and resume are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

log = logging.getLogger("x2i_torch.train")


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


def step_noise(seed: int, step: int) -> int:
    """The noise seed of one step, derived from the loop's seed."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class TrainLoop:
    """Drives ``step_fn(state, batch, noise) -> (state, metrics)`` over
    host batches. on_metrics(step, metrics) is called after every step
    (metrics are device tensors; the hook decides what to fetch)."""

    def __init__(self, step_fn: Callable, state, batches: Iterable,
                 log_every: int = 50, seed: int = 0,
                 on_metrics: Optional[Callable] = None):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.log_every = log_every
        self.seed = seed
        self.on_metrics = on_metrics

    def run(self, max_steps: int) -> Dict[str, Any]:
        timer = StepTimer(warmup=1)
        last: Dict[str, Any] = {}
        it = iter(self.batches)
        for step in range(self.state.step, max_steps):
            batch = next(it)
            with timer:
                self.state, metrics = self.step_fn(
                    self.state, batch, step_noise(self.seed, step))
                loss = float(metrics["loss"])      # waits for the device
            if self.on_metrics is not None:
                self.on_metrics(step, metrics)
            if step % self.log_every == 0 or step == max_steps - 1:
                last = {k: float(v) for k, v in metrics.items()}
                last["loss"] = loss
                log.info("step %d %s", step, last)
        last["timing"] = timer.summary()
        return last


