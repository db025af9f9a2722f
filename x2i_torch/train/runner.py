"""The training loop, the counterpart of ``x2i_tpu/train/runner.py``: the
step loop, per-step metrics, an ``on_metrics`` hook, the step timer,
step-directory checkpoints (``core/checkpointing.py``) with auto-resume
from the latest one, and traces of chosen steps (``core/profiling.py``).

A step's noise is ``step_noise(seed, step)``, keyed by the step, so that a
run resumed from a checkpoint draws what an unbroken run draws at each
step and is bit for bit that run. (JAX's loop restarts its key chain at
``jax.random.key(seed)`` on every ``run()``, so a resumed JAX run draws
other noise than an unbroken one.)
"""

from __future__ import annotations

import contextlib
import gc
import logging
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from x2i_torch.core.checkpointing import CheckpointManager
from x2i_torch.core.profiling import StepTimer, trace

log = logging.getLogger("x2i_torch.train")


@contextlib.contextmanager
def frozen_heap():
    """Inside the block, the objects that exist on entry (the modules,
    their parameters, the optimizer state) are kept out of the
    collector's generations (``gc.freeze``), and on exit they are given
    back. A full collection that a data loader's objects trigger inside a
    step then walks only what was made since; at full width, walking the
    whole trainer took 0.25 s in one data-fed step in three on an H100.
    Garbage is collected first, so that none is held for the block."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def step_noise(seed: int, step: int) -> int:
    """The noise seed of one step, derived from the loop's seed."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class TrainLoop:
    """Drives ``step_fn(state, batch, noise) -> (state, metrics)`` over
    host batches; ``state.step`` counts the steps taken. on_metrics(step,
    metrics) is called after every step (metrics are device tensors; the
    hook decides what to fetch).

    With ``checkpoint_dir`` the loop resumes at construction from the
    latest step directory there (the state filled in place, its tensors
    on their devices), saves every ``checkpointing_steps`` steps and at
    the end of ``run``, and keeps the newest ``max_to_keep``. The steps in
    ``trace_steps`` (none by default) are traced into ``trace_dir``.
    ``run`` keeps the objects that exist when it starts out of the
    garbage collector's walks (``frozen_heap``)."""

    def __init__(self, step_fn: Callable, state, batches: Iterable,
                 log_every: int = 50, seed: int = 0,
                 on_metrics: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpointing_steps: int = 1000,
                 max_to_keep: Optional[int] = 5,
                 trace_dir: Optional[str] = None,
                 trace_steps: Optional[range] = None):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.log_every = log_every
        self.seed = seed
        self.on_metrics = on_metrics
        self.checkpointing_steps = checkpointing_steps
        self.trace_dir = trace_dir
        self.trace_steps = trace_steps or range(0, 0)
        self.ckpt = (CheckpointManager(checkpoint_dir, max_to_keep)
                     if checkpoint_dir else None)
        if self.ckpt is not None:
            restored = self.ckpt.restore(template=self.state)
            if restored is not None:
                self.state = restored
                log.info("resumed from step %s", self.state.step)

    def run(self, max_steps: int) -> Dict[str, Any]:
        with frozen_heap():
            return self._run(max_steps)

    def _run(self, max_steps: int) -> Dict[str, Any]:
        timer = StepTimer(warmup=1)
        last: Dict[str, Any] = {}
        it = iter(self.batches)
        for step in range(self.state.step, max_steps):
            batch = next(it)
            tracing = step in self.trace_steps and self.trace_dir
            with trace(self.trace_dir if tracing else None):
                with timer:
                    self.state, metrics = self.step_fn(
                        self.state, batch, step_noise(self.seed, step))
                    loss = float(metrics["loss"])  # waits for the device
            if self.on_metrics is not None:
                self.on_metrics(step, metrics)
            if step % self.log_every == 0 or step == max_steps - 1:
                last = {k: float(v) for k, v in metrics.items()}
                last["loss"] = loss
                log.info("step %d %s", step, last)
            if self.ckpt is not None and \
                    (step + 1) % self.checkpointing_steps == 0:
                self.ckpt.save(step + 1, self.state)
        if self.ckpt is not None:
            self.ckpt.save(max_steps, self.state)
        last["timing"] = timer.summary()
        return last
