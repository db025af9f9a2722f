"""The training loop, the counterpart of ``x2i_tpu/train/runner.py``: the
step loop, per-step metrics, an ``on_metrics`` hook, the step timer,
step-directory checkpoints (``core/checkpointing.py``) with auto-resume
from the latest one, and traces of chosen steps (``core/profiling.py``).

A step's noise is ``step_noise(seed, step)``, keyed by the step, so that a
run resumed from a checkpoint draws what an unbroken run draws at each
step and is bit for bit that run. (JAX's loop restarts its key chain at
``jax.random.key(seed)`` on every ``run()``, so a resumed JAX run draws
other noise than an unbroken one.)

With a ``mesh`` (``core/mesh.py::make_mesh``) the loop is data-parallel
over the mesh's (data, fsdp) ranks, one process each: a rank steps on its
``shard_batch`` share of each batch, with a ``StepShard`` of the step's
noise as the step function's ``noise`` (the whole batch's draw, its share
kept; the gradients averaged over the ranks before the optimizer, as XLA
inserts for JAX), and logs the loss as the mean over the ranks. The main
process writes the checkpoints, the others wait at a barrier, and every
rank resumes from them (and waits, before its first step, for every rank
to have read them). On a one-member mesh the loop is the loop without
one, bit for bit.
"""

from __future__ import annotations

import contextlib
import gc
import logging
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch.distributed as dist

from x2i_torch.core.checkpointing import CheckpointManager
from x2i_torch.core.mesh import StepShard, data_axis, data_index, shard_batch
from x2i_torch.core.multihost import is_main_process
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
    garbage collector's walks (``frozen_heap``). ``mesh``: data-parallel
    over its (data, fsdp) ranks (see the module's docstring); every rank
    builds the same state and iterates the same batches."""

    def __init__(self, step_fn: Callable, state, batches: Iterable,
                 log_every: int = 50, seed: int = 0,
                 on_metrics: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpointing_steps: int = 1000,
                 max_to_keep: Optional[int] = 5,
                 trace_dir: Optional[str] = None,
                 trace_steps: Optional[range] = None, mesh=None):
        self.mesh = mesh
        self.data = None
        if mesh is not None and data_index(mesh)[1] > 1:
            self.data = data_axis(mesh)
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
            # no rank writes a step before every rank has read the last
            self._barrier()

    def _barrier(self):
        if self.mesh is not None and dist.get_world_size() > 1:
            dist.barrier()

    def run(self, max_steps: int) -> Dict[str, Any]:
        with frozen_heap():
            return self._run(max_steps)

    def _run(self, max_steps: int) -> Dict[str, Any]:
        timer = StepTimer(warmup=1)
        last: Dict[str, Any] = {}
        it = iter(self.batches)
        for step in range(self.state.step, max_steps):
            batch, noise = next(it), step_noise(self.seed, step)
            if self.data is not None:
                index, count = data_index(self.mesh)
                batch = shard_batch(batch, self.mesh)
                noise = StepShard(noise, index, count, self.data)
            tracing = step in self.trace_steps and self.trace_dir
            with trace(self.trace_dir if tracing else None):
                with timer:
                    self.state, metrics = self.step_fn(
                        self.state, batch, noise)
                    if self.data is not None:
                        metrics = dict(metrics, loss=self.data.sum(
                            [metrics["loss"]])[0] / self.data.size)
                    loss = float(metrics["loss"])  # waits for the device
            if self.on_metrics is not None:
                self.on_metrics(step, metrics)
            if step % self.log_every == 0 or step == max_steps - 1:
                last = {k: float(v) for k, v in metrics.items()}
                last["loss"] = loss
                log.info("step %d %s", step, last)
            if self.ckpt is not None and \
                    (step + 1) % self.checkpointing_steps == 0:
                self._save(step + 1)
        if self.ckpt is not None:
            self._save(max_steps)
        last["timing"] = timer.summary()
        return last

    def _save(self, step: int):
        """The main process writes; with a mesh every rank then waits for
        it, so that none reads a step directory before it is whole."""
        if is_main_process():
            self.ckpt.save(step, self.state)
        self._barrier()
