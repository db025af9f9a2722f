"""Prefetching device loader, the counterpart of ``x2i_tpu/data/loader.py``.

The reference wraps torch's DataLoader with a ``Preprocess`` hook
interface (cpu_preprocess in the fetcher, gpu_preprocess on a dedicated
CUDA stream in a daemon thread with a bounded queue) and an optional
remote fetch tier. Here:

  * ``PrefetchLoader``: the daemon thread and the bounded queue of 2; an
    error in the thread is raised in the consumer, and a wait on the queue
    longer than ``timeout`` raises ``queue.Empty``;
  * ``StreamCopy``: the reference's side-stream copy to the card, JAX's
    ``device_put`` hook. The loader thread copies each numpy array from
    pinned host memory with ``non_blocking=True`` on a side CUDA stream
    and records an event after the copies; the consumer's stream waits on
    that event when it takes the batch (without the wait a step can read
    a half-copied batch), and ``record_stream`` marks each tensor used on
    the consumer's stream (without it the caching allocator may hand a
    batch's memory to another tensor while the step still reads it). On
    the CPU it makes tensors of the arrays;
  * ``MultiprocessLoader``: a pool of forked workers feeding one queue.
    The ``fork`` context is JAX's: ``make_iterable`` is often a closure,
    which ``spawn`` cannot pickle. A forked worker must not touch CUDA
    (the parent may have initialized it), so its samples stay numpy and
    the copy to the card happens in the parent's loader thread;
  * ``stack_collate``.

For fetching across machines see ``data/remote.py``.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch


class Preprocess:
    """The reference's hook interface (core/data/dataloader.py:36-48)."""

    def has_cpu_preprocess(self) -> bool:
        return False

    def cpu_preprocess(self, sample):
        return sample

    def has_device_preprocess(self) -> bool:
        return False

    def device_preprocess(self, batch):
        """Runs on the loader thread right before the batch is handed to
        the device copy."""
        return batch


class PrefetchLoader:
    """Daemon-thread loader with a bounded queue (depth 2, like the
    reference) that overlaps host-side preprocessing and the copy to the
    device with the running step.

    ``device_put(batch)`` runs on the loader thread; if it has a ``take``
    method (``StreamCopy``), the consumer calls ``take(item)`` on the item
    before yielding it. Per batch the loader records ``host_s`` (the
    loader thread's time to produce and hand over the batch, the wait for
    room in the queue excluded) and ``wait_s`` (the consumer's wait on the
    queue)."""

    _DONE = object()

    def __init__(self, batches: Iterable, preprocess: Optional[Preprocess]
                 = None, device_put: Optional[Callable] = None,
                 prefetch: int = 2, timeout: float = 600.0):
        self.batches = batches
        self.preprocess = preprocess
        self.device_put = device_put
        self.prefetch = prefetch
        self.timeout = timeout
        self.host_s: List[float] = []
        self.wait_s: List[float] = []

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        error: list = []
        take = getattr(self.device_put, "take", None)

        def worker():
            try:
                it = iter(self.batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    if self.preprocess is not None and \
                            self.preprocess.has_device_preprocess():
                        batch = self.preprocess.device_preprocess(batch)
                    if self.device_put is not None:
                        batch = self.device_put(batch)
                    self.host_s.append(time.perf_counter() - t0)
                    q.put(batch)
            except Exception as exn:          # noqa: BLE001
                error.append(exn)
            finally:
                q.put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            t0 = time.perf_counter()
            item = q.get(timeout=self.timeout)
            self.wait_s.append(time.perf_counter() - t0)
            if item is self._DONE:
                if error:
                    raise error[0]
                return
            yield take(item) if take is not None else item


class StreamCopy:
    """numpy batch (a dict of arrays) -> torch tensors on ``device``.

    On a CUDA device the copies run on a side stream from pinned host
    memory and return a pending batch; ``take`` (on the consumer's
    thread) makes the consumer's current stream wait for the copies and
    records each tensor's use there, and returns the dict. On the CPU
    ``take`` returns the tensors as they are."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, batch: Dict[str, np.ndarray]):
        if self.stream is None:
            return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                    for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   .pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, item):
        if self.stream is None:
            return item
        out, done = item
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out


def _mp_worker(make_iterable, cpu_preprocess, out_q, worker_id, num_workers):
    try:
        it = make_iterable(worker_id, num_workers)
        for sample in it:
            if cpu_preprocess is not None:
                sample = cpu_preprocess(sample)
            out_q.put(sample)
    except Exception as exn:                  # noqa: BLE001
        out_q.put(("__error__", repr(exn)))
    else:
        # the completion sentinel: a finite (resample=False) stream ends
        # cleanly instead of waiting for the timeout
        out_q.put(("__done__", worker_id))


class MultiprocessLoader:
    """Parallel sample production across forked processes (the remote
    tier's local equivalent). ``make_iterable(worker_id, num_workers)``
    builds each worker's stream (disjoint by worker id); samples stay on
    the host."""

    def __init__(self, make_iterable: Callable[[int, int], Iterable],
                 num_workers: int = 4,
                 cpu_preprocess: Optional[Callable] = None,
                 queue_size: int = 64):
        self.make_iterable = make_iterable
        self.num_workers = num_workers
        self.cpu_preprocess = cpu_preprocess
        self.queue_size = queue_size

    def __iter__(self):
        ctx = mp.get_context("fork")
        out_q: "mp.Queue" = ctx.Queue(maxsize=self.queue_size)
        procs = [
            ctx.Process(target=_mp_worker,
                        args=(self.make_iterable, self.cpu_preprocess,
                              out_q, i, self.num_workers),
                        daemon=True)
            for i in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        done = 0
        try:
            while done < self.num_workers:
                item = out_q.get(timeout=600.0)
                if isinstance(item, tuple) and len(item) == 2:
                    if item[0] == "__error__":
                        raise RuntimeError(
                            f"data worker failed: {item[1]}")
                    if item[0] == "__done__":
                        done += 1
                        continue
                yield item
        finally:
            # join the workers that finished; terminate the others (an
            # early exit of the consumer, an error)
            for p in procs:
                p.join(timeout=0.5 if done >= self.num_workers else 0.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5.0)


def stack_collate(samples, keys=None):
    """Default collate: np.stack of the keys the samples share (those not
    starting with "__")."""
    keys = keys or [k for k in samples[0] if not k.startswith("__")]
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}
