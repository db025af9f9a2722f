"""Request-batching serving engine, the port's own copy of
``x2i_tpu/serve.py``.

Collects requests from concurrent producers into size-bucketed batches: a
partial batch runs the smallest bucket that fits (e.g. {1, 2, 4}), so a
lone request at batch_size 4 runs a batch of 1 instead of padding the step
with duplicate work. Results are delivered per request via futures.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class BatchingServer:
    """Args:
      generate_batch: fn(list_of_request_dicts_padded_to_bucket) ->
        images (B, H, W, 3); requests carry the encoder inputs.
      batch_size: largest batch (top bucket).
      max_wait_s: longest wait to fill a batch before dispatching.
      buckets: batch sizes (default: powers of two up to batch_size); a
        partial batch runs the smallest bucket that fits.
    """

    _STOP = object()

    def __init__(self, generate_batch: Callable[[List[Dict]], np.ndarray],
                 batch_size: int = 1, max_wait_s: float = 0.05,
                 buckets: Optional[List[int]] = None):
        self.generate_batch = generate_batch
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        if buckets is None:
            buckets, b = [], 1
            while b < batch_size:
                buckets.append(b)
                b *= 2
            buckets.append(batch_size)
        self.buckets = sorted(set(buckets))
        if self.buckets[-1] != batch_size:
            raise ValueError(f"buckets {buckets} must top out at "
                             f"batch_size {batch_size}")
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: Dict[str, Any]) -> "Future[np.ndarray]":
        fut: "Future[np.ndarray]" = Future()
        self._queue.put((request, fut))
        return fut

    def generate(self, request: Dict[str, Any],
                 timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(request).result(timeout)

    def _collect(self) -> List:
        items = [self._queue.get()]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self):
        while not self._stop.is_set():
            items = [(r, f) for r, f in self._collect()
                     if r is not self._STOP]
            if not items:
                continue          # woken only by the close() sentinel
            requests = [r for r, _ in items]
            bucket = next(b for b in self.buckets if b >= len(requests))
            padded = requests + [requests[-1]] * (bucket - len(requests))
            try:
                images = self.generate_batch(padded)
                for i, (_, fut) in enumerate(items):
                    fut.set_result(np.asarray(images[i]))
            except Exception as exn:      # noqa: BLE001 -- to the callers
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(exn)

    def close(self):
        self._stop.set()
        # unblock the collector; the _STOP marker is filtered out in _loop
        self._queue.put((self._STOP, Future()))
        self._thread.join(timeout=5)
