"""Cross-machine sample-fetch tier, the counterpart of
``x2i_tpu/data/remote.py`` with the same wire protocol: a port worker can
serve a JAX service and a JAX worker a port service.

The reference scales host-side decode and preprocessing beyond the
trainer's machine with a Ray actor pool: the trainer exposes an index
queue and a result queue through an rpyc service, and remote workers loop
get_index -> fetch(index) -> put_result. Here the same queue protocol runs
over plain TCP with length-prefixed pickle frames (a 4-byte big-endian
length, then the pickled tuple; ops ``get_index`` / ``put_result`` from
the worker, ``index`` / ``empty`` / ``stop`` / ``ok`` from the service):

  * ``FetchService`` (trainer side): a thread-per-connection server owning
    a bounded index queue and a bounded result queue;
  * ``FetchWorker`` (remote CPU side): connects, then loops get_index ->
    fetch_fn(index) -> put_result on a small thread pool; an exception in
    fetch_fn travels to the trainer as its traceback;
  * ``RemoteFetchLoader``: the trainer-side iterator, feeding indices and
    yielding results; a finite sampler's epoch ends once every sent index
    is accounted for.

Trust: payloads are pickled, so unpickling a frame can run arbitrary code
(the reference's rpyc / SyncManager queues have the same trust model).
Run this on a private cluster network only.
"""

from __future__ import annotations

import pickle
import queue
import socket
import socketserver
import struct
import threading
import traceback
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional

_HDR = struct.Struct("!I")

# wire ops
_GET_INDEX = "get_index"
_PUT_RESULT = "put_result"
_INDEX = "index"
_EMPTY = "empty"
_STOP = "stop"
_OK = "ok"


def _send(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv(sock: socket.socket) -> Any:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class FetchError(RuntimeError):
    """A remote worker's fetch raised; carries the remote traceback."""


class _RemoteException:
    """An exception that crosses the wire as its traceback string."""

    def __init__(self, index):
        self.index = index
        self.tb = traceback.format_exc()


def _is_remote_error(result) -> bool:
    """A fetch's failure, from a port worker or a JAX one (the class of
    the same name in ``x2i_tpu.data.remote``)."""
    return (type(result).__name__ == "_RemoteException"
            and hasattr(result, "tb"))


class FetchService:
    """Trainer-side queue server. Workers connect over TCP and speak two
    ops: ``get_index`` pops the next index to fetch (or answers ``empty``
    / ``stop``), ``put_result`` pushes a fetched sample back. The bounded
    queues give backpressure, like the reference's Queue(maxsize) pair."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 index_queue_size: int = 64, result_queue_size: int = 64):
        self._index_q: "queue.Queue" = queue.Queue(index_queue_size)
        self._result_q: "queue.Queue" = queue.Queue(result_queue_size)
        self._stopping = threading.Event()
        svc = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    while True:
                        msg = _recv(sock)
                        op = msg[0]
                        if op == _GET_INDEX:
                            svc._serve_index(sock)
                        elif op == _PUT_RESULT:
                            svc._result_q.put((msg[1], msg[2]))
                            _send(sock, (_OK,))
                        else:
                            raise ValueError(f"unknown op {op!r}")
                except (ConnectionError, OSError):
                    # the worker went away; its indices were delivered or
                    # are still queued for the others
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self._thread.start()

    def _serve_index(self, sock) -> None:
        if self._stopping.is_set():
            _send(sock, (_STOP,))
            return
        try:
            idx = self._index_q.get(timeout=1.0)
        except queue.Empty:
            _send(sock, (_STOP,) if self._stopping.is_set() else (_EMPTY,))
            return
        if idx is _STOP:
            # put it back so that every worker thread sees it
            self._index_q.put(_STOP)
            _send(sock, (_STOP,))
        else:
            _send(sock, (_INDEX, idx))

    # the trainer's side ------------------------------------------------
    def submit(self, index: Any) -> None:
        self._index_q.put(index)

    def get_result(self, timeout: Optional[float] = None):
        return self._result_q.get(timeout=timeout)

    def stop(self) -> None:
        """Tell the workers the run is over (their next get_index after the
        queue drains answers ``stop``)."""
        self._stopping.set()
        try:
            self._index_q.put_nowait(_STOP)
        except queue.Full:
            pass

    def close(self) -> None:
        self.stop()
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FetchWorker:
    """Remote CPU worker. ``fetch_fn(index) -> sample`` is the dataset
    fetcher, typically a decode + preprocess closure; ``num_threads``
    overlaps fetches. An exception inside fetch_fn is shipped to the
    trainer instead of ending the worker."""

    def __init__(self, host: str, port: int,
                 fetch_fn: Callable[[Any], Any], num_threads: int = 1):
        self.host, self.port = host, port
        self.fetch_fn = fetch_fn
        self.num_threads = max(1, num_threads)

    def _loop(self) -> None:
        sock = socket.create_connection((self.host, self.port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                _send(sock, (_GET_INDEX,))
                msg = _recv(sock)
                if msg[0] == _STOP:
                    return
                if msg[0] == _EMPTY:
                    continue
                index = msg[1]
                try:
                    result = self.fetch_fn(index)
                except Exception:             # noqa: BLE001
                    result = _RemoteException(index)
                _send(sock, (_PUT_RESULT, index, result))
                if _recv(sock)[0] != _OK:
                    raise ConnectionError("put_result not acknowledged")
        finally:
            sock.close()

    def run(self) -> None:
        """Blocking: fetch until the service says stop."""
        threads = [threading.Thread(target=self._loop, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


def run_worker(host: str, port: int, fetch_fn: Callable[[Any], Any],
               num_threads: int = 1) -> None:
    """Entry point of a remote CPU machine:
    ``python -c "from x2i_torch.data.remote import run_worker; ..."``."""
    FetchWorker(host, port, fetch_fn, num_threads).run()


class RemoteFetchLoader:
    """Iterator over remotely fetched samples. ``sampler`` yields indices
    (shard URLs, member ranges, sample keys...). A feeder thread keeps the
    service's index queue full; the consumer yields results as workers
    deliver them (unordered, as the reference's result queue). A finite
    sampler ends its epoch once exactly one result per sent index came
    back; workers idle on ``empty`` between epochs and leave only when the
    owner calls ``service.stop()`` / ``close()``.

    on_error: "raise" (the default) raises a remote traceback as
    FetchError; "warn" skips the sample with a warning and continues.
    ``timeout``: the longest wait for one result, after which
    ``queue.Empty`` is raised."""

    def __init__(self, sampler: Iterable, service: FetchService,
                 on_error: str = "raise", timeout: float = 600.0):
        if on_error not in ("raise", "warn"):
            raise ValueError(f"on_error={on_error!r}")
        self.sampler = sampler
        self.service = service
        self.on_error = on_error
        self.timeout = timeout

    def __iter__(self) -> Iterator[Any]:
        sent = 0
        done_feeding = threading.Event()

        def feed():
            nonlocal sent
            for idx in self.sampler:
                self.service.submit(idx)
                sent += 1
            done_feeding.set()

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        received, waited = 0, 0.0
        try:
            while not (done_feeding.is_set() and received >= sent):
                try:
                    index, result = self.service.get_result(timeout=0.5)
                except queue.Empty:
                    waited += 0.5
                    if waited >= self.timeout:
                        raise
                    continue
                received, waited = received + 1, 0.0
                if _is_remote_error(result):
                    if self.on_error == "raise":
                        raise FetchError(
                            f"remote fetch of index {index!r} failed:\n"
                            f"{result.tb}")
                    warnings.warn(
                        f"skipping index {index!r}: remote fetch failed "
                        f"(on_error='warn'):\n{result.tb}")
                    continue
                yield result
        finally:
            feeder.join(timeout=5)
