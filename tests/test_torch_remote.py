"""The port's remote fetch tier (``x2i_torch/data/remote.py``): worker
processes over localhost TCP feed the trainer-side service; a second
epoch on one service; a worker's error raised (``on_error="raise"``) or
skipped with a warning (``"warn"``); a loader with no worker gives up
after its ``timeout``; and the wire shared with the JAX package: JAX's
``FetchWorker`` serves the port's ``FetchService`` (its errors too) and a
port worker serves JAX's service."""

import multiprocessing as mp
import queue
import threading

import numpy as np
import pytest

from x2i_tpu.data import remote as jremote
from x2i_torch.data import remote as tremote


def _fetch_square(index):
    return {"i": index, "x": np.full((4,), index * index, np.int32)}


def _fetch_flaky(index):
    if index == 3:
        raise ValueError(f"cannot decode sample {index}")
    return {"i": index}


FETCH = {"square": _fetch_square, "flaky": _fetch_flaky}


def _worker_main(package, port, fetch_name, num_threads):
    mod = {"port": tremote, "jax": jremote}[package]
    mod.run_worker("127.0.0.1", port, FETCH[fetch_name], num_threads)


def _spawn_workers(port, fetch_name, n=2, num_threads=2, package="port"):
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=_worker_main,
                         args=(package, port, fetch_name, num_threads),
                         daemon=True)
             for _ in range(n)]
    for p in procs:
        p.start()
    return procs


def _join(svc, procs):
    svc.stop()
    for p in procs:
        p.join(timeout=10)
        assert p.exitcode == 0


def test_two_worker_processes_fetch_an_epoch():
    with tremote.FetchService() as svc:
        procs = _spawn_workers(svc.address[1], "square")
        out = list(tremote.RemoteFetchLoader(range(20), svc))
        assert sorted(s["i"] for s in out) == list(range(20))
        for s in out:
            np.testing.assert_array_equal(s["x"], np.full(4, s["i"] ** 2))
        _join(svc, procs)


def test_a_second_epoch_reuses_the_service():
    with tremote.FetchService() as svc:
        procs = _spawn_workers(svc.address[1], "square", n=1)
        for epoch in range(2):
            got = sorted(s["i"] for s in tremote.RemoteFetchLoader(
                range(10 * epoch, 10 * epoch + 8), svc))
            assert got == list(range(10 * epoch, 10 * epoch + 8))
        _join(svc, procs)


def test_a_workers_error_raises_or_is_skipped():
    with tremote.FetchService() as svc:
        procs = _spawn_workers(svc.address[1], "flaky", n=1, num_threads=1)
        with pytest.raises(tremote.FetchError, match="cannot decode"):
            list(tremote.RemoteFetchLoader(range(6), svc))
        _join(svc, procs)
    with tremote.FetchService() as svc:
        procs = _spawn_workers(svc.address[1], "flaky", n=1, num_threads=1)
        with pytest.warns(UserWarning, match="skipping index 3"):
            got = sorted(s["i"] for s in tremote.RemoteFetchLoader(
                range(6), svc, on_error="warn"))
        assert got == [0, 1, 2, 4, 5]
        _join(svc, procs)
    with pytest.raises(ValueError):
        tremote.RemoteFetchLoader(range(2), None, on_error="ignore")


def test_no_worker_ends_in_the_timeout():
    with tremote.FetchService() as svc:
        with pytest.raises(queue.Empty):
            list(tremote.RemoteFetchLoader(range(2), svc, timeout=1.0))


@pytest.mark.parametrize("fetch", ["square", "flaky"])
def test_jax_worker_serves_the_ports_service(fetch):
    """The same frames both ways: JAX's worker (in a thread here) fetches
    for the port's service; its shipped error is the port's FetchError."""
    with tremote.FetchService() as svc:
        worker = threading.Thread(
            target=jremote.run_worker,
            args=("127.0.0.1", svc.address[1], FETCH[fetch], 2),
            daemon=True)
        worker.start()
        loader = tremote.RemoteFetchLoader(range(8), svc)
        if fetch == "flaky":
            with pytest.raises(tremote.FetchError, match="cannot decode"):
                list(loader)
        else:
            assert sorted(s["i"] for s in loader) == list(range(8))
        svc.stop()
        worker.join(timeout=10)
        assert not worker.is_alive()


def test_port_worker_serves_jaxs_service():
    with jremote.FetchService() as svc:
        procs = _spawn_workers(svc.address[1], "square", n=1)
        got = sorted(s["i"] for s in jremote.RemoteFetchLoader(range(8),
                                                                svc))
        assert got == list(range(8))
        _join(svc, procs)
