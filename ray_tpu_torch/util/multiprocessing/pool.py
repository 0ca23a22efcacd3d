"""multiprocessing.Pool shim over the actor runtime.

Reference: `python/ray/util/multiprocessing/pool.py` — a drop-in
`multiprocessing.Pool` whose worker processes are actors, so pools span
the cluster instead of one host.  Same surface: apply/apply_async,
map/map_async, imap/imap_unordered, starmap, close/terminate/join,
context manager.
"""

from __future__ import annotations

import itertools
import threading
import time
from multiprocessing import TimeoutError
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch as rt

_DEFAULT_CHUNK_TARGET = 4  # chunks per worker for map, like the reference


class _PoolWorker:
    """One pool process: runs an optional initializer then executes
    function chunks."""

    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_chunk(self, func, chunk, star):
        if star:
            return [func(*item) for item in chunk]
        return [func(item) for item in chunk]


class AsyncResult:
    """Reference: multiprocessing.pool.AsyncResult semantics."""

    def __init__(self, refs: List, single: bool, callback=None,
                 error_callback=None):
        self._refs = refs
        self._single = single
        self._value = None
        self._error = None
        self._done = threading.Event()
        t = threading.Thread(target=self._collect,
                             args=(callback, error_callback), daemon=True)
        t.start()

    def _collect(self, callback, error_callback):
        try:
            chunks = rt.get(self._refs)
            out = list(itertools.chain.from_iterable(chunks))
            self._value = out[0] if self._single else out
            if callback is not None:
                callback(self._value)
        except Exception as e:  # noqa: BLE001 - user exception boundary
            self._error = e
            if error_callback is not None:
                error_callback(e)
        finally:
            self._done.set()

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        return self._error is None

    def wait(self, timeout: Optional[float] = None):
        self._done.wait(timeout)

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._value


class Pool:
    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), maxtasksperchild=None, context=None,
                 ray_remote_args: Optional[dict] = None):
        if not rt.is_started():
            rt.init()
        if processes is None:
            processes = max(1, int(rt.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._processes = processes
        remote_args = {"num_cpus": 1, **(ray_remote_args or {})}
        worker_cls = rt.remote(**remote_args)(_PoolWorker)
        self._workers = [
            worker_cls.remote(initializer, tuple(initargs))
            for _ in range(processes)
        ]
        self._rr = itertools.count()
        self._closed = False
        self._outstanding: List[AsyncResult] = []

    # -- submission helpers -------------------------------------------
    def _next_worker(self):
        return self._workers[next(self._rr) % self._processes]

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(
                1, len(items) // (self._processes * _DEFAULT_CHUNK_TARGET)
            )
        return [
            items[i:i + chunksize] for i in range(0, len(items), chunksize)
        ], chunksize

    def _submit_chunks(self, func, chunks, star=False):
        return [
            self._next_worker().run_chunk.remote(func, chunk, star)
            for chunk in chunks
        ]

    # -- apply --------------------------------------------------------
    def apply(self, func: Callable, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args=(), kwds=None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_running()
        kwds = kwds or {}
        f = (lambda a: func(*a, **kwds)) if kwds else (lambda a: func(*a))
        ref = self._next_worker().run_chunk.remote(f, [tuple(args)], False)
        return self._track(AsyncResult([ref], single=True, callback=callback,
                                       error_callback=error_callback))

    # -- map ----------------------------------------------------------
    def map(self, func: Callable, iterable: Iterable, chunksize=None):
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable, chunksize=None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check_running()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(func, chunks)
        return self._track(AsyncResult(refs, single=False, callback=callback,
                                       error_callback=error_callback))

    def starmap(self, func: Callable, iterable: Iterable, chunksize=None):
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func, iterable, chunksize=None, callback=None,
                      error_callback=None) -> AsyncResult:
        self._check_running()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(func, chunks, star=True)
        return self._track(AsyncResult(refs, single=False, callback=callback,
                                       error_callback=error_callback))

    def imap(self, func, iterable, chunksize: Optional[int] = 1):
        """Ordered lazy iteration; chunks resolve as they finish."""
        self._check_running()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(func, chunks)
        for ref in refs:
            for item in rt.get(ref):
                yield item

    def imap_unordered(self, func, iterable, chunksize: Optional[int] = 1):
        """Unordered: whichever chunk finishes first yields first."""
        self._check_running()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(func, chunks)
        pending = list(refs)
        while pending:
            done, pending = rt.wait(pending, num_returns=1)
            for ref in done:
                for item in rt.get(ref):
                    yield item

    # -- lifecycle ----------------------------------------------------
    def _track(self, r: AsyncResult) -> AsyncResult:
        self._outstanding = [o for o in self._outstanding if not o.ready()]
        self._outstanding.append(r)
        return r

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for w in self._workers:
            rt.kill(w)
        self._workers = []
        self._outstanding = []

    def join(self):
        """Blocks until all submitted work has finished (the
        multiprocessing contract: close() then join() drains the pool)."""
        if not self._closed:
            raise ValueError("Pool is still running")
        for r in self._outstanding:
            r.wait()
        self._outstanding = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
