"""Thread-safe request queue + background worker for the serving engine.

A copy of ``repro.serving.queue`` on the port's registry.  The front half
of the MLPerf-style pipeline: ``submit`` enqueues a request and
immediately returns a ``concurrent.futures.Future``; one worker thread
drains the queue, executes each request through the engine's per-bucket
callables, and resolves the future with
the (items, scores) arrays.  The queue is the engine's backpressure
surface — its depth is exported live as the ``serve_queue_depth`` gauge,
and the time a request spends waiting in it lands in the
``queue_wait_seconds`` histogram, kept strictly separate from the
on-device ``serve_batch_seconds``.

Shutdown semantics: ``close()`` rejects new submissions;
``drain()`` blocks until everything already enqueued has resolved;
``shutdown(drain=True)`` does both and joins the thread.  A request
still queued at a non-draining shutdown gets its future cancelled —
nothing ever hangs silently.

``call(fn)`` queues a function to run on the worker thread between
requests, in queue order (the sharded engine's refresh, whose collectives
must run on the one thread that owns the process group); ``shutdown``'s
``last`` runs there after the backlog, before the thread stops.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from repro_torch import obs


class Request:
    """One in-flight serving request."""

    __slots__ = ("user_ids", "future", "t_submit")

    def __init__(self, user_ids: np.ndarray):
        self.user_ids = user_ids
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class _Call:
    """A function queued to run on the worker thread (``call``)."""

    __slots__ = ("fn", "future")

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn
        self.future: Future = Future()


_STOP = object()


class ServeWorker:
    """Queue + the one background thread draining it.

    ``execute(request)`` is the engine's hook: it runs the bucketed
    executions and returns the result tuple; this class owns only the
    threading discipline (futures, depth gauge, drain/close)."""

    def __init__(self, execute: Callable[[Request], tuple],
                 name: str = "serving-engine"):
        self._execute = execute
        self._q: _queue.Queue = _queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._depth = obs.gauge("serve_queue_depth")
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    # producer side
    # ------------------------------------------------------------------ #

    def submit(self, user_ids: np.ndarray) -> Future:
        req = Request(user_ids)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "serving engine is shut down; no new requests accepted"
                )
            self._q.put(req)
        self._depth.set(self._q.qsize())
        return req.future

    def call(self, fn: Callable[[], object]) -> Future:
        """Run ``fn()`` on the worker thread after everything queued so
        far; the future resolves to its result."""

        item = _Call(fn)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "serving engine is shut down; no new work accepted"
                )
            self._q.put(item)
        return item.future

    @property
    def depth(self) -> int:
        return self._q.qsize()

    # ------------------------------------------------------------------ #
    # worker side
    # ------------------------------------------------------------------ #

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if not item.future.set_running_or_notify_cancel():
                    continue          # cancelled while queued
                if isinstance(item, _Call):
                    run = item.fn
                else:
                    obs.histogram("queue_wait_seconds").observe(
                        time.perf_counter() - item.t_submit
                    )
                    run = lambda req=item: self._execute(req)  # noqa: E731
                try:
                    item.future.set_result(run())
                except Exception as err:  # surface, never kill the worker
                    item.future.set_exception(err)
            finally:
                self._q.task_done()
                self._depth.set(self._q.qsize())

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def drain(self) -> None:
        """Block until every request enqueued so far has resolved."""

        self._q.join()

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None,
                 last: Optional[Callable[[], object]] = None) -> None:
        """Stop accepting work, optionally finish the backlog, join the
        thread.  With ``drain=False`` still-queued requests are cancelled
        (their futures raise ``CancelledError``).  ``last`` runs on the
        worker thread after the backlog, before it stops; an error it
        raises is raised here."""

        self.close()
        if drain:
            self._q.join()
        else:
            while True:
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if item is not _STOP:
                    item.future.cancel()
                self._q.task_done()
        final = None
        if last is not None and self._thread.is_alive():
            final = _Call(last)
            self._q.put(final)
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
        if final is not None:
            final.future.result(timeout=0 if self._thread.is_alive()
                                else None)
