"""``ServingEngine`` — the always-hot request path over a trained index.

Port of ``repro.serving.engine``.  A :class:`BucketLadder` routes every
request onto a fixed set of batch shapes, ``compile_buckets`` readies one
callable per bucket **at startup**, and a
:class:`~repro_torch.serving.queue.ServeWorker` drains submitted requests
into bucketed executions behind futures.  It serves on the device the
index lives on.  The contract the tests pin:

* **nothing readied at serve time** — ``serve_compiles_total`` equals the
  bucket count after ``__init__`` and never moves again;
* **identity** — each bucket runs ``recommend_topk`` itself, so engine
  answers equal a direct call on the same padded chunk exactly;
* **hot refresh** — ``refresh(result)`` swaps the factor buffers (same
  shapes, seen table re-padded to the fixed ``seen_capacity``) by one
  attribute store, and a request always runs against exactly one factor
  version (one snapshot per request);
* **clean shutdown** — ``drain()`` resolves the backlog, ``shutdown()``
  then rejects new work.

:class:`RefreshPolicy` adds the auto-refit loop: ``note_append(n)``
bookkeeping runs ``Trainer.refit`` and a hot swap once enough appends (or
enough wall time) accumulate — the serving side of the streaming loop.
The refit runs on the caller's thread while the worker keeps serving the
old factors; the swap is one attribute store.

The worker is a thread of its own.  The kernel wrapper makes the tensors'
device current around its launch, and the kernel library is loaded by the
startup runs on the constructing thread, so the worker holds no device
state of its own.

**On a rank grid** (``plan=`` a ``MeshPlan`` of more than one rank, one
engine on every rank of the process group): each rank holds its item
shard and every bucket runs the two-stage ``recommend_topk_sharded``, a
collective.  Requests go to rank 0's engine.  Its worker is the only
thread of rank 0 that touches the engine's process groups: before each
bucket execution it broadcasts a message (execute, the bucket, the
chunk's user ids), and every other rank runs a follower thread that
receives it and runs the same execution, so the collectives pair in one
order.
``refresh`` is collective too: every rank calls it with its own fit, in
the same order; it is queued to the worker (on rank 0, as a refresh
message between requests; elsewhere, for the follower to apply when that
message comes), so a request is answered by one factor version on every
rank.  ``shutdown`` on rank 0 broadcasts stop after the backlog; on the
other ranks it waits for that stop.  Every wait has a deadline
(``GRID_TIMEOUT``), and the collectives the process group's timeout.

A grid engine's collectives run on process groups of its own, made when
the engine is built (every rank builds its engine in the same order), so
a collective of another thread on the default group (a ``Gossip`` refit,
``total_cost_device``, a barrier) never pairs with them:

* the messages on a ``gloo`` group, whatever the default backend: a
  follower waiting for the next message waits on the host, not in a
  collective parked on the card that a device-wide synchronize would
  wait for;
* the candidates' all-gather on a group of the default backend (``nccl``
  with a card a rank, which moves card tensors).

On a card, the engine's device work (its startup runs, the executions,
the swaps) runs on a CUDA stream of its own.  Kernels that the main
thread enqueues, and the default group's collectives waiting on them,
then never sit in one stream with the engine's collectives: on a shared
stream each rank could order a refit's collective and the engine's
differently, and each would wait for the other.  A refresh hands its fit
over behind an event recorded on the caller's stream.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.kernels.quant import resolve_method
from repro_torch.mesh.plan import MeshPlan, plan_rank
from repro_torch.serve.quant import (QuantizedRecommendIndex, index_nbytes,
                                     quantize_index)
from repro_torch.serve.recommend import _u_shape, _w_shape, shard_index
from repro_torch.serving.buckets import DEFAULT_BUCKETS, BucketLadder
from repro_torch.serving.compiler import compile_buckets
from repro_torch.serving.queue import Request, ServeWorker

# messages rank 0's worker broadcasts to the followers of a grid engine
_OP_EXECUTE, _OP_REFRESH, _OP_STOP = 1, 2, 3
# seconds any wait of a grid engine (a refresh, a stop) may take
GRID_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """When should the engine refit and hot-swap its factors?

    ``max_appends``: refit once this many appended ratings accumulate
    (``note_append`` counts them).  ``max_age_seconds``: refit once the
    serving factors are this stale, checked at ``note_append`` time (the
    engine never starts a timer thread).  Either may be ``None``; at
    least one must be set."""

    max_appends: Optional[int] = None
    max_age_seconds: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_appends is None and self.max_age_seconds is None:
            raise ValueError(
                "RefreshPolicy needs max_appends and/or max_age_seconds"
            )
        if self.max_appends is not None and self.max_appends <= 0:
            raise ValueError(f"max_appends must be positive, "
                             f"got {self.max_appends}")
        if self.max_age_seconds is not None and self.max_age_seconds <= 0:
            raise ValueError(f"max_age_seconds must be positive, "
                             f"got {self.max_age_seconds}")

    def due(self, appends: int, age_seconds: float) -> bool:
        if self.max_appends is not None and appends >= self.max_appends:
            return True
        if (self.max_age_seconds is not None
                and age_seconds >= self.max_age_seconds):
            return True
        return False


def _pad_seen(seen, capacity: int, num_items: int) -> torch.Tensor:
    """Widen a seen table to the engine's fixed capacity (pad = n, the
    out-of-range id the serve-time mask drops)."""

    width = seen.shape[1]
    if width > capacity:
        raise ValueError(
            f"seen table width {width} exceeds the engine's fixed capacity "
            f"{capacity}; rebuild the engine with a larger seen_headroom "
            f"(bucket shapes are frozen at startup, so the seen axis "
            f"cannot grow under a refresh)"
        )
    if width == capacity:
        return seen
    pad = torch.full((seen.shape[0], capacity - width), num_items,
                     dtype=torch.int32, device=seen.device)
    return torch.cat([seen, pad], dim=1)


class ServingEngine:
    """Bucket-batched serving front end (see module docstring).

    ``seen_headroom`` reserves extra seen-table columns so that later
    refreshes (whose tables may be wider) still fit the frozen shapes.
    ``refresh_policy`` (with a trainer from :meth:`bind`) turns on the
    policy-driven refit of :meth:`note_append`.

    ``plan=`` (a ``MeshPlan``) shards the catalog's item axis over the
    plan's ranks, as ``RecommendService(plan=)`` does, and keeps only this
    rank's shard; on more than one rank the engine runs the grid protocol
    of the module docstring.

    ``quant="int8"`` serves the int8 factor cache: the index is quantized
    (symmetric per-row, serve/quant.py) before the buckets are readied, so
    every bucket scores through ``kernels/quant.dequant_score`` — on the
    card, the hand-written kernel — and ``refresh`` re-quantizes on every
    hot swap.  ``quant_method`` picks the scoring path
    (``"fused"``/``"dequant"``; ``None`` resolves from the index's device
    once, at startup, so all buckets and every later refresh serve one
    concrete method)."""

    def __init__(
        self,
        index,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        k: int = 10,
        exclude_seen: bool = True,
        plan=None,
        seen_headroom: int = 64,
        refresh_policy: Optional[RefreshPolicy] = None,
        quant: Optional[str] = None,
        quant_method: Optional[str] = None,
    ):
        self.ladder = (buckets if isinstance(buckets, BucketLadder)
                       else BucketLadder(tuple(buckets)))
        self.k = k
        self.exclude_seen = exclude_seen
        if plan is not None and not isinstance(plan, MeshPlan):
            raise TypeError(f"plan must be a MeshPlan, got "
                            f"{type(plan).__name__}")
        self.plan = plan
        self._grid = plan is not None and not plan.is_single_device
        # the grid protocol's own process groups (module docstring)
        self._msg_group = self._group = None
        if self._grid:
            self._msg_group = dist.new_group(backend="gloo")
            self._group = dist.new_group()
        self._rank = plan_rank(plan) if plan is not None else 0
        self.refresh_policy = refresh_policy
        if quant not in (None, "int8"):
            raise ValueError(
                f"unknown quant mode {quant!r}; expected None or 'int8'"
            )
        if isinstance(index, QuantizedRecommendIndex):
            quant = "int8"        # already-quantized input implies the mode
        elif quant == "int8":
            index = quantize_index(index)
        self.quant = quant
        self.device = index.seen.device
        # a grid engine's device work on a stream of its own (docstring)
        self._stream = None
        if self._grid and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self.quant_method = (resolve_method(quant_method, self.device)
                             if quant else None)
        self.num_users = int(index.num_users)
        self.num_items = int(index.num_items)
        if seen_headroom < 0:
            raise ValueError(f"seen_headroom must be >= 0, "
                             f"got {seen_headroom}")
        self.seen_capacity = int(index.seen.shape[1]) + int(seen_headroom)
        index = index._replace(
            seen=_pad_seen(index.seen, self.seen_capacity, self.num_items)
        )
        obs.gauge("serve_index_bytes",
                  dtype="int8" if quant else "f32").set(index_nbytes(index))
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self._bufs = (index if plan is None
                          else shard_index(index, plan, self._rank))
            self._execs = compile_buckets(self._bufs, self.ladder, k,
                                          exclude_seen,
                                          method=self.quant_method,
                                          group=self._group)
        # auto-refit state (RefreshPolicy / note_append)
        self._trainer = None
        self._fit_result = None
        self._latest_problem = None
        self._appends_since_refresh = 0
        self._refresh_lock = threading.Lock()
        self._t_last_refresh = time.perf_counter()
        # QPS window, same discipline as RecommendService
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._served_users = 0
        self._served_requests = 0
        # grid protocol state: the refreshes a follower holds until rank
        # 0's refresh message, its failure
        self._pending: queue.Queue = queue.Queue()
        self._failure: Optional[BaseException] = None
        self._stopped = False
        self._worker: Optional[ServeWorker] = None
        self._follower: Optional[threading.Thread] = None
        if self._rank == 0:
            self._worker = ServeWorker(self._execute)
        else:
            self._follower = threading.Thread(
                target=self._follow, name="serving-follower", daemon=True)
            self._follower.start()

    # ------------------------------------------------------------------ #
    # grid protocol
    # ------------------------------------------------------------------ #

    def _announce(self, op: int, bucket: int = 0, chunk=None) -> None:
        """Rank 0's worker: broadcast one message to the followers."""

        msg = torch.zeros(3 + self.ladder.max_size, dtype=torch.int32)
        msg[0], msg[1] = op, bucket
        if chunk is not None:
            msg[2] = len(chunk)
            msg[3:3 + len(chunk)] = torch.from_numpy(chunk)
        dist.broadcast(msg, src=0, group=self._msg_group)

    def _follow(self) -> None:
        """Ranks other than 0: mirror rank 0's worker, message by message,
        until stop."""

        msg = torch.empty(3 + self.ladder.max_size, dtype=torch.int32)
        try:
            while True:
                dist.broadcast(msg, src=0, group=self._msg_group)
                op, bucket, length = msg[:3].tolist()
                if op == _OP_STOP:
                    if self._stream is not None:
                        self._stream.synchronize()
                    return
                if op == _OP_REFRESH:
                    result, ready, future = self._pending.get(
                        timeout=GRID_TIMEOUT)
                    try:
                        future.set_result(self._swap(result, ready))
                    except Exception as err:  # the same on every rank
                        future.set_exception(err)
                elif op == _OP_EXECUTE:
                    chunk = msg[3:3 + length].numpy()
                    try:
                        with torch.cuda.stream(self._stream):
                            self._execs[bucket](self._bufs, chunk)
                    except Exception as err:  # rank 0's request fails too
                        self._failure = self._failure or err
                else:
                    raise RuntimeError(f"unknown grid message {op}")
        except BaseException as err:     # raised again by shutdown
            self._failure = err

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #

    def submit(self, user_ids) -> Future:
        """Enqueue one request; the future resolves to (items, scores)
        numpy arrays of shape (len(user_ids), k).  On a grid, requests go
        to rank 0's engine."""

        if self._worker is None:
            raise RuntimeError(
                f"rank {self._rank} of a grid engine takes no requests; "
                f"submit them to rank 0's engine")
        user_ids = np.asarray(user_ids, np.int32).ravel()
        if user_ids.size == 0:
            raise ValueError("empty request")
        if user_ids.min() < 0 or user_ids.max() >= self.num_users:
            raise ValueError(
                f"user ids out of range for {self.num_users} users: "
                f"[{user_ids.min()}, {user_ids.max()}]")
        return self._worker.submit(user_ids)

    def recommend(self, user_ids) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous convenience: submit + wait."""

        return self.submit(user_ids).result()

    def recommend_many(
        self, requests: Iterable
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Submit a batch of requests, wait for all, return results in
        submission order."""

        futures = [self.submit(r) for r in requests]
        return [f.result() for f in futures]

    def _execute(self, req: Request) -> Tuple[np.ndarray, np.ndarray]:
        """Worker-thread body: route one request through the ladder.

        The factor snapshot is taken ONCE per request — a concurrent
        ``refresh`` lands between requests, never inside one.  The user
        ids of each chunk cross to the device inside ``recommend_topk``;
        the host copies of the answer wait for the card, so each batch
        stamp is device-true."""

        bufs = self._bufs
        user_ids = req.user_ids
        n = len(user_ids)
        out_items = np.empty((n, self.k), np.int32)
        out_scores = np.empty((n, self.k), np.float32)
        if self._t_first is None:
            self._t_first = time.perf_counter()
        for start, length, bucket in self.ladder.plan(n):
            t0 = time.perf_counter()
            chunk = user_ids[start : start + length]
            if length < bucket:
                chunk = np.pad(chunk, (0, bucket - length))
            if self._grid:
                self._announce(_OP_EXECUTE, bucket, chunk)
            with torch.cuda.stream(self._stream):    # the copies too
                items, scores = self._execs[bucket](bufs, chunk)
                out_items[start : start + length] = \
                    items.cpu().numpy()[:length]
                out_scores[start : start + length] = \
                    scores.cpu().numpy()[:length]
            obs.histogram("serve_batch_seconds", bucket=str(bucket)).observe(
                time.perf_counter() - t0
            )
            obs.counter("engine_batches_total").inc()
        obs.histogram("serve_request_seconds").observe(
            time.perf_counter() - req.t_submit
        )
        obs.counter("engine_requests_total").inc()
        obs.counter("engine_users_total").inc(n)
        self._t_last = time.perf_counter()
        self._served_users += n
        self._served_requests += 1
        return out_items, out_scores

    # ------------------------------------------------------------------ #
    # refresh
    # ------------------------------------------------------------------ #

    def refresh(self, result) -> "ServingEngine":
        """Hot-swap the factor buffers from a refit (or a bare index).

        Accepts a ``FitResult`` (anything with ``to_recommend_index``) or
        a bare index.  The new factors must keep the engine's
        (m, r) × (n, r) shapes and the new seen table must fit the fixed
        ``seen_capacity`` — then the swap is one attribute store and the
        bucket callables keep running untouched.

        On an int8 engine a fresh f32 fit **re-quantizes on the swap**.
        The layouts never mix: handing a quantized index to an f32 engine
        raises instead of serving it through the other layout.

        On a grid every rank calls it with its own fit, in the same order;
        the swap is queued behind the requests already submitted (module
        docstring), and this call returns once it has happened."""

        if not self._grid:
            return self._swap(result)
        ready = None                    # the fit's work on the caller's stream
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        if self._rank == 0:
            def swap():
                self._announce(_OP_REFRESH)
                return self._swap(result, ready)
            future = self._worker.call(swap)
        else:
            if not self._follower.is_alive():
                raise RuntimeError(
                    "serving engine is shut down; no refresh accepted")
            future = Future()
            self._pending.put((result, ready, future))
        return future.result(timeout=GRID_TIMEOUT)

    def _swap(self, result, ready=None) -> "ServingEngine":
        """The refresh itself, on the calling thread; a grid engine on a
        card builds the new buffers on its own stream, after ``ready``,
        and waits for them before the caller may free the fit."""

        if self._stream is None:
            return self._build_swap(result)
        self._stream.synchronize()      # the old buffers' last reads
        self._stream.wait_event(ready)
        with torch.cuda.stream(self._stream):
            self._build_swap(result)
        self._stream.synchronize()
        return self

    def _build_swap(self, result) -> "ServingEngine":
        if hasattr(result, "to_recommend_index"):
            new = result.to_recommend_index()
        else:
            new = result
        if self.quant is None and isinstance(new, QuantizedRecommendIndex):
            raise ValueError(
                "refresh would mix factor layouts: this engine's buckets "
                "serve the f32 layout, but the swap-in is a "
                "QuantizedRecommendIndex (int8); serve int8 through "
                "ServingEngine(quant='int8') — a refresh cannot change "
                "the layout"
            )
        if self.quant == "int8":
            # f32 fit → fresh codes + scales; already-int8 → unchanged
            new = quantize_index(new)
        with self._refresh_lock:
            old_u, old_w = self._factor_shapes()
            got_u, got_w = _u_shape(new), _w_shape(new)
            if got_u != old_u or got_w != old_w:
                raise ValueError(
                    f"refresh changes the factor shapes: expected "
                    f"u{old_u} x w{old_w}"
                    f"{' (int8 layout)' if self.quant else ''}, got "
                    f"u{got_u} x w{got_w}; a re-shaped problem needs a "
                    f"new ServingEngine, not a refresh"
                )
            new = new._replace(
                seen=_pad_seen(new.seen, self.seen_capacity, self.num_items)
            )
            obs.gauge("serve_index_bytes",
                      dtype="int8" if self.quant else "f32").set(
                          index_nbytes(new))
            self._bufs = (new if self.plan is None
                          else shard_index(new, self.plan, self._rank))
            if hasattr(result, "to_recommend_index"):
                self._fit_result = result
            self._appends_since_refresh = 0
            self._t_last_refresh = time.perf_counter()
        obs.counter("engine_refreshes_total").inc()
        obs.gauge("engine_last_refresh_age_seconds").set(0.0)
        return self

    def _factor_shapes(self):
        if self.plan is None:
            return _u_shape(self._bufs), _w_shape(self._bufs)
        # a shard holds a slice of the padded item axis; the contract is
        # against the true catalog
        idx = self._bufs.index
        return _u_shape(idx), (self.num_items, _w_shape(idx)[1])

    def bind(self, trainer, result) -> "ServingEngine":
        """Attach the training side for policy-driven auto-refit:
        ``trainer.refit(result, problem)`` is what ``note_append`` runs
        when the :class:`RefreshPolicy` trips."""

        self._trainer = trainer
        self._fit_result = result
        return self

    def note_append(self, n: int, problem=None) -> bool:
        """Record ``n`` just-appended ratings (and optionally the grown
        problem); refit and hot-swap when the policy is due.

        Returns True iff a refresh happened.  The refit runs on the
        caller's thread; requests in flight keep the factor version they
        started with.  Without a bound trainer (or without a policy) this
        is pure bookkeeping."""

        if n < 0:
            raise ValueError(f"note_append takes a non-negative count, "
                             f"got {n}")
        self._appends_since_refresh += n
        if problem is not None:
            self._latest_problem = problem
        age = time.perf_counter() - self._t_last_refresh
        obs.gauge("engine_last_refresh_age_seconds").set(age)
        policy = self.refresh_policy
        if policy is None or self._trainer is None \
                or self._fit_result is None:
            return False
        if not policy.due(self._appends_since_refresh, age):
            return False
        refit = self._trainer.refit(self._fit_result, self._latest_problem)
        self.refresh(refit)
        return True

    @property
    def appends_since_refresh(self) -> int:
        return self._appends_since_refresh

    # ------------------------------------------------------------------ #
    # observability + lifecycle
    # ------------------------------------------------------------------ #

    def metrics(self) -> dict:
        """Engine health in one dict, riding the ``repro_torch.obs``
        registry: queue depth, per-bucket batch latency, end-to-end
        request latency, queue wait (kept separate from device time),
        compile/refresh counters, and the QPS window."""

        age = time.perf_counter() - self._t_last_refresh
        obs.gauge("engine_last_refresh_age_seconds").set(age)
        window = 0.0
        if self._t_first is not None and self._t_last is not None:
            window = self._t_last - self._t_first
        rate = (1.0 / window) if window > 0 else 0.0
        return {
            "queue_depth": self._worker.depth if self._worker else 0,
            "latency": obs.histogram("serve_request_seconds").summary(),
            "queue_wait": obs.histogram("queue_wait_seconds").summary(),
            "buckets": {
                b: obs.histogram("serve_batch_seconds",
                                 bucket=str(b)).summary()
                for b in self.ladder.sizes
            },
            "compiles": obs.counter("serve_compiles_total").value,
            "refreshes": obs.counter("engine_refreshes_total").value,
            "appends_since_refresh": self._appends_since_refresh,
            "last_refresh_age_seconds": age,
            "requests": self._served_requests,
            "users": self._served_users,
            "qps": self._served_requests * rate,
            "users_per_s": self._served_users * rate,
            "window_seconds": window,
        }

    def reset_metrics(self) -> None:
        """Zero the engine's QPS window (benches: call after warmup).
        Shared registry metrics reset separately via ``obs.reset()``."""

        self._t_first = self._t_last = None
        self._served_users = self._served_requests = 0

    def drain(self) -> None:
        """Block until every already-submitted request has resolved."""

        if self._worker is not None:
            self._worker.drain()

    def shutdown(self, drain: bool = True) -> None:
        """Reject new requests, finish (or cancel) the backlog, stop the
        worker thread; on a grid, rank 0 then broadcasts stop and the
        other ranks wait for it (within ``GRID_TIMEOUT``) and raise what
        their follower raised.  Idempotent."""

        if self._worker is not None:
            stop = None
            if self._grid and not self._stopped:
                stop = lambda: self._announce(_OP_STOP)  # noqa: E731
            self._stopped = True
            self._worker.shutdown(drain=drain, timeout=GRID_TIMEOUT,
                                  last=stop)
            return
        self._follower.join(GRID_TIMEOUT)
        if self._follower.is_alive():
            raise TimeoutError(
                f"rank {self._rank}: no stop from rank 0's engine within "
                f"{GRID_TIMEOUT:.0f} s")
        if self._failure is not None:
            raise RuntimeError(
                f"rank {self._rank}'s serving follower failed: "
                f"{self._failure!r}") from self._failure

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)
