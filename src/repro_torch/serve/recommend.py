"""Top-k recommendation serving over completed gossip factors.

Port of the unsharded half of ``repro.serve.recommend``.  After training,
``assemble`` collapses the (p, q) block factors into global U (m×r) and
W (n×r); a batch of users is answered as

    scores   = U[user_batch] @ Wᵀ                   (B×n, one matmul)
    masked   = scores with each user's seen items at −inf
    items    = topk(masked, k)

The seen-item table is a padded (m, S) int32 ragged list; padding slots
hold ``n`` (one past the last item id) and land in a scratch column that
is cut off before the top-k.

**int8 serving**: every query here also takes a
``QuantizedRecommendIndex`` (serve/quant.py — int8 codes + per-row f32
scales); scoring then goes through ``kernels/quant.dequant_score``
(``method="fused"|"dequant"``, ``None`` = per device: the hand-written
kernel on the card).  ``RecommendService`` adds fixed-batch chunking and
hot refresh in front of ``recommend_topk``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.assemble import assemble
from repro_torch.core.grid import GridSpec
from repro_torch.kernels.quant import dequant_score
from repro_torch.serve.quant import QuantizedRecommendIndex, quantize_index

_SEEN_PAD_QUANTUM = 16


class RecommendIndex(NamedTuple):
    """Immutable serving state (on the factors' device)."""

    u: torch.Tensor      # (m, r) float32 — user factors
    w: torch.Tensor      # (n, r) float32 — item factors
    seen: torch.Tensor   # (m, S) int32 — items to exclude; pad value == n

    @property
    def num_users(self) -> int:
        return self.u.shape[0]

    @property
    def num_items(self) -> int:
        return self.w.shape[0]

    @property
    def rank(self) -> int:
        return self.u.shape[1]

    def refresh(self, fit_result) -> "RecommendIndex":
        """Rebuild from a (re)fit without a serving restart: new factors
        plus the updated seen-item table.  The index is immutable; swap
        the returned value in (``RecommendService.refresh`` does).  The
        catalog and user counts must match."""

        new = fit_result.to_recommend_index()
        if new.u.shape != self.u.shape or new.w.shape != self.w.shape:
            raise ValueError(
                f"refresh changes the factor shapes: expected "
                f"u{tuple(self.u.shape)} x w{tuple(self.w.shape)}, got "
                f"u{tuple(new.u.shape)} x w{tuple(new.w.shape)}; a "
                f"re-shaped problem needs a new build_index, not a refresh"
            )
        return new


def build_seen_table_coo(rows: np.ndarray, cols: np.ndarray,
                         num_users: int, num_items: int) -> np.ndarray:
    """Padded per-user seen-item lists straight from COO (user, item) pairs;
    never materializes an (m, n) mask.  Pairs must be sorted by user
    (np.nonzero order qualifies).  Pad value is ``num_items``."""

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) and np.any(np.diff(rows) < 0):
        raise ValueError(
            "build_seen_table_coo needs user-sorted pairs; sort with "
            "order = np.argsort(rows, kind='stable') first"
        )
    keep = cols < num_items                       # drop grid-padding columns
    rows, cols = rows[keep], cols[keep]
    counts = np.bincount(rows, minlength=num_users)
    S = int(counts.max()) if len(rows) else 0
    S = max(_SEEN_PAD_QUANTUM,
            (S + _SEEN_PAD_QUANTUM - 1) // _SEEN_PAD_QUANTUM * _SEEN_PAD_QUANTUM)
    seen = np.full((num_users, S), num_items, np.int32)
    # user-sorted pairs: entries of user u occupy the contiguous range
    # [starts[u], starts[u]+counts[u])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    seen[rows, np.arange(len(rows)) - starts[rows]] = cols
    return seen


def build_seen_table(train_mask: np.ndarray, num_items: int) -> np.ndarray:
    """Padded per-user seen-item lists from a 0/1 mask."""

    mask = np.asarray(train_mask)
    rows, cols = np.nonzero(mask[:, :num_items])  # row-major == user-sorted
    return build_seen_table_coo(rows, cols, mask.shape[0], num_items)


def build_index(
    U: torch.Tensor,
    W: torch.Tensor,
    spec: GridSpec,
    train_mask: np.ndarray | None = None,
    num_users: int | None = None,
    num_items: int | None = None,
    seen_coo: tuple[np.ndarray, np.ndarray] | None = None,
) -> RecommendIndex:
    """Assemble block factors and attach the seen-item exclusion table.

    ``num_users``/``num_items`` trim grid padding back to the true matrix
    shape.  The exclusion table comes from a 0/1 ``train_mask`` or from
    user-sorted ``seen_coo = (user_ids, item_ids)`` pairs."""

    u, w = assemble(U, W, spec)
    m = num_users if num_users is not None else spec.m
    n = num_items if num_items is not None else spec.n
    u = u[:m].float().contiguous()
    w = w[:n].float().contiguous()
    if train_mask is not None:
        seen = build_seen_table(np.asarray(train_mask)[:m], n)
    elif seen_coo is not None:
        seen = build_seen_table_coo(seen_coo[0], seen_coo[1], m, n)
    else:
        seen = np.full((m, _SEEN_PAD_QUANTUM), n, np.int32)
    return RecommendIndex(u, w, torch.from_numpy(seen).to(u.device))


def _batch_scores(index, user_ids, method):
    """(B, n) scores for either index layout — the one scoring switch."""

    if isinstance(index, QuantizedRecommendIndex):
        return dequant_score(index.u_q[user_ids], index.u_scale[user_ids],
                             index.w_q, index.w_scale, method=method)
    return index.u[user_ids] @ index.w.T


def recommend_topk(index, user_ids, *, k: int, exclude_seen: bool = True,
                   method: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(items, scores) of shape (B, k) for a batch of user ids.

    ``index`` is a ``RecommendIndex`` or its int8 twin
    (``QuantizedRecommendIndex``); ``method`` picks the quantized scoring
    path (``"fused"``/``"dequant"``, ``None`` = per device —
    ``kernels/quant``) and is ignored for f32 indices."""

    n_items = index.num_items
    if k > n_items:
        raise ValueError(f"k={k} exceeds catalog size n={n_items}")
    user_ids = torch.as_tensor(user_ids, device=index.seen.device).long()
    scores = _batch_scores(index, user_ids, method)         # (B, n)
    if exclude_seen:
        # one scratch column takes the pad value n; it is cut off below
        scores = torch.nn.functional.pad(scores, (0, 1))
        scores.scatter_(1, index.seen[user_ids].long(), float("-inf"))
        scores = scores[:, :n_items]
    scores, items = torch.topk(scores, k)
    return items, scores


def score_pairs(index, user_ids, item_ids) -> torch.Tensor:
    """Pointwise predicted ratings for explicit (user, item) pairs."""

    dev = index.seen.device
    user_ids = torch.as_tensor(user_ids, device=dev).long()
    item_ids = torch.as_tensor(item_ids, device=dev).long()
    if isinstance(index, QuantizedRecommendIndex):
        # the int32 products sum to int64 in torch; the value is the same
        dots = (index.u_q[user_ids].int() * index.w_q[item_ids].int()
                ).sum(dim=-1).float()
        return dots * index.u_scale[user_ids] * index.w_scale[item_ids]
    return (index.u[user_ids] * index.w[item_ids]).sum(dim=-1)


def _u_shape(index) -> tuple:
    return tuple((index.u_q if isinstance(index, QuantizedRecommendIndex)
                  else index.u).shape)


def _w_shape(index) -> tuple:
    return tuple((index.w_q if isinstance(index, QuantizedRecommendIndex)
                  else index.w).shape)


class RecommendService:
    """Fixed-batch front end: chunk arbitrary user lists into
    ``batch``-sized ``recommend_topk`` calls (tail padded with user 0), on
    the device the index lives on.

    ``quant="int8"`` quantizes the index to the int8 serving layout
    (serve/quant.py) and ``refresh`` re-quantizes on every hot swap;
    ``quant_method`` picks the scoring path (``"fused"``/``"dequant"``,
    ``None`` = per device).

    Every ``recommend`` call streams into the ``repro_torch.obs``
    registry: ``serve_batch_seconds`` (latency per batch; the host copy
    of the answer waits for the card, so the stamp is device-true),
    ``queue_wait_seconds`` (how long each chunk sat behind earlier chunks
    of the same call), ``serve_requests_total`` / ``serve_users_total`` /
    ``serve_batches_total``.  The first batch pays the one-time costs
    (kernel library load, cuBLAS and allocator warm-up), so it lands in
    ``serve_warmup_seconds`` + ``serve_warmup_batches_total`` instead.
    ``metrics()`` summarizes it all into p50/p99 latency and QPS."""

    def __init__(self, index, batch: int = 256, k: int = 10,
                 exclude_seen: bool = True, quant: str | None = None,
                 quant_method: str | None = None):
        if quant not in (None, "int8"):
            raise ValueError(
                f"unknown quant mode {quant!r}; expected None or 'int8'"
            )
        if isinstance(index, QuantizedRecommendIndex):
            quant = "int8"        # already-quantized input implies the mode
        elif quant == "int8":
            index = quantize_index(index)
        self.batch = batch
        self.k = k
        self.exclude_seen = exclude_seen
        self.quant = quant
        self.quant_method = quant_method
        self.index = index
        # first/last answer stamps bound the QPS window
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._served_users = 0
        self._served_requests = 0
        # sticky across reset_metrics: the one-time costs are paid once
        self._warm = False

    @property
    def num_users(self) -> int:
        return self.index.num_users

    @property
    def num_items(self) -> int:
        return self.index.num_items

    def refresh(self, fit_result) -> "RecommendService":
        """Hot-swap the index from a (re)fit: same batch and k, new
        factors + seen table (re-quantized on an int8 service).  A call
        in flight keeps the index it started with.  Returns ``self``."""

        self.index = self.index.refresh(fit_result)
        return self

    def recommend(self, user_ids) -> tuple[np.ndarray, np.ndarray]:
        """(items, scores) arrays of shape (len(user_ids), k)."""

        user_ids = np.asarray(user_ids, np.int32)
        n = len(user_ids)
        out_items = np.empty((n, self.k), np.int32)
        out_scores = np.empty((n, self.k), np.float32)
        index = self.index    # one snapshot: a refresh never splits a call
        lat_h = obs.histogram("serve_batch_seconds")
        t_enter = time.perf_counter()
        if self._t_first is None:
            self._t_first = t_enter
        for s in range(0, n, self.batch):
            t0 = time.perf_counter()
            obs.histogram("queue_wait_seconds").observe(t0 - t_enter)
            chunk = user_ids[s : s + self.batch]
            pad = self.batch - len(chunk)
            if pad:
                chunk = np.pad(chunk, (0, pad))
            items, scores = recommend_topk(
                index, chunk, k=self.k, exclude_seen=self.exclude_seen,
                method=self.quant_method,
            )
            take = min(self.batch, n - s)
            # the host copies wait for the card: a device-true stamp
            out_items[s : s + take] = items.cpu().numpy()[:take]
            out_scores[s : s + take] = scores.cpu().numpy()[:take]
            dt = time.perf_counter() - t0
            if self._warm:
                lat_h.observe(dt)
            else:
                obs.histogram("serve_warmup_seconds").observe(dt)
                obs.counter("serve_warmup_batches_total").inc()
                self._warm = True
            obs.counter("serve_batches_total").inc()
        self._t_last = time.perf_counter()
        self._served_users += n
        self._served_requests += 1
        obs.counter("serve_requests_total").inc()
        obs.counter("serve_users_total").inc(n)
        return out_items, out_scores

    def reset_metrics(self) -> None:
        """Zero this service's request/QPS window (the shared ``serve_*``
        registry metrics reset separately with ``obs.reset()``)."""

        self._t_first = self._t_last = None
        self._served_users = self._served_requests = 0

    def metrics(self) -> dict:
        """Latency/throughput summary of everything served so far:
        ``latency`` is the ``serve_batch_seconds`` summary (seconds per
        batch, warm-up excluded; the first batch reports under
        ``warmup``), ``queue_wait`` the host-side chunk wait, ``qps`` and
        ``users_per_s`` the served totals over the first-to-last answer
        window."""

        window = 0.0
        if self._t_first is not None and self._t_last is not None:
            window = self._t_last - self._t_first
        rate = (1.0 / window) if window > 0 else 0.0
        return {
            "latency": obs.histogram("serve_batch_seconds").summary(),
            "queue_wait": obs.histogram("queue_wait_seconds").summary(),
            "warmup": {
                "batches": obs.counter("serve_warmup_batches_total").value,
                "seconds": obs.histogram("serve_warmup_seconds").summary(),
            },
            "requests": self._served_requests,
            "users": self._served_users,
            "qps": self._served_requests * rate,
            "users_per_s": self._served_users * rate,
            "window_seconds": window,
        }
