"""Top-k recommendation serving over completed gossip factors.

Port of ``repro.serve.recommend``.  After training, ``assemble``
collapses the (p, q) block factors into global U (m×r) and W (n×r); a
batch of users is answered as

    scores   = U[user_batch] @ Wᵀ                   (B×n, one matmul)
    masked   = scores with each user's seen items at −inf
    items    = topk(masked, k)

The seen-item table is a padded (m, S) int32 ragged list; padding slots
hold ``n`` (one past the last item id) and land in a scratch column that
is cut off before the top-k.  The top-k keeps ``jax.lax.top_k``'s order
(:func:`topk_ordered`): score descending, ties to the lower item id.

**Catalogs over a rank grid** (``shard_index`` + a ``MeshPlan``): each
rank holds one contiguous slice of the item axis, padded to a multiple of
the shard count, while ``u`` and the seen table stay whole.  The top-k
runs in two stages: each rank selects k over its own items (seen items
and padding masked on the global ids in its range), then one
``all_gather`` brings every rank's k candidates and one more selection
merges them.  The merge is exact: a global top-k item is in its own
shard's top-k.

**int8 serving**: every query here also takes a
``QuantizedRecommendIndex`` (serve/quant.py — int8 codes + per-row f32
scales); scoring then goes through ``kernels/quant.dequant_score``
(``method="fused"|"dequant"``, ``None`` = per device: the hand-written
kernel on the card).  ``RecommendService`` adds fixed-batch chunking and
hot refresh in front of ``recommend_topk``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.assemble import assemble
from repro_torch.core.gossip import host_collectives
from repro_torch.core.grid import GridSpec
from repro_torch.kernels.quant import dequant_score
from repro_torch.mesh.plan import MeshPlan, plan_rank
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


def _keyed_topk(scores: torch.Tensor, k: int, ids) -> torch.Tensor:
    """Positions of :func:`topk_ordered` by one ``torch.topk`` over int64
    keys: the high word is the score's bits made monotone as a signed
    integer, the low word 2³² − 1 − id."""

    bits = scores.view(torch.int32)
    key32 = bits >> 31                     # -1 for negative floats, else 0
    key32 &= 0x7FFFFFFF
    key32 ^= bits                          # monotone in the float's order
    key = key32.to(torch.int64)
    del key32
    key <<= 32
    if ids is None:
        ids = torch.arange(scores.shape[-1], device=scores.device)
    key |= 0xFFFFFFFF - ids.to(torch.int64)
    return torch.topk(key, k).indices


def topk_ordered(scores: torch.Tensor, k: int, ids=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k best entries of each row of the
    (B, n) f32 ``scores``, in ``jax.lax.top_k``'s order: score descending
    in the total order of f32 (NaN above +inf, +0 above −0), ties to the
    lower id.  ``ids`` ((n,) or (B, n) int, below 2³²) are the tie keys,
    the column positions by default; ``torch.topk`` alone breaks ties in
    no fixed order.

    One ``torch.topk`` of the floats, k + 1 wide (it ranks NaN above
    everything), answers every row whose k + 1 best values strictly
    decrease: the k are then distinct and above all others.  Only the
    other rows (a tie inside the k or at its boundary, ±0 side by side, a
    NaN) are selected again by :func:`_keyed_topk`."""

    vals, pos = torch.topk(scores, min(k + 1, scores.shape[-1]))
    # a tie, ±0 side by side or a NaN (no comparison holds) fails it
    strict = vals[:, 1:] < vals[:, :-1]
    vals, pos = vals[:, :k], pos[:, :k]
    if not bool(strict.all()):          # one host sync, the rows only then
        rows = (~strict.all(1)).nonzero().squeeze(1)
        row_ids = ids[rows] if ids is not None and ids.dim() == 2 else ids
        pos[rows] = _keyed_topk(scores[rows], k, row_ids)
        vals = scores.gather(-1, pos)
    return vals, pos


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
    scores, items = topk_ordered(scores, k)
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


# ---------------------------------------------------------------------- #
# item-axis-sharded serving: per-shard k-select + exact merge
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShardedRecommendIndex:
    """Rank ``rank``'s shard of a ``RecommendIndex`` over ``plan``.

    ``index`` holds this rank's contiguous slice of the item axis, padded
    with zero rows to ``shard_items`` (the catalog padded to a multiple of
    the shard count, divided by it), and the whole ``u`` and seen table.
    ``num_items`` is the true catalog size; padding rows are masked inside
    the query.  ``index`` may be the int8 twin
    (``QuantizedRecommendIndex``): the codes shard like W and the
    per-item scales beside them, and per-row scales make each shard's
    codes exactly the global ones."""

    index: object                # RecommendIndex | QuantizedRecommendIndex
    plan: MeshPlan
    num_items: int
    rank: int = 0

    @property
    def quantized(self) -> bool:
        return isinstance(self.index, QuantizedRecommendIndex)

    @property
    def num_item_shards(self) -> int:
        return self.plan.num_item_shards

    @property
    def shard_items(self) -> int:
        """Items held by each rank (padded width / shard count)."""

        return self.index.num_items

    @property
    def start(self) -> int:
        """The global id of this shard's first item."""

        return self.rank * self.shard_items

    def refresh(self, fit_result) -> "ShardedRecommendIndex":
        """This rank's shard of a (re)fit's index, in the same layout (an
        int8 shard re-quantizes the fresh factors).  The refit must keep
        the item-shard count and the factor shapes."""

        fit_plan = getattr(getattr(fit_result, "problem", None), "plan", None)
        if fit_plan is not None and \
                fit_plan.num_item_shards != self.num_item_shards:
            raise ValueError(
                f"refresh changes the item-shard count: this index serves "
                f"{self.num_items} items over {self.num_item_shards} shards "
                f"({self.shard_items} items/shard), the refit's MeshPlan has "
                f"{fit_plan.num_item_shards} shards; rebuild the serving "
                f"side with shard_index(new_index, new_plan) / "
                f"RecommendService(index, plan=new_plan) instead of refresh"
            )
        new = fit_result.to_recommend_index()
        expected = (_u_shape(self.index), (self.num_items,
                                           _w_shape(self.index)[1]))
        got = (tuple(new.u.shape), tuple(new.w.shape))
        if expected != got:
            raise ValueError(
                f"refresh changes the factor shapes: expected "
                f"u{expected[0]} x w{expected[1]}"
                f"{' (int8 layout)' if self.quantized else ''}, got "
                f"u{got[0]} x w{got[1]}; a re-shaped problem needs a new "
                f"shard_index, not a refresh"
            )
        if self.quantized:
            new = quantize_index(new)
        return shard_index(new, self.plan, self.rank)


def _pad_items(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad an item-axis tensor (codes, factors or scales) to
    ``n_pad`` rows; padded rows are masked at query time."""

    pad = n_pad - a.shape[0]
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])


def shard_index(index, plan: MeshPlan, rank: int | None = None
                ) -> ShardedRecommendIndex:
    """Rank ``rank``'s shard (default: this process's) of an index's item
    axis over every rank of ``plan``: the axis zero-padded to
    n_pad = ⌈n/S⌉·S and cut to the rank's contiguous
    ``plan.item_slice``, as contiguous tensors (the score kernel takes no
    others); ``u`` and the seen table stay whole.  A quantized index
    shards the codes and the per-item scales the same way.  On a 1-rank
    plan the shard is the whole index, and the two-stage query answers
    bitwise as ``recommend_topk`` does."""

    if not isinstance(plan, MeshPlan):
        raise TypeError(f"plan must be a MeshPlan, got {type(plan).__name__}")
    S = plan.num_item_shards
    n = index.num_items
    n_pad = -(-n // S) * S
    rank = plan_rank(plan) if rank is None else rank
    sl = plan.item_slice(rank, n_pad)

    def cut(a):
        return _pad_items(a[sl], sl.stop - sl.start).contiguous()

    if isinstance(index, QuantizedRecommendIndex):
        placed = index._replace(w_q=cut(index.w_q),
                                w_scale=cut(index.w_scale))
    else:
        placed = index._replace(w=cut(index.w))
    return ShardedRecommendIndex(placed, plan, n, rank)


def _gather_candidates(scores: torch.Tensor, ids: torch.Tensor, S: int,
                       group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (B, k) scores and ids side by side in rank order,
    (B, S·k) each: one ``all_gather`` over ``group`` of both packed as
    int64 (the scores' bits exactly), through host tensors where the
    group's backend takes no card tensors."""

    k = scores.shape[1]
    packed = torch.cat([scores.view(torch.int32).to(torch.int64), ids], 1)
    if host_collectives(packed.device, group):
        packed = packed.cpu()
    parts = [torch.empty_like(packed) for _ in range(S)]
    dist.all_gather(parts, packed, group=group)
    parts = [x.to(scores.device) for x in parts]
    all_sc = torch.cat([x[:, :k] for x in parts], 1)
    all_ids = torch.cat([x[:, k:] for x in parts], 1)
    return all_sc.to(torch.int32).view(torch.float32), all_ids


def recommend_topk_sharded(
    sidx: ShardedRecommendIndex, user_ids, *, k: int,
    exclude_seen: bool = True, method: str | None = None, group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(items, scores) of shape (B, k) from the sharded index, on every
    rank of the plan (a collective over ``group``, the default group if
    ``None``: every rank calls it with the same users).

    Stage 1 on this rank's shard: scores ``u[ids] @ w_localᵀ`` (f32) or
    through ``dequant_score`` (int8; the hand-written kernel on the card),
    padding ids and the users' seen items in this shard's range at −inf,
    then k best in the reference's order (:func:`topk_ordered`).  Stage 2:
    one ``all_gather`` of every shard's k (scores, global ids), merged to
    k, ties to the lower id (the reference's: ties go to the lower shard).
    Exact: any global top-k item is in its own shard's top-k."""

    if k > sidx.shard_items:
        raise ValueError(
            f"k={k} exceeds the per-shard catalog slice "
            f"{sidx.shard_items} (= {sidx.shard_items * sidx.num_item_shards}"
            f" padded items / {sidx.num_item_shards} shards); shrink k or "
            f"use fewer shards"
        )
    index = sidx.index
    ln, start = sidx.shard_items, sidx.start
    user_ids = torch.as_tensor(user_ids, device=index.seen.device).long()
    scores = _batch_scores(index, user_ids, method)          # (B, ln)
    real = min(ln, max(0, sidx.num_items - start))
    if real < ln:
        scores[:, real:] = float("-inf")                     # padding ids
    if exclude_seen:
        # seen ids outside this shard's range go to one scratch column
        seen = index.seen[user_ids].long() - start
        seen = torch.where((seen >= 0) & (seen < ln), seen, ln)
        scores = torch.nn.functional.pad(scores, (0, 1))
        scores.scatter_(1, seen, float("-inf"))
        scores = scores[:, :ln]
    sc, pos = topk_ordered(scores, k)                        # stage 1
    ids = pos + start
    S = sidx.num_item_shards
    if S > 1:
        sc, ids = _gather_candidates(sc, ids, S, group)
    msc, mix = topk_ordered(sc, k, ids)                      # stage 2
    return ids.gather(1, mix), msc


class RecommendService:
    """Fixed-batch front end: chunk arbitrary user lists into
    ``batch``-sized ``recommend_topk`` calls (tail padded with user 0), on
    the device the index lives on.

    ``plan=`` (a ``MeshPlan``) shards the catalog's item axis over the
    plan's ranks with the two-stage top-k (``recommend_topk_sharded``);
    the front-end contract is unchanged, and the service keeps only its
    rank's shard (``self.index`` is ``None``).  On a plan of more than one
    rank it is collective: every rank calls ``recommend`` and ``refresh``
    with the same arguments, in the same order.

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
                 exclude_seen: bool = True, plan=None,
                 quant: str | None = None, quant_method: str | None = None):
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
        self.plan = plan
        self.quant = quant
        self.quant_method = quant_method
        if plan is not None:
            self._sharded = shard_index(index, plan)
            self.index = None     # the catalog lives only as shards
        else:
            self._sharded = None
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
        if self._sharded is not None:
            return self._sharded.index.num_users
        return self.index.num_users

    @property
    def num_items(self) -> int:
        if self._sharded is not None:
            return self._sharded.num_items
        return self.index.num_items

    @property
    def num_item_shards(self) -> int:
        """Ranks the catalog is partitioned over (1 when unsharded)."""

        return self._sharded.num_item_shards if self._sharded else 1

    def refresh(self, fit_result) -> "RecommendService":
        """Hot-swap the index from a (re)fit: same batch and k, new
        factors + seen table (re-quantized on an int8 service; re-sharded,
        with the shard count and factor shapes checked, on a sharded one).
        A call in flight keeps the index it started with.  Returns
        ``self``."""

        if self._sharded is not None:
            self._sharded = self._sharded.refresh(fit_result)
        else:
            self.index = self.index.refresh(fit_result)
        return self

    def recommend(self, user_ids) -> tuple[np.ndarray, np.ndarray]:
        """(items, scores) arrays of shape (len(user_ids), k)."""

        user_ids = np.asarray(user_ids, np.int32)
        n = len(user_ids)
        out_items = np.empty((n, self.k), np.int32)
        out_scores = np.empty((n, self.k), np.float32)
        # one snapshot: a refresh never splits a call
        index, sharded = self.index, self._sharded
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
            query = (recommend_topk if sharded is None
                     else recommend_topk_sharded)
            items, scores = query(
                index if sharded is None else sharded, chunk, k=self.k,
                exclude_seen=self.exclude_seen, method=self.quant_method,
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
