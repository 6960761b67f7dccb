"""Top-k recommendation serving over completed gossip factors.

Port of the unsharded float32 half of ``repro.serve.recommend``.  After
training, ``assemble`` collapses the (p, q) block factors into global
U (m×r) and W (n×r); a batch of users is answered as

    scores   = U[user_batch] @ Wᵀ                   (B×n, one matmul)
    masked   = scores with each user's seen items at −inf
    items    = topk(masked, k)

The seen-item table is a padded (m, S) int32 ragged list; padding slots
hold ``n`` (one past the last item id) and land in a scratch column that
is cut off before the top-k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.assemble import assemble
from repro_torch.core.grid import GridSpec

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


def recommend_topk(index: RecommendIndex, user_ids, *, k: int,
                   exclude_seen: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(items, scores) of shape (B, k) for a batch of user ids."""

    n_items = index.num_items
    if k > n_items:
        raise ValueError(f"k={k} exceeds catalog size n={n_items}")
    user_ids = torch.as_tensor(user_ids, device=index.u.device).long()
    scores = index.u[user_ids] @ index.w.T                  # (B, n)
    if exclude_seen:
        # one scratch column takes the pad value n; it is cut off below
        scores = torch.nn.functional.pad(scores, (0, 1))
        scores.scatter_(1, index.seen[user_ids].long(), float("-inf"))
        scores = scores[:, :n_items]
    scores, items = torch.topk(scores, k)
    return items, scores
