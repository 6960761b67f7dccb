"""Deterministic synthetic datasets (the port's copy of
``repro.data.synthetic``).

* ``lowrank_problem`` — the paper's synthetic setup: a rank-r matrix,
  majority of entries masked for training, a held-out test set drawn from
  the masked remainder.
* ``movielens_proxy`` — offline stand-in for the MovieLens/Netflix tables:
  low-rank user/item structure + noise + long-tail popularity sampling at a
  requested ratings count, 80/20 split, ratings clipped to [1,5].
* ``LMTokenPipeline`` — seeded, stateless (step -> batch) token stream for
  LM training; numpy only, so its batches are the JAX package's bit for
  bit.

Everything is numpy + explicit seeds; nothing touches the network.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MCDataset:
    x: np.ndarray            # (m, n) ground truth (train entries only valid if sparse source)
    train_mask: np.ndarray   # (m, n) float 0/1
    test_rows: np.ndarray    # (k,)
    test_cols: np.ndarray
    test_vals: np.ndarray


def lowrank_problem(
    m: int,
    n: int,
    r: int,
    density: float = 0.2,
    test_fraction: float = 0.05,
    noise: float = 0.0,
    seed: int = 0,
) -> MCDataset:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, r)).astype(np.float32)
    b = rng.standard_normal((n, r)).astype(np.float32)
    x = a @ b.T
    if noise:
        x = x + noise * rng.standard_normal(x.shape).astype(np.float32)
    u = rng.random((m, n))
    train_mask = (u < density).astype(np.float32)
    # test set: masked entries not used for training
    test_pool = (u >= density) & (u < density + test_fraction)
    tr, tc = np.nonzero(test_pool)
    return MCDataset(x, train_mask, tr, tc, x[tr, tc])


def movielens_proxy(
    num_users: int = 6040,
    num_items: int = 3706,
    num_ratings: int = 1_000_000,
    r_true: int = 12,
    noise: float = 0.5,
    seed: int = 0,
) -> MCDataset:
    """MovieLens-scale proxy: long-tail item popularity, user bias/activity,
    ratings clipped to [1,5].  DESIGN.md §9 documents why (offline box)."""

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((num_users, r_true)).astype(np.float32) / np.sqrt(r_true)
    b = rng.standard_normal((num_items, r_true)).astype(np.float32)
    user_bias = 0.3 * rng.standard_normal(num_users).astype(np.float32)
    item_bias = 0.5 * rng.standard_normal(num_items).astype(np.float32)
    # long-tail popularity (zipf-ish) for items; activity for users
    item_p = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_p /= item_p.sum()
    user_p = 1.0 / np.arange(1, num_users + 1) ** 0.6
    user_p /= user_p.sum()
    item_perm = rng.permutation(num_items)
    user_perm = rng.permutation(num_users)

    num_ratings = min(num_ratings, num_users * num_items // 2)
    rows = user_perm[rng.choice(num_users, 2 * num_ratings, p=user_p)]
    cols = item_perm[rng.choice(num_items, 2 * num_ratings, p=item_p)]
    # dedupe (keep first occurrence)
    lin = rows.astype(np.int64) * num_items + cols
    _, first = np.unique(lin, return_index=True)
    first = np.sort(first)[:num_ratings]
    rows, cols = rows[first], cols[first]

    raw = (
        3.5
        + np.einsum("kr,kr->k", a[rows], b[cols])
        + user_bias[rows]
        + item_bias[cols]
        + noise * rng.standard_normal(len(rows)).astype(np.float32)
    )
    vals = np.clip(np.round(raw * 2) / 2, 1.0, 5.0).astype(np.float32)

    # 80/20 split
    perm = rng.permutation(len(rows))
    cut = int(0.8 * len(rows))
    tr_idx, te_idx = perm[:cut], perm[cut:]
    x = np.zeros((num_users, num_items), np.float32)
    mask = np.zeros((num_users, num_items), np.float32)
    x[rows[tr_idx], cols[tr_idx]] = vals[tr_idx]
    mask[rows[tr_idx], cols[tr_idx]] = 1.0
    return MCDataset(x, mask, rows[te_idx], cols[te_idx], vals[te_idx])


def load_movielens_csv(path: str, test_fraction: float = 0.2, seed: int = 0) -> MCDataset:
    """Real-data path (user,item,rating[,ts] CSV) when a dataset is present."""

    raw = np.loadtxt(path, delimiter=",", usecols=(0, 1, 2))
    users = raw[:, 0].astype(np.int64)
    items = raw[:, 1].astype(np.int64)
    vals = raw[:, 2].astype(np.float32)
    _, users = np.unique(users, return_inverse=True)
    _, items = np.unique(items, return_inverse=True)
    m, n = users.max() + 1, items.max() + 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(vals))
    cut = int((1 - test_fraction) * len(vals))
    tr, te = perm[:cut], perm[cut:]
    x = np.zeros((m, n), np.float32)
    mask = np.zeros((m, n), np.float32)
    x[users[tr], items[tr]] = vals[tr]
    mask[users[tr], items[tr]] = 1.0
    return MCDataset(x, mask, users[te], items[te], vals[te])


class LMTokenPipeline:
    """Stateless synthetic token stream: ``batch_at(step) -> (tokens,
    targets)``.

    Tokens follow a power-law unigram distribution with short-range
    structure (Markov-ish mixing) so losses move realistically.  Because
    batches are a pure function of (seed, step), checkpoint restart resumes
    the exact stream.
    """

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks**1.1
        self._p = p / p.sum()

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(
            self.vocab_size, size=(self.batch, self.seq_len + 1), p=self._p
        ).astype(np.int32)
        # short-range structure: every 4th token repeats its predecessor
        toks[:, 3::4] = toks[:, 2::4][:, : toks[:, 3::4].shape[1]]
        return toks[:, :-1], toks[:, 1:]
