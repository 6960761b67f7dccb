"""``ShardedEntries`` — a rank's tile of the sparse block store, ingested
owner-routed.

Port of ``repro.sparse.sharded``.  The JAX package keeps one global
``jax.Array`` whose shards sit on their owning devices; here each rank of
an R×C grid of ``torch.distributed`` ranks holds its own tile only: the
``SparseProblem`` over its (p/R, q/C) blocks, array for array what
``plan.local_slice`` cuts from the global store.

* :meth:`ShardedEntries.from_coo` keeps the triplets whose block this rank
  owns and packs only its tile (a lexsort of its own entries; the global
  (block, row, col) sort happens nowhere).  The one global quantity is the
  capacity E, from the (p, q) ``bincount`` of the whole list: every rank
  is handed the same list and computes it alike, so the reference's one
  global reduction needs no message.
* :meth:`ShardedEntries.append` routes an append the same way: dedupe
  last-write, keep this rank's entries, splice them into the tile with
  ``store.splice_entries``.  :func:`owner_entries` is the one routing rule
  (``CompletionProblem.append`` uses it on the dense layout too).
* :func:`sample_minibatch_sharded` is the tile of the 1×1 minibatch draw,
  so every grid sees the same entries a block.
* :func:`f_grads_sharded` is one launch of the f-gradient kernel over the
  tile's block stack (block-local math: the tile of the 1×1 gradients).

On a 1×1 plan the tile is the whole store.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.state import resolve_device
from repro_torch.mesh.plan import MeshPlan, plan_rank
from repro_torch.sparse import store as store_mod
from repro_torch.sparse.objective import f_grads_sparse
from repro_torch.sparse.store import (
    DEFAULT_BUCKET,
    SparseProblem,
    bucketed_capacity,
    dedupe_last_write,
)


def _triplets(rows, cols, vals):
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
        raise ValueError(
            f"rows/cols/vals must be equal-length 1-D arrays, got "
            f"{rows.shape}/{cols.shape}/{vals.shape}"
        )
    return rows, cols, vals


def _count_routed(plan: MeshPlan, shard: np.ndarray, only_touched: bool):
    """``ingest_routed_entries_total{shard="di,dj"}`` by owner, as the
    reference counts them (every shard at ingest, the touched ones at an
    append): a skewed ingest shows here before it shows as a straggler."""

    counts = np.bincount(shard, minlength=plan.num_devices)
    for k, c in enumerate(counts):
        if c or not only_touched:
            di, dj = plan.coords(k)
            obs.counter("ingest_routed_entries_total",
                        shard=f"{di},{dj}").inc(int(c))


def owner_entries(rows, cols, plan: MeshPlan, mb: int, nb: int, rank: int):
    """(mask of the entries rank ``rank`` owns, its tile's origin block):
    the one routing rule.  ``rows``/``cols`` are in the global padded
    frame; the owned ones, minus ``origin * (mb, nb)``, are in the tile's."""

    di, dj = plan.coords(rank)
    bpr, bpc = plan.blocks_per_row_shard, plan.blocks_per_col_shard
    keep = ((rows // mb) // bpr == di) & ((cols // nb) // bpc == dj)
    return keep, (di * bpr, dj * bpc)


@dataclasses.dataclass(frozen=True)
class ShardedEntries:
    """Rank ``rank``'s tile ``sp`` (its (p/R, q/C) blocks) of the store
    over ``plan``'s block grid."""

    sp: SparseProblem
    plan: MeshPlan
    rank: int = 0

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @classmethod
    def from_problem(cls, sp: SparseProblem, plan: MeshPlan,
                     rank: int | None = None) -> "ShardedEntries":
        """Cut an existing (global) store to this rank's tile.  ``rank``
        defaults to this process's rank in the process group."""

        p, q = sp.nnz.shape
        if (p, q) != (plan.p, plan.q):
            raise ValueError(
                f"store grid {p}x{q} does not match plan grid "
                f"{plan.p}x{plan.q}"
            )
        rank = plan_rank(plan) if rank is None else rank
        return cls(plan.local_slice(sp, rank), plan, rank)

    @classmethod
    def from_coo(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        m: int,
        n: int,
        plan: MeshPlan,
        bucket: int = DEFAULT_BUCKET,
        headroom: int = 0,
        rank: int | None = None,
        *,
        device="cuda",
    ) -> tuple["ShardedEntries", tuple[int, int]]:
        """Owner-routed ingest from the global COO triplet list: this
        rank's tile, packed from its own entries at the global store's
        capacity, on ``device``.  Returns it with the padded (M, N), as
        :func:`~repro_torch.sparse.store.from_entries` does."""

        device = resolve_device(device)
        rows, cols, vals = _triplets(rows, cols, vals)
        if len(rows) and (rows.min() < 0 or rows.max() >= m
                          or cols.min() < 0 or cols.max() >= n):
            raise ValueError(
                f"entry indices out of range for a {m}x{n} matrix: rows in "
                f"[{rows.min()}, {rows.max()}], cols in "
                f"[{cols.min()}, {cols.max()}]"
            )
        rank = plan_rank(plan) if rank is None else rank
        p, q = plan.p, plan.q
        mb = -(-m // p)
        nb = -(-n // q)
        bi, bj = rows // mb, cols // nb
        # the one global quantity: per-block counts -> shared capacity E
        nnz = np.bincount(bi * q + bj, minlength=p * q)
        E = bucketed_capacity(int(nnz.max()) if len(rows) else 0, bucket,
                              headroom)
        bpr, bpc = plan.blocks_per_row_shard, plan.blocks_per_col_shard
        _count_routed(plan, (bi // bpr) * plan.col_size + bj // bpc,
                      only_touched=False)
        keep, (oi, oj) = owner_entries(rows, cols, plan, mb, nb, rank)
        lrr, lcc = rows[keep] - oi * mb, cols[keep] - oj * nb
        blk = (lrr // mb) * bpc + lcc // nb       # tile-local block id
        lrr, lcc, lvv = lrr % mb, lcc % nb, vals[keep]
        order = np.lexsort((lcc, lrr, blk))       # this rank's entries only
        sp = store_mod._pack_sorted(
            blk[order], lrr[order], lcc[order], lvv[order], bpr, bpc, mb, nb,
            bucket, headroom, capacity=E, device=device)
        return cls(sp, plan, rank), (mb * p, nb * q)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    @property
    def capacity(self) -> int:
        return self.sp.capacity

    @property
    def nnz(self) -> torch.Tensor:
        """The tile's (p/R, q/C) per-block counts."""

        return self.sp.nnz

    def local(self) -> SparseProblem:
        """The tile this rank holds."""

        return self.sp

    # ------------------------------------------------------------------ #
    # streaming append — owner-routed
    # ------------------------------------------------------------------ #

    def append(self, rows, cols, vals) -> "ShardedEntries":
        """Splice this rank's share of new entries into its tile.

        ``rows``/``cols`` are global indices in the padded frame
        (p·mb × q·nb).  The semantics of the single-store
        :func:`~repro_torch.sparse.store.append_entries`: sorted splice,
        a pair already stored updates its value, last write wins within
        the batch, overflow raises with the headroom that would absorb it.
        Entries of other ranks' blocks are dropped here (their owners
        splice them); a rank with none returns ``self``."""

        rows, cols, vals = _triplets(rows, cols, vals)
        if len(rows) == 0:
            return self
        plan, sp = self.plan, self.sp
        mb, nb = sp.mb, sp.nb
        m, n = plan.p * mb, plan.q * nb
        if (rows.min() < 0 or rows.max() >= m
                or cols.min() < 0 or cols.max() >= n):
            raise ValueError(
                f"append indices out of range for the {m}x{n} padded grid: "
                f"rows in [{rows.min()}, {rows.max()}], cols in "
                f"[{cols.min()}, {cols.max()}]"
            )
        rows, cols, vals = dedupe_last_write(rows, cols, vals, n)
        bpr, bpc = plan.blocks_per_row_shard, plan.blocks_per_col_shard
        _count_routed(plan, (rows // mb // bpr) * plan.col_size
                      + cols // nb // bpc, only_touched=True)
        keep, (oi, oj) = owner_entries(rows, cols, plan, mb, nb, self.rank)
        if not keep.any():
            return self
        tile = store_mod.splice_entries(
            sp, rows[keep] - oi * mb, cols[keep] - oj * nb, vals[keep],
            (oi, oj))
        return dataclasses.replace(self, sp=tile)


def sample_minibatch_sharded(generator: torch.Generator,
                             sharded: ShardedEntries,
                             batch: int) -> SparseProblem:
    """This rank's tile of the uniform minibatch the 1×1 stream draws from
    ``generator``: the draw covers the whole grid (a block's positions
    depend only on the generator and its count), the rank keeps its
    blocks' and assembles them from its tile."""

    pos = store_mod.sample_positions(generator, sharded.sp.nnz, batch,
                                     sharded.plan, sharded.rank)
    return store_mod.assemble_minibatch(sharded.sp, pos)


def f_grads_sharded(sharded: ShardedEntries, U, W, *,
                    method: str = "segment", chunk: int | None = None):
    """(gU_f, gW_f) of the data-fit term over the tile, where the data
    lives: one launch of the f-gradient kernel over the tile's block
    stack (the plain version on CPU tensors).  ``U``/``W`` are the tile's
    factors or the global (p, q, ...) stacks, which are cut to the tile.
    Block-local math: the result is the tile of the global gradients."""

    U = sharded.plan.local_slice(U, sharded.rank)
    W = sharded.plan.local_slice(W, sharded.rank)
    _, gu, gw = f_grads_sparse(sharded.sp.entries, U, W, method=method,
                               chunk=chunk)
    return gu, gw
