"""``CompletionProblem`` — the one noun that owns matrix-completion data.

Port of ``repro.mc.problem``: blockified data (dense ``Problem`` or the
sparse ``SparseProblem`` store) on one device, the ``GridSpec`` and the
engine options, built once and handed to ``Trainer.fit`` with any
schedule::

    problem = CompletionProblem.from_dense(x, mask, p=4, q=4, rank=8,
                                           layout="sparse")
    problem = CompletionProblem.from_entries(rows, cols, vals, shape=(m, n),
                                             p=4, q=4, rank=8)
    problem = CompletionProblem.from_dataset(ds, p=4, q=4, rank=8)

The constructors put the data on ``device="cuda"`` unless asked for the
CPU; without a card that default raises.  ``plan=`` (a ``MeshPlan`` over a
grid of ``torch.distributed`` ranks) keeps only this rank's tile of the
blocks; the ``Gossip`` schedule runs on it.  ``from_entries(plan=)`` on the
sparse layout ingests owner-routed (``sparse.ShardedEntries.from_coo``:
each rank packs only its tile, the global store is never built); the
dense constructors cut the tile from the global data.  ``append`` splices
new ratings in (the streaming ingestion path, owner-routed under a plan)
and returns a new problem.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import gossip as core_gossip
from repro_torch.core import grid as G
from repro_torch.core import waves as core_waves
from repro_torch.core.state import (Problem, State, make_problem,
                                    resolve_device)
from repro_torch.data.synthetic import MCDataset
from repro_torch.mesh.plan import MeshPlan, plan_rank
from repro_torch.sparse import store
from repro_torch.sparse.sharded import ShardedEntries, owner_entries
from repro_torch.sparse.store import SparseProblem


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """How gradients are computed — orthogonal to what is computed.

    method   : "segment" (sorted CSR/CSC segment sums, default) | "scatter"
    chunk    : segment-reduce chunk size of the CPU path (None = SEG_CHUNK);
               the CUDA kernels do not read it
    bucket   : padded-COO capacity quantum for sparse ingest
    headroom : per-block slack pre-allocated at sparse ingest
    """

    method: str = "segment"
    chunk: Optional[int] = None
    bucket: int = store.DEFAULT_BUCKET
    headroom: int = 0

    def __post_init__(self) -> None:
        if self.method not in ("segment", "scatter"):
            raise ValueError(
                f"unknown method {self.method!r}; 'segment' or 'scatter'"
            )
        if self.chunk is not None and self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if self.bucket <= 0:
            raise ValueError(f"bucket must be positive, got {self.bucket}")
        if self.headroom < 0:
            raise ValueError(
                f"headroom must be non-negative, got {self.headroom}"
            )


def _place(data, p: int, q: int, plan, device):
    """(plan, this rank's tile of ``data`` on ``device``): the ingest-side
    placement hook.  ``plan=None`` keeps every block."""

    if plan is None:
        return None, _to(data, device)
    plan = MeshPlan.build(p, q, plan)
    return plan, _to(plan.local_slice(data, plan_rank(plan)), device)


def _scatter_dense(data: Problem, rows, cols, vals, mb: int,
                   nb: int) -> Problem:
    """Fresh block tensors with the entries written in (tile frame)."""

    dev = data.xb.device
    bi, rr = (torch.from_numpy(a).to(dev) for a in divmod(rows, mb))
    bj, cc = (torch.from_numpy(a).to(dev) for a in divmod(cols, nb))
    xb, maskb = data.xb.clone(), data.maskb.clone()
    xb[bi, bj, rr, cc] = torch.from_numpy(vals).to(dev)
    maskb[bi, bj, rr, cc] = 1.0
    return Problem(xb, maskb)


def _to(data, device):
    parts = [None if f is None else
             (_to(f, device) if isinstance(f, tuple) else f.to(device))
             for f in data]
    return type(data)(*parts)


@dataclasses.dataclass(frozen=True)
class CompletionProblem:
    """Immutable bundle of blockified data + grid spec + engine options.

    ``num_users``/``num_items`` are the true (pre-grid-padding) shape;
    ``seen_coo`` holds the observed (user, item) pairs for serve-time
    exclusion; ``mu`` is the observed-mean offset subtracted when
    ``mean_center=True``; ``dataset`` (optional) carries held-out test
    entries for eval-RMSE; ``plan`` (when built with ``plan=``) says which
    tile of the block grid ``data`` holds, while ``spec`` stays global.
    """

    data: Union[Problem, SparseProblem]
    spec: G.GridSpec
    engine: EngineOptions = EngineOptions()
    num_users: int = 0
    num_items: int = 0
    seen_coo: Optional[Tuple[np.ndarray, np.ndarray]] = None
    mu: float = 0.0
    dataset: Optional[MCDataset] = None
    plan: Optional[MeshPlan] = None

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_dense(
        cls,
        x: np.ndarray,
        mask: np.ndarray,
        p: int,
        q: int,
        rank: int,
        *,
        layout: str = "dense",
        engine: EngineOptions | None = None,
        mean_center: bool = False,
        dataset: MCDataset | None = None,
        headroom: int | None = None,
        plan=None,
        device="cuda",
    ) -> "CompletionProblem":
        """From a dense (m, n) matrix + 0/1 observation mask.  Pads to the
        grid, blockifies, and builds the sparse store when
        ``layout="sparse"``; ``headroom`` overrides ``engine.headroom``.
        ``plan`` keeps this rank's tile only."""

        device = resolve_device(device)
        if layout not in ("dense", "sparse"):
            raise ValueError(
                f"unknown layout {layout!r}; expected 'dense' or 'sparse'"
            )
        engine = engine or EngineOptions()
        if headroom is not None:
            engine = dataclasses.replace(engine, headroom=headroom)
        x = np.asarray(x, np.float32)
        mask = np.asarray(mask, np.float32)
        if x.shape != mask.shape or x.ndim != 2:
            raise ValueError(
                f"x and mask must be equal-shape 2-D arrays, got "
                f"{x.shape} vs {mask.shape}"
            )
        m0, n0 = x.shape
        xp, mp, m, n = G.pad_to_grid(x, mask, p, q)
        spec = G.GridSpec(m, n, p, q, rank)
        mu = 0.0
        if mean_center:
            mu = float((xp * mp).sum() / max(mp.sum(), 1.0))
            xp = xp - mu                       # blockify re-masks (x*mask)
        # built on the host, then each rank's tile moves to its device
        if layout == "sparse":
            xb, maskb = G.blockify(xp * mp, mp, spec)
            data: Union[Problem, SparseProblem] = store.from_blocks(
                xb, maskb, engine.bucket, engine.headroom, device="cpu")
        else:
            data = make_problem(xp, mp, spec, "cpu")
        plan, data = _place(data, p, q, plan, device)
        rows, cols = np.nonzero(mask)
        return cls(data=data, spec=spec, engine=engine, num_users=m0,
                   num_items=n0, seen_coo=(rows.astype(np.int64),
                                           cols.astype(np.int64)),
                   mu=mu, dataset=dataset, plan=plan)

    @classmethod
    def from_entries(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        p: int,
        q: int,
        rank: int,
        *,
        layout: str = "sparse",
        engine: EngineOptions | None = None,
        mean_center: bool = False,
        dataset: MCDataset | None = None,
        headroom: int | None = None,
        plan=None,
        device="cuda",
    ) -> "CompletionProblem":
        """From a global COO triplet list.  ``layout="sparse"`` (default)
        never materializes the dense matrix; ``layout="dense"`` scatters
        into dense tensors first.  ``plan`` keeps this rank's tile only:
        on the sparse layout the ingest is owner-routed, each rank packing
        only the entries of its own blocks (``ShardedEntries.from_coo``)."""

        device = resolve_device(device)
        engine = engine or EngineOptions()
        if headroom is not None:
            engine = dataclasses.replace(engine, headroom=headroom)
        m0, n0 = shape
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        mu = float(vals.mean()) if (mean_center and len(vals)) else 0.0
        if layout == "dense":
            x = np.zeros((m0, n0), np.float32)
            mask = np.zeros((m0, n0), np.float32)
            x[rows, cols] = vals
            mask[rows, cols] = 1.0
            return cls.from_dense(x, mask, p, q, rank, layout="dense",
                                  engine=engine, mean_center=mean_center,
                                  dataset=dataset, plan=plan, device=device)
        if layout != "sparse":
            raise ValueError(
                f"unknown layout {layout!r}; expected 'dense' or 'sparse'"
            )
        cvals = vals - mu if mu else vals
        if plan is not None:
            plan = MeshPlan.build(p, q, plan)
            sharded, (m, n) = ShardedEntries.from_coo(
                rows, cols, cvals, m0, n0, plan, engine.bucket,
                engine.headroom, device=device)
            sp = sharded.sp
        else:
            sp, (m, n) = store.from_entries(
                rows, cols, cvals, m0, n0, p, q, engine.bucket,
                engine.headroom, device=device)
        spec = G.GridSpec(m, n, p, q, rank)
        order = np.argsort(rows, kind="stable")   # seen table wants user-sorted
        return cls(data=sp, spec=spec, engine=engine, num_users=m0,
                   num_items=n0, seen_coo=(rows[order], cols[order]),
                   mu=mu, dataset=dataset, plan=plan)

    @classmethod
    def from_dataset(
        cls,
        ds: MCDataset,
        p: int,
        q: int,
        rank: int,
        *,
        layout: str = "dense",
        engine: EngineOptions | None = None,
        mean_center: bool = False,
        headroom: int | None = None,
        plan=None,
        device="cuda",
    ) -> "CompletionProblem":
        """From an ``MCDataset``; keeps the held-out test split attached
        for eval-RMSE callbacks and ``FitResult.rmse()``.  ``plan`` keeps
        this rank's tile only."""

        return cls.from_dense(ds.x, ds.train_mask, p, q, rank, layout=layout,
                              engine=engine, mean_center=mean_center,
                              dataset=ds, headroom=headroom, plan=plan,
                              device=device)

    # ------------------------------------------------------------------ #
    # derived views
    # ------------------------------------------------------------------ #

    @property
    def layout(self) -> str:
        return "sparse" if isinstance(self.data, SparseProblem) else "dense"

    @property
    def device(self) -> torch.device:
        if isinstance(self.data, SparseProblem):
            return self.data.device
        return self.data.xb.device

    @property
    def density(self) -> float:
        if isinstance(self.data, SparseProblem):
            return store.density(self.data, self.spec)
        return float(self.data.maskb.mean())

    def with_engine(self, **overrides) -> "CompletionProblem":
        """Copy with tweaked EngineOptions (data/spec shared, zero-copy).
        ``bucket`` only affects future ingest, not the built store."""

        return dataclasses.replace(
            self, engine=dataclasses.replace(self.engine, **overrides)
        )

    def with_plan(self, plan) -> "CompletionProblem":
        """Copy holding only this rank's tile of the blocks under ``plan``
        (a ``MeshPlan`` or an (R, C) rank grid; the twin of the
        reference's ``with_mesh``), on the same device.  ``plan=None``
        drops a 1×1 plan.  A problem that already holds one tile of a
        larger grid cannot be re-cut: build it again with ``plan=``."""

        if self.plan is not None and not self.plan.is_single_device:
            raise ValueError(
                f"this problem holds one tile of a {self.plan.row_size}x"
                f"{self.plan.col_size} rank grid; build the global problem "
                f"again with plan= instead of re-placing a tile")
        if plan is None:
            return dataclasses.replace(self, plan=None)
        plan, data = _place(self.data, self.spec.p, self.spec.q, plan,
                            self.device)
        return dataclasses.replace(self, data=data, plan=plan)

    def with_layout(self, layout: str) -> "CompletionProblem":
        """Copy converted to the requested layout (no-op when it matches),
        on the same device."""

        if layout == self.layout:
            return self
        if layout == "sparse":
            data = store.from_blocks(
                self.data.xb.cpu().numpy(), self.data.maskb.cpu().numpy(),
                self.engine.bucket, self.engine.headroom, device=self.device,
            )
        elif layout == "dense":
            xb, maskb = store.to_dense(self.data, self.spec.mb, self.spec.nb)
            data = Problem(torch.from_numpy(xb).to(self.device),
                           torch.from_numpy(maskb).to(self.device))
        else:
            raise ValueError(
                f"unknown layout {layout!r}; expected 'dense' or 'sparse'"
            )
        return dataclasses.replace(self, data=data)

    # ------------------------------------------------------------------ #
    # engine-option-respecting evaluation
    # ------------------------------------------------------------------ #

    def total_cost(self, state: State, lam: float) -> float:
        """Paper Table-2 cost at ``state`` (layout-dispatching)."""

        return float(self.total_cost_device(state, lam))

    def total_cost_device(self, state: State, lam: float) -> torch.Tensor:
        """The same cost as a tensor on the problem's device (no host
        sync).  Under a plan of more than one rank the problem holds one
        tile, ``state`` is the global state or that tile, and the cost is
        the whole grid's: the tile's, all-reduced over the ranks
        (``core.gossip.distributed_cost``), so every rank must call it."""

        plan = self.plan
        if plan is not None:
            state = plan.local_slice(state, plan_rank(plan))
        return core_gossip.distributed_cost(self.data, state, lam, plan,
                                            method=self.engine.method)

    # ------------------------------------------------------------------ #
    # streaming ingestion
    # ------------------------------------------------------------------ #

    def append(self, rows, cols, vals) -> "CompletionProblem":
        """New ratings spliced into the problem's store — the streaming
        ingestion path.

        ``rows``/``cols`` are true (pre-padding) user/item indices; values
        are mean-centred by the problem's μ.  On the sparse layout the
        entries are merged into the sorted padded-COO store at its
        capacity (``store.append_entries``; pre-allocate slack with
        ``headroom=`` at ingest, a full bucket raises with the headroom
        that would have absorbed the append).  On the dense layout they
        scatter into fresh copies of the block tensors.  Under a plan the
        append is owner-routed: each rank keeps only the entries of the
        blocks its tile holds (``ShardedEntries.append``;
        ``sparse.owner_entries`` on the dense layout).  A (user, item) pair already rated updates
        its value; duplicate pairs within the batch resolve to the last
        occurrence; an empty append returns ``self``.

        Returns a new problem sharing the spec/engine/dataset; the old
        one's tensors are not written.  The seen-item table grows, so
        serving built from a refit excludes the new ratings.  Appends never
        grow the matrix: new users or items need a fresh ingest (and a
        cold fit, since factor shapes change)."""

        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
            raise ValueError(
                f"rows/cols/vals must be equal-length 1-D arrays, got "
                f"{rows.shape}/{cols.shape}/{vals.shape}"
            )
        if len(rows) == 0:
            return self
        if (rows.min() < 0 or rows.max() >= self.num_users
                or cols.min() < 0 or cols.max() >= self.num_items):
            raise ValueError(
                f"append indices out of range for the "
                f"{self.num_users}x{self.num_items} matrix: rows in "
                f"[{rows.min()}, {rows.max()}], cols in "
                f"[{cols.min()}, {cols.max()}] — appends cover existing "
                f"users/items; a grown matrix needs a fresh from_entries "
                f"ingest (factor shapes change)"
            )
        rows, cols, vals = store.dedupe_last_write(rows, cols, vals,
                                                   self.num_items)
        cvals = vals - self.mu if self.mu else vals
        mb, nb = self.spec.mb, self.spec.nb
        plan = self.plan
        data: Union[Problem, SparseProblem]
        if isinstance(self.data, SparseProblem):
            if plan is not None:
                data = ShardedEntries(self.data, plan, plan_rank(plan)).append(
                    rows, cols, cvals).sp
            else:
                data = store.append_entries(self.data, rows, cols, cvals)
        else:
            trows, tcols, tvals = rows, cols, cvals
            if plan is not None:
                keep, (oi, oj) = owner_entries(rows, cols, plan, mb, nb,
                                               plan_rank(plan))
                trows, tcols = rows[keep] - oi * mb, cols[keep] - oj * nb
                tvals = cvals[keep]
            data = self.data if len(trows) == 0 else _scatter_dense(
                self.data, trows, tcols, tvals, mb, nb)
        if self.seen_coo is not None:
            ar = np.concatenate([np.asarray(self.seen_coo[0], np.int64), rows])
            ac = np.concatenate([np.asarray(self.seen_coo[1], np.int64), cols])
        else:
            ar, ac = rows, cols
        ni = max(self.num_items, 1)
        # user-sorted + deduped: np.unique's sorted result, by one sort
        # (numpy 2.3's np.unique hashes, several times slower at ML-1M)
        keys = np.sort(ar * ni + ac)
        uniq = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
        return dataclasses.replace(self, data=data,
                                   seen_coo=(uniq // ni, uniq % ni))

    def full_gradients(self, state: State, *, rho: float, lam: float):
        """∇L of the collapsed objective with this problem's engine options."""

        return core_waves.full_gradients(
            self.data, state.U, state.W, rho=rho, lam=lam,
            method=self.engine.method, chunk=self.engine.chunk,
        )
