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
CPU; without a card that default raises.  Meshes and streaming appends
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import grid as G
from repro_torch.core import objective as core_obj
from repro_torch.core import waves as core_waves
from repro_torch.core.state import (Problem, State, make_problem,
                                    resolve_device)
from repro_torch.data.synthetic import MCDataset
from repro_torch.sparse import store
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


@dataclasses.dataclass(frozen=True)
class CompletionProblem:
    """Immutable bundle of blockified data + grid spec + engine options.

    ``num_users``/``num_items`` are the true (pre-grid-padding) shape;
    ``seen_coo`` holds the observed (user, item) pairs for serve-time
    exclusion; ``mu`` is the observed-mean offset subtracted when
    ``mean_center=True``; ``dataset`` (optional) carries held-out test
    entries for eval-RMSE.
    """

    data: Union[Problem, SparseProblem]
    spec: G.GridSpec
    engine: EngineOptions = EngineOptions()
    num_users: int = 0
    num_items: int = 0
    seen_coo: Optional[Tuple[np.ndarray, np.ndarray]] = None
    mu: float = 0.0
    dataset: Optional[MCDataset] = None

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
        device="cuda",
    ) -> "CompletionProblem":
        """From a dense (m, n) matrix + 0/1 observation mask.  Pads to the
        grid, blockifies, and builds the sparse store when
        ``layout="sparse"``; ``headroom`` overrides ``engine.headroom``."""

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
        if layout == "sparse":
            xb, maskb = G.blockify(xp * mp, mp, spec)
            data: Union[Problem, SparseProblem] = store.from_blocks(
                xb, maskb, engine.bucket, engine.headroom, device=device)
        else:
            data = make_problem(xp, mp, spec, device)
        rows, cols = np.nonzero(mask)
        return cls(data=data, spec=spec, engine=engine, num_users=m0,
                   num_items=n0, seen_coo=(rows.astype(np.int64),
                                           cols.astype(np.int64)),
                   mu=mu, dataset=dataset)

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
        device="cuda",
    ) -> "CompletionProblem":
        """From a global COO triplet list.  ``layout="sparse"`` (default)
        never materializes the dense matrix; ``layout="dense"`` scatters
        into dense tensors first."""

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
                                  dataset=dataset, device=device)
        if layout != "sparse":
            raise ValueError(
                f"unknown layout {layout!r}; expected 'dense' or 'sparse'"
            )
        cvals = vals - mu if mu else vals
        sp, (m, n) = store.from_entries(
            rows, cols, cvals, m0, n0, p, q, engine.bucket, engine.headroom,
            device=device,
        )
        spec = G.GridSpec(m, n, p, q, rank)
        order = np.argsort(rows, kind="stable")   # seen table wants user-sorted
        return cls(data=sp, spec=spec, engine=engine, num_users=m0,
                   num_items=n0, seen_coo=(rows[order], cols[order]),
                   mu=mu, dataset=dataset)

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
        device="cuda",
    ) -> "CompletionProblem":
        """From an ``MCDataset``; keeps the held-out test split attached
        for eval-RMSE callbacks and ``FitResult.rmse()``."""

        return cls.from_dense(ds.x, ds.train_mask, p, q, rank, layout=layout,
                              engine=engine, mean_center=mean_center,
                              dataset=ds, headroom=headroom, device=device)

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

        return float(core_obj.total_cost(self.data, state.U, state.W, lam,
                                         method=self.engine.method))

    def full_gradients(self, state: State, *, rho: float, lam: float):
        """∇L of the collapsed objective with this problem's engine options."""

        return core_waves.full_gradients(
            self.data, state.U, state.W, rho=rho, lam=lam,
            method=self.engine.method, chunk=self.engine.chunk,
        )
