"""``MeshPlan`` — which rank owns which blocks of the (p, q) grid.

Port of ``repro.mesh.plan``'s block-ownership geometry.  The block grid is
tiled contiguously over an R×C grid of ``torch.distributed`` ranks (rank k
sits at ``(k // C, k % C)``): rank row ``d`` owns block rows
``[d·p/R, (d+1)·p/R)``, and likewise for columns.  ::

    plan = MeshPlan.build(p=4, q=4, grid=(2, 2))
    plan.owner(1, 3)             # -> 1, the rank owning block (1, 3)
    plan.local_blocks(0, 1)      # -> the blocks rank (0, 1) holds
    plan.local_slice(data, 3)    # -> rank 3's tile of a (p, q) stack

``MeshPlan.build(p, q)`` with no grid is the 1×1 plan: one process, no
process group, every block local.  The JAX package's PartitionSpecs and
device placement have no torch meaning; ``local_slice`` takes their place,
and ``item_slice`` takes ``item_spec``'s: the serving catalog's item axis
is cut into ``num_item_shards`` contiguous slices, shard s on rank s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Block grid (p, q) over a grid of R×C ranks."""

    p: int
    q: int
    grid: Tuple[int, int] = (1, 1)

    # names of the rank grid's two dimensions: the reference's mesh axes,
    # which ``describe()`` prints as the reference does
    row_axes: ClassVar[Tuple[str, ...]] = ("data",)
    col_axes: ClassVar[Tuple[str, ...]] = ("model",)

    def __post_init__(self) -> None:
        R, C = self.grid
        if R <= 0 or C <= 0:
            raise ValueError(f"rank grid must be positive, got {R}x{C}")
        if self.p % R or self.q % C:
            raise ValueError(
                f"block grid {self.p}x{self.q} does not tile the "
                f"{R}x{C} device grid: p must be a multiple of {R} and q of "
                f"{C} (each rank holds whole blocks)"
            )

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @classmethod
    def build(cls, p: int, q: int, grid=None) -> "MeshPlan":
        """The one constructor every layer uses.  ``grid=None`` builds the
        1×1 plan; a ``MeshPlan`` passes through unchanged when its block
        grid matches."""

        if isinstance(grid, MeshPlan):
            if (grid.p, grid.q) != (p, q):
                raise ValueError(
                    f"plan is for a {grid.p}x{grid.q} grid, problem has "
                    f"{p}x{q}; build a matching MeshPlan"
                )
            return grid
        R, C = (1, 1) if grid is None else (int(grid[0]), int(grid[1]))
        return cls(p=p, q=q, grid=(R, C))

    @classmethod
    def for_world(cls, world: int) -> "MeshPlan":
        """1×D plan over ``world`` ranks (the counterpart of the
        reference's ``for_devices``): for consumers that only need the
        flattened rank list, such as the serving catalog's item shards."""

        return cls.build(1, int(world), grid=(1, int(world)))

    # ------------------------------------------------------------------ #
    # geometry
    # ------------------------------------------------------------------ #

    @property
    def row_size(self) -> int:
        """Rank count along the block-row dimension."""

        return self.grid[0]

    @property
    def col_size(self) -> int:
        """Rank count along the block-col dimension."""

        return self.grid[1]

    @property
    def num_devices(self) -> int:
        return self.row_size * self.col_size

    @property
    def all_axes(self) -> Tuple[str, ...]:
        """The row axes then the column axes: the rank order (row-major
        over the grid) that the serving item shards follow."""

        return self.row_axes + self.col_axes

    @property
    def is_single_device(self) -> bool:
        return self.num_devices == 1

    @property
    def blocks_per_row_shard(self) -> int:
        """Block rows owned by each rank row (contiguous tiling)."""

        return self.p // self.row_size

    @property
    def blocks_per_col_shard(self) -> int:
        return self.q // self.col_size

    # -- halo-edge geometry (the gossip wire graph, receiver-side view) -- #

    @property
    def num_u_edges(self) -> int:
        """Directed U-halo messages per refresh round: each of the
        ``row_size`` rank rows has ``col_size - 1`` interior pairs, each
        exchanging in both directions."""

        return 2 * self.row_size * (self.col_size - 1)

    @property
    def num_w_edges(self) -> int:
        """Directed W-halo messages per refresh round (dual of
        :attr:`num_u_edges`)."""

        return 2 * self.col_size * (self.row_size - 1)

    @property
    def num_halo_edges(self) -> int:
        """All directed halo messages one refresh round carries."""

        return self.num_u_edges + self.num_w_edges

    # ------------------------------------------------------------------ #
    # ownership
    # ------------------------------------------------------------------ #

    def coords(self, rank: int) -> tuple[int, int]:
        """Rank-grid coordinates of ``rank``."""

        if not 0 <= rank < self.num_devices:
            raise IndexError(
                f"rank {rank} outside the {self.row_size}x{self.col_size} "
                "rank grid"
            )
        return divmod(rank, self.col_size)

    def owner_coords(self, i: int, j: int) -> tuple[int, int]:
        """Rank-grid coordinates owning block (i, j)."""

        if not (0 <= i < self.p and 0 <= j < self.q):
            raise IndexError(
                f"block ({i},{j}) outside the {self.p}x{self.q} grid"
            )
        return i // self.blocks_per_row_shard, j // self.blocks_per_col_shard

    def owner(self, i: int, j: int) -> int:
        """The rank owning block (i, j) — its entries, its U_ij/W_ij."""

        di, dj = self.owner_coords(i, j)
        return di * self.col_size + dj

    def block_owners(self) -> np.ndarray:
        """(p, q) int array: the rank owning each block."""

        di = np.arange(self.p) // self.blocks_per_row_shard
        dj = np.arange(self.q) // self.blocks_per_col_shard
        return (di[:, None] * self.col_size + dj[None, :]).astype(np.int32)

    def local_blocks(self, di: int, dj: int) -> list[tuple[int, int]]:
        """Blocks owned by rank-grid cell (di, dj), row-major."""

        bpr, bpc = self.blocks_per_row_shard, self.blocks_per_col_shard
        return [(i, j)
                for i in range(di * bpr, (di + 1) * bpr)
                for j in range(dj * bpc, (dj + 1) * bpc)]

    def describe(self) -> str:
        """ASCII ownership map (docs / log lines)."""

        own = self.block_owners()
        head = (f"MeshPlan {self.p}x{self.q} blocks over "
                f"{self.row_size}x{self.col_size} devices "
                f"(row_axes={self.row_axes}, col_axes={self.col_axes})")
        width = max(2, len(str(own.max())))
        rows = ["  " + " ".join(f"d{own[i, j]:<{width}}"
                                for j in range(self.q))
                for i in range(self.p)]
        return "\n".join([head] + rows)

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #

    def tile(self, rank: int) -> tuple[slice, slice]:
        """The (block-row, block-col) slices of ``rank``'s tile."""

        di, dj = self.coords(rank)
        bpr, bpc = self.blocks_per_row_shard, self.blocks_per_col_shard
        return (slice(di * bpr, (di + 1) * bpr),
                slice(dj * bpc, (dj + 1) * bpc))

    def local_slice(self, data: Any, rank: int | None = None) -> Any:
        """``rank``'s contiguous tile of a (p, q)-stacked problem or state:
        every tensor or array whose leading dims are (p, q) is cut to
        (p/R, q/C); NamedTuples and tuples are walked, anything else (the
        step clock, ``None``) passes through.  ``rank`` defaults to this
        process's rank in the process group (0 without one)."""

        if rank is None:
            rank = current_rank()
        rows, cols = self.tile(rank)

        def cut(x):
            if isinstance(x, tuple):
                parts = [cut(f) for f in x]
                return type(x)(*parts) if hasattr(x, "_fields") \
                    else type(x)(parts)
            if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 2 \
                    and tuple(x.shape[:2]) == (self.p, self.q):
                if isinstance(x, np.ndarray):
                    return np.ascontiguousarray(x[rows, cols])
                return x[rows, cols].contiguous()
            return x

        return cut(data)

    # ------------------------------------------------------------------ #
    # serving: the catalog's item axis over every rank
    # ------------------------------------------------------------------ #

    @property
    def num_item_shards(self) -> int:
        """Shard count of the serving item axis (= rank count)."""

        return self.num_devices

    def item_slice(self, rank: int, n_pad: int) -> slice:
        """Rank ``rank``'s contiguous slice of an item axis padded to
        ``n_pad`` (a multiple of :attr:`num_item_shards`): shard s is rank
        s = di·C + dj, so the shards hold the items in rank order."""

        S = self.num_item_shards
        if n_pad % S:
            raise ValueError(
                f"padded item count {n_pad} is not a multiple of the "
                f"{S} item shards")
        self.coords(rank)                    # range check
        width = n_pad // S
        return slice(rank * width, (rank + 1) * width)


def current_rank() -> int:
    """This process's rank in the default process group, 0 without one."""

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def plan_rank(plan: MeshPlan) -> int:
    """This process's rank on ``plan``: 0 on a 1×1 plan (which every
    process holds whole), else its rank in the process group."""

    return 0 if plan.is_single_device else current_rank()


# ---------------------------------------------------------------------- #
# axis utilities of the LM sharding rules (``train/sharding.py`` reads
# them here, as the JAX package's rules read ``repro.mesh.plan``'s)
# ---------------------------------------------------------------------- #


def divides(dim: int, by: int) -> bool:
    """True when a dim can legally shard ``by`` ways (the degrade-to-
    replication rule every placement decision uses)."""

    return by > 0 and dim % by == 0


def axis_if_divisible(dim: int, axis, size: int):
    """``axis`` when ``dim`` splits evenly over it, else ``None``
    (replicate) — the single definition of spec degradation."""

    return axis if divides(dim, size) else None


def dp_axes(mesh_cfg) -> tuple[str, ...]:
    """Data-parallel axes of an LM ``MeshConfig`` (pod folds into data)."""

    return ("pod", "data") if mesh_cfg.multi_pod else ("data",)
