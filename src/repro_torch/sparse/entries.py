"""``BlockEntries`` — the one NamedTuple that carries a block's sparse entries.

Port of ``repro.sparse.entries``.  Layout contract (``sparse/store.py``):

    rows     : (..., E) int32   — intra-block row index per entry
    cols     : (..., E) int32   — intra-block col index
    vals     : (..., E) float32 — observed value
    valid    : (..., E) float32 — 1 real entry, 0 padding
    col_perm : (..., E) int32   — gather to column-sorted (CSC) order
    row_ptr  : (..., mb+1) int32 — CSR segment offsets over the entry axis
    col_ptr  : (..., nb+1) int32 — CSC segment offsets (in col_perm order)

Leading batch axes are free: the store stacks blocks as (p, q, ...), the
schedulers gather structure trios as (3, ...) or waves as (S, 3, ...).  The
gradient kernels take the whole stack in one launch, which is what the
reference's ``jax.vmap`` over per-block calls becomes here.

The index arrays stay int32, as in the reference, so the store's parity
is exact; consumers cast to int64 only where a torch op requires it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BlockEntries(NamedTuple):
    """Padded-COO entries of one block (or a stack of blocks)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor
    col_perm: Optional[torch.Tensor] = None
    row_ptr: Optional[torch.Tensor] = None
    col_ptr: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        """Per-block entry capacity E (padding included)."""

        return self.rows.shape[-1]

    @property
    def has_sorted_aux(self) -> bool:
        """True when the CSR/CSC dual-view offsets are attached — the
        precondition of the ``segment`` gradient method."""

        return (
            self.col_perm is not None
            and self.row_ptr is not None
            and self.col_ptr is not None
        )

    @property
    def mb(self) -> int:
        """Block row count, from the CSR offsets (sorted stores only)."""

        return self.row_ptr.shape[-1] - 1

    @property
    def nb(self) -> int:
        """Block col count, from the CSC offsets (sorted stores only)."""

        return self.col_ptr.shape[-1] - 1

    def gather(self, *idx) -> "BlockEntries":
        """Index every field identically: ``entries.gather(bi, bj)`` pulls
        the same (possibly advanced-indexed) blocks out of all fields, e.g.
        a structure's three blocks as a (3, ...) stack.  ``None`` aux fields
        pass through untouched."""

        return BlockEntries(*(None if f is None else f[idx] for f in self))
