"""Segment-sorted padded-COO sparse block store (ingest half).

Port of ``repro.sparse.store``: the same numpy lexsort packing, with the
packed arrays moved once onto the problem's device.  Per grid block only
the observed entries are kept, bundled as one ``BlockEntries`` stacked
over the (p, q) grid:

    entries.rows     : (p, q, E)    int32   — intra-block row index
    entries.cols     : (p, q, E)    int32   — intra-block col index
    entries.vals     : (p, q, E)    float32 — observed value
    entries.valid    : (p, q, E)    float32 — 1 real, 0 padding
    entries.col_perm : (p, q, E)    int32   — permutation to col-sorted order
    entries.row_ptr  : (p, q, mb+1) int32   — CSR segment offsets
    entries.col_ptr  : (p, q, nb+1) int32   — CSC segment offsets
    nnz              : (p, q)       int32   — real entry count per block

Entries are segment-sorted: real entries come first, in (row, col)
lexicographic order, so each block row is a contiguous segment delimited
by ``row_ptr``; ``col_perm`` is the dual (CSC) view with ``col_ptr``
offsets.  Padding slots carry rows=mb−1, cols=0, vals=0, valid=0 and add
exactly zero to every sum.  ``E`` is the largest block nnz plus the
requested headroom, rounded up to a bucket multiple.

Streaming appends, dedupe and minibatch sampling are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import grid as G
from repro_torch.data.synthetic import MCDataset
from repro_torch.sparse.entries import BlockEntries

DEFAULT_BUCKET = 256


class SparseProblem(NamedTuple):
    """Blockified matrix-completion problem, observed entries only,
    segment-sorted by row with a precomputed column-sorted dual view."""

    entries: BlockEntries  # every field stacked over the leading (p, q)
    nnz: torch.Tensor      # (p, q) int32

    @property
    def capacity(self) -> int:
        return self.entries.capacity

    @property
    def mb(self) -> int:
        """Block row count (from the CSR offsets — the true shape source)."""

        return self.entries.mb

    @property
    def nb(self) -> int:
        """Block col count (from the CSC offsets)."""

        return self.entries.nb

    @property
    def device(self) -> torch.device:
        return self.nnz.device


def bucketed_capacity(max_nnz: int, bucket: int = DEFAULT_BUCKET,
                      headroom: int = 0) -> int:
    """Per-block capacity: largest block nnz plus the requested append
    headroom, rounded up to a bucket multiple (≥ one bucket)."""

    if bucket <= 0:
        raise ValueError(f"bucket must be positive, got {bucket}")
    if headroom < 0:
        raise ValueError(f"headroom must be non-negative, got {headroom}")
    return max(bucket, (max_nnz + headroom + bucket - 1) // bucket * bucket)


def _pack_sorted(blk, rr, cc, vv, p, q, mb, nb, bucket, headroom: int = 0,
                 *, device) -> SparseProblem:
    """Shared packing tail: (block, row, col)-lexicographically sorted entry
    streams -> the padded, segment-sorted store on ``device``.  ``blk``
    must be non-decreasing with (rr, cc) lexicographic within each block."""

    total = len(blk)
    nnz = np.bincount(blk, minlength=p * q).astype(np.int64)
    E = bucketed_capacity(int(nnz.max()) if total else 0, bucket, headroom)
    starts = np.zeros(p * q + 1, np.int64)
    np.cumsum(nnz, out=starts[1:])
    within = np.arange(total, dtype=np.int64) - starts[blk]
    dest = blk * E + within

    # padding rows sit at mb-1 so each block's row stream is non-decreasing
    # over the full capacity
    rows = np.full(p * q * E, mb - 1, np.int32)
    cols = np.zeros(p * q * E, np.int32)
    vals = np.zeros(p * q * E, np.float32)
    valid = np.zeros(p * q * E, np.float32)
    rows[dest] = rr
    cols[dest] = cc
    vals[dest] = vv
    valid[dest] = 1.0

    # CSR offsets: per-(block, row) counts, cumulated along the row axis.
    rcnt = np.bincount(blk * mb + rr, minlength=p * q * mb).reshape(p * q, mb)
    row_ptr = np.zeros((p * q, mb + 1), np.int32)
    row_ptr[:, 1:] = np.cumsum(rcnt, axis=1)

    # CSC dual view: stable (block, col, row) order; the i-th col-sorted
    # entry of block b sits at global position starts[b]+i.
    order = np.lexsort((rr, cc, blk))
    col_perm = np.tile(np.arange(E, dtype=np.int32), p * q)  # padding -> itself
    col_perm[blk * E + within] = within[order].astype(np.int32)
    ccnt = np.bincount(blk * nb + cc, minlength=p * q * nb).reshape(p * q, nb)
    col_ptr = np.zeros((p * q, nb + 1), np.int32)
    col_ptr[:, 1:] = np.cumsum(ccnt, axis=1)

    def put(a, *shape):
        return torch.from_numpy(np.ascontiguousarray(a.reshape(shape))).to(
            device)

    entries = BlockEntries(
        put(rows, p, q, E), put(cols, p, q, E), put(vals, p, q, E),
        put(valid, p, q, E), put(col_perm, p, q, E),
        put(row_ptr, p, q, mb + 1), put(col_ptr, p, q, nb + 1),
    )
    sp = SparseProblem(entries, put(nnz.astype(np.int32), p, q))
    obs.counter("ingest_entries_total").inc(total)
    # min over blocks: the append slack of the block that would raise first
    obs.gauge("ingest_free_slots").set(int(E - (nnz.max() if total else 0)))
    return sp


def from_blocks(xb: np.ndarray, maskb: np.ndarray,
                bucket: int = DEFAULT_BUCKET, headroom: int = 0, *,
                device) -> SparseProblem:
    """Convert blockified dense (p,q,mb,nb) numpy tensors to the sorted
    store on ``device``.  ``np.nonzero``'s C order already yields (block,
    row, col) lexicographic entries; the CSC view is one ``np.lexsort``."""

    xb = np.asarray(xb)
    maskb = np.asarray(maskb)
    p, q, mb, nb = xb.shape
    bi, bj, rr, cc = np.nonzero(maskb)            # C order: row-sorted per block
    blk = bi * q + bj                             # non-decreasing
    return _pack_sorted(blk, rr, cc, xb[bi, bj, rr, cc], p, q, mb, nb,
                        bucket, headroom, device=device)


def from_entries(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    p: int,
    q: int,
    bucket: int = DEFAULT_BUCKET,
    headroom: int = 0,
    *,
    device,
) -> tuple[SparseProblem, tuple[int, int]]:
    """Build the sorted store straight from a global COO triplet list — no
    dense (m, n) materialization.  The grid is padded implicitly (mb =
    ceil(m/p) etc.); returns the store plus the padded (m, n).  Duplicate
    (row, col) pairs are the caller's responsibility."""

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
        raise ValueError(
            f"rows/cols/vals must be equal-length 1-D arrays, got "
            f"{rows.shape}/{cols.shape}/{vals.shape}"
        )
    if len(rows) and (rows.min() < 0 or rows.max() >= m
                      or cols.min() < 0 or cols.max() >= n):
        raise ValueError(
            f"entry indices out of range for a {m}x{n} matrix: rows in "
            f"[{rows.min()}, {rows.max()}], cols in [{cols.min()}, {cols.max()}]"
        )
    mb = -(-m // p)
    nb = -(-n // q)
    bi, rr = rows // mb, rows % mb
    bj, cc = cols // nb, cols % nb
    blk = bi * q + bj
    order = np.lexsort((cc, rr, blk))              # (block, row, col) lexicographic
    sp = _pack_sorted(blk[order], rr[order], cc[order], vals[order],
                      p, q, mb, nb, bucket, headroom, device=device)
    return sp, (mb * p, nb * q)


def from_dataset(
    ds: MCDataset, p: int, q: int, r: int, bucket: int = DEFAULT_BUCKET,
    headroom: int = 0, *, device,
) -> tuple[SparseProblem, G.GridSpec]:
    """Pad to the grid, blockify, and build the store.  Returns the padded
    GridSpec alongside (the spec's m/n include grid padding)."""

    x, mask, m, n = G.pad_to_grid(ds.x, ds.train_mask, p, q)
    spec = G.GridSpec(m, n, p, q, r)
    xb, maskb = G.blockify(x * mask, mask, spec)
    return from_blocks(xb, maskb, bucket, headroom, device=device), spec


def to_dense(sp: SparseProblem, mb: int | None = None,
             nb: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Back to dense numpy (xb, maskb) block tensors — tests and interop.
    Block dims default to the store's own CSR/CSC offsets."""

    mb = sp.mb if mb is None else mb
    nb = sp.nb if nb is None else nb
    rows = sp.entries.rows.cpu().numpy()
    cols = sp.entries.cols.cpu().numpy()
    vals = sp.entries.vals.cpu().numpy()
    nnz = sp.nnz.cpu().numpy()
    p, q, _ = rows.shape
    xb = np.zeros((p, q, mb, nb), np.float32)
    maskb = np.zeros((p, q, mb, nb), np.float32)
    for i in range(p):
        for j in range(q):
            k = int(nnz[i, j])
            xb[i, j, rows[i, j, :k], cols[i, j, :k]] = vals[i, j, :k]
            maskb[i, j, rows[i, j, :k], cols[i, j, :k]] = 1.0
    return xb, maskb


def density(sp: SparseProblem, spec: G.GridSpec | None = None) -> float:
    """Fraction of observed entries over the (padded) matrix area p·q·mb·nb;
    padding and headroom slots are excluded.  Block shape comes from a
    ``GridSpec`` or from the store's own CSR/CSC offsets."""

    mb, nb = (spec.mb, spec.nb) if spec is not None else (sp.mb, sp.nb)
    p, q = sp.nnz.shape
    return float(sp.nnz.sum()) / (p * q * mb * nb)


def ensure_layout(problem, layout: str | None, bucket: int = DEFAULT_BUCKET):
    """Coerce a problem to the requested layout.

    ``None`` infers the layout from the problem type.  ``"sparse"``
    converts a dense ``Problem`` via :func:`from_blocks` on the problem's
    device (a SparseProblem passes through).  ``"dense"`` only validates —
    going back to dense tensors is an explicit :func:`to_dense` call."""

    if layout is None:
        return problem
    if layout == "sparse":
        if isinstance(problem, SparseProblem):
            return problem
        return from_blocks(problem.xb.cpu().numpy(),
                           problem.maskb.cpu().numpy(), bucket,
                           device=problem.xb.device)
    if layout == "dense":
        if isinstance(problem, SparseProblem):
            raise ValueError(
                "layout='dense' but got a SparseProblem; convert with "
                "sparse.to_dense(sp) first"
            )
        return problem
    raise ValueError(f"unknown layout {layout!r}; expected 'dense' or 'sparse'")
