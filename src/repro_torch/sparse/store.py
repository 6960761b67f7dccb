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

New ratings arrive through :func:`append_entries`: the splice runs in
numpy on the host, exactly as the reference's (one copy of the store's
tensors to the host, the merge, fresh tensors of the same capacity back on
the store's device), and returns a new store; the old one's tensors are
never written.  Minibatches come from :func:`sample_minibatch` and the
restart-exact :class:`MinibatchStream` in two parts: drawing the positions
from a ``torch.Generator`` (on the host, so one seed gives the same
positions on every device and every rank grid), and assembling the
sampled store from them with torch ops on the store's device.
``MinibatchStream(plan=)`` samples a rank's tile of the global draw, and
``sparse/sharded.py`` holds the owner-routed ingest and appends of a
rank's tile.
"""

from __future__ import annotations

import time
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
    def free_slots(self) -> torch.Tensor:
        """(p, q) append slack per block: capacity − nnz, how many entries
        :func:`append_entries` can still splice in before the bucket
        (ingest headroom included) overflows."""

        return self.capacity - self.nnz

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
                 capacity: int | None = None, *, device) -> SparseProblem:
    """Shared packing tail: (block, row, col)-lexicographically sorted entry
    streams -> the padded, segment-sorted store on ``device``.  ``blk``
    must be non-decreasing with (rr, cc) lexicographic within each block.
    ``capacity`` forces the per-block capacity E: the owner-routed ingest
    (``sparse/sharded.py``) packs each rank's blocks alone but must agree
    on the global store's E."""

    total = len(blk)
    nnz = np.bincount(blk, minlength=p * q).astype(np.int64)
    E = (capacity if capacity is not None
         else bucketed_capacity(int(nnz.max()) if total else 0, bucket,
                                headroom))
    if int(nnz.max() if total else 0) > E:
        raise ValueError(
            f"forced capacity {E} below the largest block nnz "
            f"{int(nnz.max())}"
        )
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


def dedupe_last_write(rows, cols, vals, stride: int):
    """Resolve duplicate (row, col) pairs in a COO batch to the **last**
    occurrence (an edited rating wins over the one it edits).  ``stride``
    is the column count of the indexing frame; the one definition of
    append dedup semantics for both layouts (``append_entries`` and
    ``CompletionProblem.append``)."""

    lin = rows * stride + cols
    order = np.argsort(lin, kind="stable")
    last = np.ones(len(order), bool)
    last[:-1] = lin[order][1:] != lin[order][:-1]
    order = order[last]
    return rows[order], cols[order], vals[order]


def _splice_block(ent, rptr, cptr, nnz, b, nrr, ncc, nvv, mb, nb, E,
                  label: str):
    """Splice one block's new entries into its sorted prefix, in place on
    the host copies.

    ``ent`` maps field name -> (nblocks, E) numpy arrays; ``rptr``/
    ``cptr``/``nnz`` are the matching flattened offset/count arrays; ``b``
    is the flat block index within those arrays; ``label`` names the block
    in overflow errors (global (i, j) coordinates)."""

    k = int(nnz[b])
    # new entries in the block's (row, col) lexicographic key order
    nkey = nrr * nb + ncc
    ks = np.argsort(nkey)
    nkey = nkey[ks]
    nrr, ncc = nrr[ks], ncc[ks]
    nvv = nvv[ks]
    ekey = ent["rows"][b, :k].astype(np.int64) * nb + ent["cols"][b, :k]
    idx = np.searchsorted(ekey, nkey)
    if k:
        dup = (idx < k) & (ekey[np.minimum(idx, k - 1)] == nkey)
    else:
        dup = np.zeros(len(nkey), bool)
    if dup.any():                        # edited ratings: value-only patch
        ent["vals"][b, idx[dup]] = nvv[dup]
    ins = ~dup
    n_ins = int(ins.sum())
    if n_ins == 0:
        return
    k2 = k + n_ins
    if k2 > E:
        raise ValueError(
            f"append overflows block {label}: {k} stored + {n_ins} new "
            f"entries > capacity {E}; re-ingest with headroom>={k2 - E} "
            f"more than before (from_entries/from_dataset headroom=) or "
            f"a larger bucket to pre-allocate append slack"
        )
    irr, icc, ivv = nrr[ins], ncc[ins], nvv[ins]
    # the classic merge, by insertion index: old entry i shifts by the
    # number of inserts landing at or before it, insert j lands at its
    # searchsorted position plus the inserts already placed before it
    pos = np.searchsorted(ekey, nkey[ins])
    old_dest = np.arange(k) + np.searchsorted(pos, np.arange(k), "right")
    ins_dest = pos + np.arange(n_ins)
    # CSC keys of the old prefix, in CSC order — before the splice below
    old_perm = ent["col_perm"][b, :k]
    ckey_sorted = (ent["cols"][b, :k].astype(np.int64) * mb
                   + ent["rows"][b, :k])[old_perm]
    for f, new in (("rows", irr), ("cols", icc), ("vals", ivv)):
        merged = np.empty(k2, ent[f].dtype)
        merged[old_dest] = ent[f][b, :k]
        merged[ins_dest] = new
        ent[f][b, :k2] = merged
    ent["valid"][b, :k2] = 1.0
    # patch the segment offsets with cumulated per-row/col insert counts
    rptr[b, 1:] += np.cumsum(np.bincount(irr, minlength=mb)).astype(
        rptr.dtype)
    cptr[b, 1:] += np.cumsum(np.bincount(icc, minlength=nb)).astype(
        cptr.dtype)
    # the same merge in the (col, row) dual order re-threads col_perm: old
    # CSC slots shift by the inserts sorting before them and map to the
    # spliced CSR positions of the entries they pointed at
    corder = np.argsort(icc * mb + irr)
    cpos = np.searchsorted(ckey_sorted, (icc * mb + irr)[corder])
    perm2 = np.empty(k2, np.int32)
    t = np.arange(k)
    perm2[t + np.searchsorted(cpos, t, "right")] = old_dest[old_perm]
    perm2[cpos + np.arange(n_ins)] = ins_dest[corder]
    ent["col_perm"][b, :k2] = perm2
    ent["col_perm"][b, k2:] = np.arange(k2, E)   # padding -> itself
    nnz[b] = k2


def append_entries(
    sp: SparseProblem,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
) -> SparseProblem:
    """Splice new observed entries into the sorted padded-COO store —
    streaming ingestion without a re-sort or a shape change.

    ``rows``/``cols`` are global indices in the store's padded frame
    (p·mb × q·nb).  Each entry is routed to its block and merged into the
    existing (row, col) order at its ``searchsorted`` position; the
    CSR/CSC views are patched incrementally (``row_ptr``/``col_ptr`` gain
    the cumulated per-row/col insert counts, ``col_perm`` is re-threaded
    by the same merge in the (col, row) order), so the segment kernel
    reads the grown store as it reads a fresh ingest.  Capacity is
    untouched.

    The merge runs on one host copy of the store; the result is a new
    ``SparseProblem`` on the store's device, and ``sp``'s tensors are
    never written.  A (row, col) pair already present updates its value
    (an edited rating) and costs no slot; duplicate pairs within one batch
    resolve to the last occurrence.  An empty append returns ``sp``.
    Raises ``ValueError`` when a block's ``free_slots`` cannot hold its new
    entries, with the headroom that would have absorbed the append."""

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
        raise ValueError(
            f"rows/cols/vals must be equal-length 1-D arrays, got "
            f"{rows.shape}/{cols.shape}/{vals.shape}"
        )
    if len(rows) == 0:
        return sp
    p, q = sp.nnz.shape
    m, n = p * sp.mb, q * sp.nb
    if (rows.min() < 0 or rows.max() >= m
            or cols.min() < 0 or cols.max() >= n):
        raise ValueError(
            f"append indices out of range for the {m}x{n} padded grid: rows "
            f"in [{rows.min()}, {rows.max()}], cols in "
            f"[{cols.min()}, {cols.max()}]"
        )
    rows, cols, vals = dedupe_last_write(rows, cols, vals, n)
    return splice_entries(sp, rows, cols, vals, (0, 0))


def splice_entries(sp: SparseProblem, rows, cols, vals,
                   origin: tuple[int, int]) -> SparseProblem:
    """The splice of :func:`append_entries` on validated, deduplicated
    int64 entries in ``sp``'s own frame; ``origin`` is the global (i, j) of
    ``sp``'s block (0, 0) (a rank's tile: ``CompletionProblem.append``
    under a plan), used to name blocks in errors."""

    t0 = time.perf_counter()
    p, q = sp.nnz.shape
    mb, nb = sp.mb, sp.nb
    bi, rr = rows // mb, rows % mb
    bj, cc = cols // nb, cols % nb
    blk = bi * q + bj

    E = sp.capacity
    # one host copy of the store; the merge writes only the copy
    host = [t.to("cpu", copy=True) for t in (*sp.entries, sp.nnz)]
    ent = {f: host[i].numpy().reshape(p * q, -1)
           for i, f in enumerate(("rows", "cols", "vals", "valid",
                                  "col_perm"))}
    rptr = host[5].numpy().reshape(p * q, mb + 1)
    cptr = host[6].numpy().reshape(p * q, nb + 1)
    nnz = host[7].numpy().reshape(p * q)

    for b in np.unique(blk):
        sel = blk == b
        i, j = divmod(int(b), q)
        _splice_block(ent, rptr, cptr, nnz, int(b), rr[sel], cc[sel],
                      vals[sel], mb, nb, E,
                      label=f"({i + origin[0]},{j + origin[1]})")

    fresh = [h.to(sp.device) for h in host]
    entries = BlockEntries(*fresh[:7])
    out = SparseProblem(entries, fresh[7])
    # the ingest plane's scoreboard: calls, entries, splice latency, and
    # how close the buckets are to overflowing (min over blocks: the
    # block that will raise first)
    obs.counter("ingest_appends_total").inc()
    obs.counter("ingest_appended_entries_total").inc(len(rows))
    obs.histogram("ingest_append_seconds").observe(time.perf_counter() - t0)
    obs.gauge("ingest_free_slots").set(int((E - nnz).min()))
    return out


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


# ---------------------------------------------------------------------------
# Streaming minibatch sampling over observed entries
# ---------------------------------------------------------------------------


def _step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` of the stream ``seed``: a pure
    function of the pair, spread by numpy's ``SeedSequence``."""

    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0])


def sample_positions(generator: torch.Generator, nnz: torch.Tensor,
                     batch: int, plan=None, rank=None) -> torch.Tensor:
    """Uniform with-replacement entry positions, ``batch`` per block: an
    int64 tensor of nnz's (p, q) shape plus ``(batch,)``, on nnz's device,
    each in [0, max(nnz, 1)).

    The draw is ``batch`` uniform floats per block of the **global** grid
    from ``generator`` (float64, on the generator's device), scaled by each
    block's own count and clamped to count − 1, so a block's positions
    depend only on the generator and its count.  ``plan`` (a ``MeshPlan``):
    ``nnz`` is this rank's tile of the plan's grid; the draw covers the
    whole grid and the rank keeps its tile, so every rank grid sees the
    1×1 stream's positions.  ``rank`` names the tile (default: this
    process's rank)."""

    shape = tuple(nnz.shape) if plan is None else (plan.p, plan.q)
    u = torch.rand((*shape, batch), generator=generator,
                   device=generator.device, dtype=torch.float64)
    if plan is not None:
        u = plan.local_slice(u, rank)
    count = nnz.to(u.device, torch.int64).clamp(min=1).unsqueeze(-1)
    pos = (u * count).to(torch.int64).minimum(count - 1)
    return pos.to(nnz.device)


def assemble_minibatch(sp: SparseProblem,
                       positions: torch.Tensor) -> SparseProblem:
    """The sampled store of ``positions`` ((p, q, batch) entry indices into
    each block's sorted prefix): deterministic torch ops on the store's
    device.

    Positions are sorted, so the batch inherits the store's row-sorted
    order; rows/cols/vals are gathered, ``row_ptr`` is the searchsorted of
    the sampled rows, ``col_perm`` a stable argsort of the sampled cols and
    ``col_ptr`` the searchsorted of the cols in that order.  A block with
    no entries gathers its padding: all slots invalid and nnz 0.  A
    repeated position is a repeated entry, summed as often as drawn."""

    ent = sp.entries
    batch = positions.shape[-1]
    mb, nb = sp.mb, sp.nb
    idx = positions.to(sp.device, torch.int64).sort(dim=-1).values
    rows = ent.rows.gather(-1, idx)
    cols = ent.cols.gather(-1, idx)
    vals = ent.vals.gather(-1, idx)
    ok = (sp.nnz > 0)
    valid = ok.to(torch.float32).unsqueeze(-1).expand_as(vals).contiguous()
    lead = rows.shape[:-1]

    def bounds(k):
        return torch.arange(k + 1, dtype=torch.int32,
                            device=sp.device).expand(*lead, k + 1).contiguous()

    row_ptr = torch.searchsorted(rows, bounds(mb)).to(torch.int32)
    perm = torch.argsort(cols, dim=-1, stable=True)
    col_ptr = torch.searchsorted(cols.gather(-1, perm).contiguous(),
                                 bounds(nb)).to(torch.int32)
    entries = BlockEntries(rows, cols, vals, valid, perm.to(torch.int32),
                           row_ptr, col_ptr)
    nnz = torch.where(ok, batch, 0).to(torch.int32)
    return SparseProblem(entries, nnz)


def sample_minibatch(generator: torch.Generator, sp: SparseProblem,
                     batch: int) -> SparseProblem:
    """Uniform with-replacement sample of ``batch`` observed entries per
    block, drawn from ``generator``: a SparseProblem of capacity ``batch``
    on the segment kernel's sorted layout (:func:`sample_positions`, then
    :func:`assemble_minibatch`).  The f-gradient of a minibatch estimates
    the full block's scaled by batch/nnz; :func:`minibatch_grad_scale`
    corrects it."""

    return assemble_minibatch(sp, sample_positions(generator, sp.nnz, batch))


def minibatch_grad_scale(sp: SparseProblem, batch: int) -> torch.Tensor:
    """(p, q) factor making minibatch f-gradients unbiased: nnz/batch."""

    return sp.nnz.to(torch.float32) / float(batch)


class MinibatchStream:
    """Stateless (step -> minibatch) sampler: ``batch_at(step)`` is a pure
    function of (seed, step), so a resumed fit replays the identical
    entry stream.  The step's positions come from a CPU ``torch.Generator``
    seeded from (seed, step), so the stream is the same on every device.

    ``plan`` (a ``MeshPlan``): ``sp`` is this rank's tile of the plan's
    grid, and every rank draws the global positions and keeps its tile
    (:func:`sample_positions`), so each block sees the same entries on
    every rank grid.  The per-block counts are read to the host once, here."""

    def __init__(self, sp: SparseProblem, batch: int, seed: int = 0,
                 plan=None):
        if batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        self.sp = sp
        self.batch = batch
        self.seed = int(seed)
        self.plan = None if plan is None or plan.is_single_device else plan
        self._nnz_host = sp.nnz.cpu()

    def positions_at(self, step: int) -> torch.Tensor:
        """Step ``step``'s (p, q, batch) positions, on the host."""

        g = torch.Generator(device="cpu")
        g.manual_seed(_step_seed(self.seed, step))
        return sample_positions(g, self._nnz_host, self.batch, self.plan)

    def batch_at(self, step: int) -> SparseProblem:
        return assemble_minibatch(self.sp, self.positions_at(step))
