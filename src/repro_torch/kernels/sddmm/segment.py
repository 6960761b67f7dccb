"""Segment-sorted (CSR/CSC) SDDMM factor gradient — plain PyTorch version.

Port of ``repro.kernels.sddmm.segment``.  Operates on *row-sorted* padded
COO entries (``sparse/store.py``), one block or a stack of blocks: each
factor row's contributions form a contiguous segment delimited by
``row_ptr``; the column-sorted dual view is reached through ``col_perm``
with ``col_ptr`` offsets.  With factors U (..., M, r), W (..., N, r):

    e_k = valid_k · (vals_k − ⟨U[rows_k], W[cols_k]⟩)
    gU[m] = −2 Σ_{k ∈ [row_ptr[m], row_ptr[m+1])} e_k · W[cols_k]
    gW[n] = −2 Σ_{k' ∈ [col_ptr[n], col_ptr[n+1])} e_k' · U[rows_k']

The reduction is the reference's two-level chunked segment sum: per-chunk
totals, a chunk-prefix cumsum, and a triangular in-chunk correction at
each segment boundary.  It is the CPU path of ``ops.sddmm_segment_grad``
and the yardstick the CUDA kernel is held against; the main path never
calls it for a CUDA tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sddmm.ref import gather_rows

SEG_CHUNK = 32


def segment_reduce(contrib: torch.Tensor, ptr: torch.Tensor,
                   chunk: int = SEG_CHUNK) -> torch.Tensor:
    """Sum contiguous segments of ``contrib`` (..., E, r) delimited by
    ``ptr`` (..., S+1), non-decreasing with values in [0, E]; returns
    (..., S, r) with out[s] = Σ contrib[ptr[s]:ptr[s+1]]."""

    *lead, E, r = contrib.shape
    contrib = contrib.reshape(-1, E, r)
    ptr = ptr.reshape(contrib.shape[0], -1).long()
    nc = -(-E // chunk)
    pad = nc * chunk - E
    if pad:
        contrib = torch.nn.functional.pad(contrib, (0, 0, 0, pad))
    ch = contrib.reshape(-1, nc, chunk, r)
    cpre = torch.cat([contrib.new_zeros(ch.shape[0], 1, r),
                      torch.cumsum(ch.sum(2), 1)], 1)   # exclusive chunk prefix
    ci, ofs = ptr // chunk, ptr % chunk
    base = torch.take_along_dim(cpre, ci.unsqueeze(-1), dim=1)
    # a boundary at E on a chunk edge points one chunk past the end; its
    # in-chunk correction is empty (ofs == 0), so any chunk will do
    sel = torch.take_along_dim(
        ch, ci.clamp(max=nc - 1)[..., None, None], dim=1)    # (B, S+1, chunk, r)
    tri = (torch.arange(chunk, device=ptr.device) < ofs.unsqueeze(-1)).to(
        contrib.dtype)                                       # (B, S+1, chunk)
    s = base + torch.einsum("bsc,bscr->bsr", tri, sel)       # prefix at boundaries
    return (s[:, 1:] - s[:, :-1]).reshape(*lead, -1, r)


def sddmm_segment_grad_ref(entries, u, w, chunk: int | None = None):
    """(loss, gU, gW) from row-sorted entry lists; O(nnz·r).  ``chunk``
    overrides the segment-reduce chunk size (default ``SEG_CHUNK``); it
    changes nothing but float reassociation."""

    chunk = SEG_CHUNK if chunk is None else chunk
    uf, wf = u.float(), w.float()
    ue = gather_rows(uf, entries.rows)
    we = gather_rows(wf, entries.cols)
    e = entries.valid.float() * (entries.vals.float() - (ue * we).sum(-1))
    loss = (e * e).sum(-1)
    d = -2.0 * e.unsqueeze(-1)
    gu = segment_reduce(d * we, entries.row_ptr, chunk)
    cw = gather_rows(d * ue, entries.col_perm)
    gw = segment_reduce(cw, entries.col_ptr, chunk)
    return loss, gu.to(u.dtype), gw.to(w.dtype)
