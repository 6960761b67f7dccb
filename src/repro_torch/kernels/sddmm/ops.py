"""Device-dispatching wrappers of the sparse f-gradient kernels.

Both take one ``BlockEntries`` bundle and factors with any leading batch
axes (one block, a structure's (3, ...) trio, a wave's (S, 3, ...) stack or
the whole (p, q, ...) grid) and return ``(loss, gU, gW)`` with the same
leading axes.  A CUDA tensor launches the hand-written kernel in
``kernels/csrc/sddmm.cu`` once over the whole stack; a CPU tensor runs the
plain version.  There is no size threshold and no fallback from the card.

    sddmm_segment_grad  sorted store (``method="segment"``): deterministic
                        segment sums over the CSR/CSC views
    sddmm_factor_grad   order-agnostic (``method="scatter"``): atomics on
                        the card, so gradients are held to a tolerance

Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sddmm.ref import sddmm_factor_grad_ref
from repro_torch.kernels.sddmm.segment import sddmm_segment_grad_ref

MAX_RANK = 256


def _shapes(entries, u, w):
    lead = tuple(u.shape[:-2])
    M, r = u.shape[-2:]
    N = w.shape[-2]
    E = entries.rows.shape[-1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank r={r} outside the kernels' range "
                         f"[1, {MAX_RANK}]")
    _build.expect(u, "U", torch.float32, (*lead, M, r))
    _build.expect(w, "W", torch.float32, (*lead, N, r))
    for name in ("rows", "cols"):
        _build.expect(getattr(entries, name), name, torch.int32, (*lead, E))
    for name in ("vals", "valid"):
        _build.expect(getattr(entries, name), name, torch.float32, (*lead, E))
    return lead, math.prod(lead), E, M, N, r


def sddmm_segment_grad(entries, u, w, *, chunk: int | None = None):
    """(loss, gU, gW) from row-sorted entries with their CSR/CSC aux.

    ``chunk`` only tunes the plain version's two-level reduce."""

    if not entries.has_sorted_aux:
        raise ValueError("sddmm_segment_grad needs the sorted store's "
                         "col_perm/row_ptr/col_ptr; use method='scatter' "
                         "for unsorted entries")
    if not _build.on_card(u, w, *entries):
        return sddmm_segment_grad_ref(entries, u, w, chunk=chunk)
    lead, B, E, M, N, r = _shapes(entries, u, w)
    _build.expect(entries.col_perm, "col_perm", torch.int32, (*lead, E))
    _build.expect(entries.row_ptr, "row_ptr", torch.int32, (*lead, M + 1))
    _build.expect(entries.col_ptr, "col_ptr", torch.int32, (*lead, N + 1))
    ins = [t.contiguous() for t in (*entries, u, w)]
    loss = torch.empty(lead, dtype=torch.float32, device=u.device)
    gu = torch.empty_like(ins[-2])
    gw = torch.empty_like(ins[-1])
    lib = _build.load("sddmm")
    e = torch.empty((B, E), dtype=torch.float32, device=u.device)
    partials = torch.empty((B, lib.sddmm_num_partials(B, E, r)),
                           dtype=torch.float32, device=u.device)
    rc = lib.sddmm_segment_grad(
        *(t.data_ptr() for t in (*ins, loss, gu, gw, e, partials)),
        B, E, M, N, r, torch.cuda.current_stream(u.device).cuda_stream)
    _build.check("sddmm_segment_grad", rc)
    sddmm_segment_grad.launches += 1
    return loss, gu, gw


def sddmm_factor_grad(entries, u, w):
    """(loss, gU, gW) from padded COO entries in any order; the sorted-aux
    fields, when present, are ignored."""

    fields = (entries.rows, entries.cols, entries.vals, entries.valid)
    if not _build.on_card(u, w, *fields):
        return sddmm_factor_grad_ref(entries, u, w)
    lead, B, E, M, N, r = _shapes(entries, u, w)
    ins = [t.contiguous() for t in (*fields, u, w)]
    loss = torch.empty(lead, dtype=torch.float32, device=u.device)
    gu = torch.empty_like(ins[-2])
    gw = torch.empty_like(ins[-1])
    lib = _build.load("sddmm")
    partials = torch.empty((B, lib.sddmm_num_partials(B, E, r)),
                           dtype=torch.float32, device=u.device)
    rc = lib.sddmm_factor_grad(
        *(t.data_ptr() for t in (*ins, loss, gu, gw, partials)),
        B, E, M, N, r, torch.cuda.current_stream(u.device).cuda_stream)
    _build.check("sddmm_factor_grad", rc)
    sddmm_factor_grad.launches += 1
    return loss, gu, gw


sddmm_segment_grad.launches = 0
sddmm_factor_grad.launches = 0
