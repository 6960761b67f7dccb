"""Plain PyTorch version of the sparse (SDDMM) factor gradient, scatter form.

Port of ``repro.kernels.sddmm.ref``.  Operates on padded COO entries passed
as one ``BlockEntries`` bundle, for one block or a stack of blocks (any
leading batch axes, shared by the entries and the factors).  With factors
U (..., M, r), W (..., N, r):

    e_k     = valid_k · (vals_k − ⟨U[rows_k], W[cols_k]⟩)
    f       = Σ_k e_k²
    gU      = −2 · scatter_add_rows(e_k · W[cols_k])
    gW      = −2 · scatter_add_cols(e_k · U[rows_k])

The sorted-aux fields are ignored — this path is order-agnostic.  It is the
CPU path of ``ops.sddmm_factor_grad`` and the yardstick the CUDA kernel is
held against; the main path never calls it for a CUDA tensor.
"""

from __future__ import annotations

import torch


def gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., M, r) gathered at idx (..., E) along M -> (..., E, r)."""

    return torch.take_along_dim(a, idx.long().unsqueeze(-1), dim=-2)


def sddmm_residuals(entries, u, w):
    """Residuals at the observed entries only: (..., E) float32."""

    pred = (gather_rows(u.float(), entries.rows)
            * gather_rows(w.float(), entries.cols)).sum(-1)
    return entries.valid.float() * (entries.vals.float() - pred)


def sddmm_factor_grad_ref(entries, u, w):
    """(loss, gU, gW) from the padded entry list; nnz-proportional."""

    uf, wf = u.float(), w.float()
    ue = gather_rows(uf, entries.rows)                 # (..., E, r)
    we = gather_rows(wf, entries.cols)
    e = entries.valid.float() * (entries.vals.float() - (ue * we).sum(-1))
    loss = (e * e).sum(-1)
    d = -2.0 * e.unsqueeze(-1)
    r = uf.shape[-1]
    ridx = entries.rows.long().unsqueeze(-1).expand(*ue.shape[:-1], r)
    cidx = entries.cols.long().unsqueeze(-1).expand(*we.shape[:-1], r)
    gu = torch.zeros_like(uf).scatter_add_(-2, ridx, d * we)
    gw = torch.zeros_like(wf).scatter_add_(-2, cidx, d * ue)
    return loss, gu.to(u.dtype), gw.to(w.dtype)
