"""Sparse (nnz-proportional) evaluation of the paper's objective.

Port of ``repro.sparse.objective``.  The f-term and its factor gradients
come from the segment-sorted padded-COO store through the sparse kernels
(``kernels/sddmm``), one launch over the whole (p, q) stack; the consensus
and regularization terms only touch the factors and are plain tensor code.
Gradients agree with the dense masked path to float rounding.

``method="segment"`` (default) reduces contiguous CSR/CSC segments of the
sorted store; ``method="scatter"`` is the order-agnostic twin.  ``chunk``
only tunes the CPU path's segment reduce.  The cost is the f-kernel's loss
output, so on the card the cost, too, runs in the hand-written kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.sparse.store import SparseProblem


def f_grads_sparse(entries, u, w, *, method: str = "segment",
                   chunk: int | None = None):
    """(f, gU, gW) for a block or a stack of blocks from ``BlockEntries``."""

    if method == "scatter":
        return sddmm_ops.sddmm_factor_grad(entries, u, w)
    if method != "segment":
        raise ValueError(f"unknown method {method!r}; 'segment' or 'scatter'")
    return sddmm_ops.sddmm_segment_grad(entries, u, w, chunk=chunk)


def f_cost_sparse(entries, u, w, *, method: str = "segment"):
    """‖valid ⊙ (vals − ⟨U[rows], W[cols]⟩)‖² per block."""

    return f_grads_sparse(entries, u, w, method=method)[0]


def total_report_cost_sparse(sp: SparseProblem, U, W, lam: float, *,
                             method: str = "segment"):
    """Paper Table-2 cost Σ f_ij + λ‖U_ij‖² + λ‖W_ij‖², nnz-proportional."""

    f = f_cost_sparse(sp.entries, U, W, method=method)
    return f.sum() + lam * (U * U).sum() + lam * (W * W).sum()


def consensus_pulls(A: torch.Tensor, axis: int) -> torch.Tensor:
    """Σ of forward+backward neighbour pulls along a block-grid axis with
    zeros at the boundary: grad_consensus = 2ρ · consensus_pulls.  The one
    copy of this sign-sensitive stencil — the dense path uses it too."""

    d = torch.diff(A, dim=axis)                  # A[k+1] - A[k]
    zshape = list(A.shape)
    zshape[axis] = 1
    z = A.new_zeros(zshape)
    fwd = torch.cat([-d, z], dim=axis)           # A[k] - A[k+1]
    bwd = torch.cat([z, d], dim=axis)            # A[k] - A[k-1]
    return fwd + bwd


def full_gradients_sparse(sp: SparseProblem, U, W, *, rho: float,
                          lam: float, method: str = "segment",
                          chunk: int | None = None, f_scale=None):
    """∇L of the collapsed objective, f-part from the sparse store.

    ``f_scale`` ((p, q), minibatch rounds) multiplies only the f-part:
    with ``sp`` a sampled minibatch and ``f_scale = nnz/batch`` of the
    full store the stochastic gradient is unbiased; the consensus and
    regularization terms stay unscaled.  ``None`` leaves the expression
    as it is."""

    _, gu_f, gw_f = f_grads_sparse(sp.entries, U, W, method=method,
                                   chunk=chunk)
    if f_scale is not None:
        gu_f = gu_f * f_scale[..., None, None]
        gw_f = gw_f * f_scale[..., None, None]
    gU = gu_f + 2.0 * lam * U + 2.0 * rho * consensus_pulls(U, axis=1)
    gW = gw_f + 2.0 * lam * W + 2.0 * rho * consensus_pulls(W, axis=0)
    return gU, gW


def full_objective_sparse(sp: SparseProblem, U, W, rho: float, lam: float):
    """Eq. (3) collapsed objective (see core.objective.full_objective)."""

    total = total_report_cost_sparse(sp, U, W, lam)
    du = ((U[:, 1:] - U[:, :-1]) ** 2).sum()
    dw = ((W[1:] - W[:-1]) ** 2).sum()
    return total + rho * (du + dw)
