"""The paper's objective (eq. 1–3) and its closed-form block gradients.

Port of ``repro.core.objective``.  State layout: all block factors live in
two stacked tensors

    U : (p, q, mb, r)     W : (p, q, nb, r)

f_ij  = ||M_ij ⊙ (X_ij − U_ij W_ijᵀ)||²_F            (observed entries only)
dU_ij = ||U_ij − U_i(j+1)||²_F                        (horizontal consensus)
dW_ij = ||W_ij − W_(i+1)j||²_F                        (vertical consensus)

The reported convergence cost (paper Table 2) is
    Σ_ij f_ij + λ‖U_ij‖² + λ‖W_ij‖².

The f-part of every gradient and cost goes through the layout's kernel
(``masked_factor_grad`` dense, ``kernels/sddmm`` sparse), one launch over
the whole stack of blocks; the rest is plain tensor code.
"""

from __future__ import annotations

from repro_torch.kernels.masked_factor_grad import ops as mfg_ops
from repro_torch.sparse import objective as sparse_obj
from repro_torch.sparse.store import SparseProblem


def block_residual(x, mask, u, w):
    """R = M ⊙ (X − U Wᵀ) for one block (or a stack)."""

    return mask * (x - u @ w.mT)


def f_grads(x, mask, u, w):
    """(f, gU, gW) for a block or a stack of blocks; closed form
    gU = −2 R W,  gW = −2 Rᵀ U."""

    return mfg_ops.masked_factor_grad(x, mask, u, w)


def f_cost(x, mask, u, w):
    return f_grads(x, mask, u, w)[0]


def total_report_cost(xb, maskb, U, W, lam: float):
    """Paper Table-2 cost: Σ f_ij + λ‖U_ij‖² + λ‖W_ij‖²."""

    return (f_cost(xb, maskb, U, W).sum() + lam * (U * U).sum()
            + lam * (W * W).sum())


def total_cost(problem, U, W, lam: float, *, method: str = "segment"):
    """Layout-dispatching Table-2 cost: dense ``Problem`` tensors or the
    padded-COO ``SparseProblem`` store (nnz-proportional)."""

    if isinstance(problem, SparseProblem):
        return sparse_obj.total_report_cost_sparse(problem, U, W, lam,
                                                   method=method)
    return total_report_cost(problem.xb, problem.maskb, U, W, lam)


def consensus_costs(U, W):
    """(Σ dU over horizontal pairs, Σ dW over vertical pairs) — diagnostics."""

    du = ((U[:, 1:] - U[:, :-1]) ** 2).sum()
    dw = ((W[1:] - W[:-1]) ** 2).sum()
    return du, dw


def full_objective(xb, maskb, U, W, rho: float, lam: float):
    """Eq. (3) with the normalization coefficients folded in:

        L = Σ_b [f_b + λ(‖U_b‖²+‖W_b‖²)] + ρ Σ_hpairs dU + ρ Σ_vpairs dW

    (see ``repro.core.objective.full_objective`` for the per-pair reading
    of Fig. 2)."""

    total = total_report_cost(xb, maskb, U, W, lam)
    du, dw = consensus_costs(U, W)
    return total + rho * (du + dw)


# ---------------------------------------------------------------------------
# Structure gradient (the SGD inner loop of Algorithm 1)
# ---------------------------------------------------------------------------


def structure_grads(x3, m3, u3, w3, cf3, cu_pair, cw_pair, *, rho: float,
                    lam: float):
    """Gradients of a structure's cost w.r.t. its three blocks' factors.

    Inputs are (..., 3, ...) stacks ordered (pivot, vert, horiz) as in
    :func:`repro_torch.core.grid.structure_blocks`; leading axes hold
    several structures (a wave).  ``cf3`` (..., 3) are the blocks'
    f-normalization coefficients; ``cu_pair``/``cw_pair`` (..., 2) the
    dU/dW coefficients for (pivot, horiz) and (pivot, vert).  Closed form:

      ∂f/∂U = −2 R W + 2 λ U          ∂dU/∂U_ij = 2 (U_ij − U_partner)
    """

    _, gu_f, gw_f = f_grads(x3, m3, u3, w3)
    return _finish_structure_grads(gu_f, gw_f, u3, w3, cf3, cu_pair,
                                   cw_pair, rho, lam)


def structure_grads_sparse(entries3, u3, w3, cf3, cu_pair, cw_pair, *,
                           rho: float, lam: float, method: str = "segment",
                           chunk: int | None = None):
    """Sparse-layout twin of :func:`structure_grads`: the blocks' f
    gradients come from their entry lists; the consensus/reg/normalization
    tail is the same."""

    _, gu_f, gw_f = sparse_obj.f_grads_sparse(entries3, u3, w3,
                                              method=method, chunk=chunk)
    return _finish_structure_grads(gu_f, gw_f, u3, w3, cf3, cu_pair,
                                   cw_pair, rho, lam)


def _finish_structure_grads(gu_f, gw_f, u3, w3, cf3, cu_pair, cw_pair, rho,
                            lam):
    """Shared tail of the structure gradient: λ-reg + Fig.-2 normalization +
    the two consensus pulls (identical for dense and sparse f-parts)."""

    # f + λ reg, per-block normalized
    gu = cf3[..., None, None] * (gu_f + 2.0 * lam * u3)
    gw = cf3[..., None, None] * (gw_f + 2.0 * lam * w3)
    # U consensus: pivot (index 0) <-> horiz (index 2)
    du = 2.0 * rho * (u3[..., 0, :, :] - u3[..., 2, :, :])
    gu[..., 0, :, :] += cu_pair[..., 0, None, None] * du
    gu[..., 2, :, :] -= cu_pair[..., 1, None, None] * du
    # W consensus: pivot (index 0) <-> vert (index 1)
    dw = 2.0 * rho * (w3[..., 0, :, :] - w3[..., 1, :, :])
    gw[..., 0, :, :] += cw_pair[..., 0, None, None] * dw
    gw[..., 1, :, :] -= cw_pair[..., 1, None, None] * dw
    return gu, gw


def gamma(t, a: float, b: float):
    """Paper step size γ_t = a / (1 + b t)."""

    return a / (1.0 + b * t)
