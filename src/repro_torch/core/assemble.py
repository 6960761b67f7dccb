"""Final culmination of block factors into global U, W + evaluation.

Port of ``repro.core.assemble``.  After convergence every grid row has
reached consensus in U and every column in W (paper §2); the factors are
combined by averaging across the consensus axis.  RMSE evaluation streams
index batches so the dense m×n product never materializes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.grid import GridSpec


def assemble(U: torch.Tensor, W: torch.Tensor,
             spec: GridSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """(p,q,mb,r), (p,q,nb,r) -> global (m,r), (n,r)."""

    u_rows = U.mean(1)                  # (p, mb, r) — consensus over cols
    w_cols = W.mean(0)                  # (q, nb, r) — consensus over rows
    return u_rows.reshape(spec.m, spec.r), w_cols.reshape(spec.n, spec.r)


def consensus_error(U: torch.Tensor, W: torch.Tensor) -> tuple[float, float]:
    """Max deviation from the per-row (per-col) consensus mean — diagnostics."""

    du = (U - U.mean(1, keepdim=True)).abs().max()
    dw = (W - W.mean(0, keepdim=True)).abs().max()
    return float(du), float(dw)


def rmse(u: torch.Tensor, w: torch.Tensor, rows, cols, vals,
         batch: int = 1_000_000) -> float:
    """RMSE of (U Wᵀ)[rows, cols] vs vals, streamed in index batches."""

    rows = torch.as_tensor(np.asarray(rows), device=u.device).long()
    cols = torch.as_tensor(np.asarray(cols), device=u.device).long()
    vals = torch.as_tensor(np.asarray(vals, np.float32), device=u.device)
    total = 0.0
    n = rows.shape[0]
    for s in range(0, n, batch):
        r, c, v = rows[s:s + batch], cols[s:s + batch], vals[s:s + batch]
        pred = (u[r] * w[c]).sum(-1)
        total += float(((pred - v) ** 2).sum())
    return float(np.sqrt(total / n))
