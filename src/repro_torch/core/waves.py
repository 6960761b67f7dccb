"""Parallel wave scheduler and the deterministic full-gradient step.

Port of ``repro.core.waves``.  All structures are partitioned into ≤8
parity waves (grid.wave_schedule); within a wave no block is shared, so a
whole wave's structure updates are one conflict-free step: the wave's
S·3 blocks go through the f-gradient kernel in one launch (the
reference's ``jax.vmap`` over structures).  One *round* = all waves in
random order.  ``t`` advances by the number of structure updates, so the
γ_t schedule matches the sequential algorithm's per-update decay.

``full_gradient_step`` is the deterministic limit (all structures at once
= gradient descent on the collapsed objective L): one kernel launch over
all p·q blocks per step.

The session entry point is ``repro_torch.mc.Trainer.fit(problem,
schedule="wave" | "full")``, which runs :func:`_fit`.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import GossipMCConfig
from repro_torch.core import grid as G
from repro_torch.core import objective as obj
from repro_torch.core.state import Problem, State, Tables, build_tables
from repro_torch.sparse import objective as sparse_obj
from repro_torch.sparse.store import SparseProblem


def wave_tables(p: int, q: int, device) -> list[Tables]:
    return [build_tables(p, q, w, device) for w in G.wave_schedule(p, q)]


def wave_step(
    problem: Problem | SparseProblem,
    state: State,
    tables: Tables,
    *,
    rho: float,
    lam: float,
    a: float,
    b: float,
    method: str = "segment",
    chunk: int | None = None,
) -> State:
    """Update every structure of one wave in parallel."""

    idx = tables.blocks.long()                        # (S, 3, 2)
    bi, bj = idx[..., 0], idx[..., 1]                 # (S, 3)
    u3 = state.U[bi, bj]
    w3 = state.W[bi, bj]
    if isinstance(problem, SparseProblem):            # layout="sparse"
        gu3, gw3 = obj.structure_grads_sparse(
            problem.entries.gather(bi, bj), u3, w3,
            tables.cf, tables.cu, tables.cw,
            rho=rho, lam=lam, method=method, chunk=chunk,
        )
    else:
        gu3, gw3 = obj.structure_grads(
            problem.xb[bi, bj], problem.maskb[bi, bj], u3, w3,
            tables.cf, tables.cu, tables.cw, rho=rho, lam=lam,
        )
    lr = obj.gamma(state.t.float(), a, b)
    # blocks within a wave are pairwise distinct -> conflict-free update
    U = state.U.index_put((bi, bj), -lr * gu3, accumulate=True)
    W = state.W.index_put((bi, bj), -lr * gw3, accumulate=True)
    return State(U, W, state.t + idx.shape[0])


# ---------------------------------------------------------------------------
# Deterministic full-gradient step (= sum of all waves)
# ---------------------------------------------------------------------------


def full_gradients(
    problem: Problem | SparseProblem, U: torch.Tensor, W: torch.Tensor, *,
    rho: float, lam: float, method: str = "segment",
    chunk: int | None = None,
):
    """∇L of the collapsed objective (objective.full_objective).

    Accepts either layout; a SparseProblem routes the f-part through the
    nnz-proportional sparse kernels with identical consensus/reg terms."""

    if isinstance(problem, SparseProblem):
        return sparse_obj.full_gradients_sparse(
            problem, U, W, rho=rho, lam=lam, method=method, chunk=chunk,
        )
    _, gu_f, gw_f = obj.f_grads(problem.xb, problem.maskb, U, W)
    gU = gu_f + 2.0 * lam * U + 2.0 * rho * sparse_obj.consensus_pulls(U, axis=1)
    gW = gw_f + 2.0 * lam * W + 2.0 * rho * sparse_obj.consensus_pulls(W, axis=0)
    return gU, gW


def full_gradient_step(
    problem: Problem | SparseProblem, state: State, *,
    rho: float, lam: float, a: float, b: float,
    method: str = "segment", chunk: int | None = None,
) -> State:
    """One GD step on L.  The consensus part of the step is damped by 1/2
    (a block can be pulled by two pairs per axis; the paper's hyper-params
    put γ·2ρ at exactly 1 per pair, so the undamped full step would
    oscillate — sequential/wave modes never stack pairs, full mode does)."""

    n_struct = 2 * (state.U.shape[0] - 1) * (state.U.shape[1] - 1)
    gU, gW = full_gradients(problem, state.U, state.W, rho=rho * 0.5,
                            lam=lam, method=method, chunk=chunk)
    lr = obj.gamma(state.t.float(), a, b)
    return State(state.U - lr * gU, state.W - lr * gW, state.t + n_struct)


def full_gd_rounds(problem: Problem | SparseProblem, state: State, *,
                   rounds: int, rho: float, lam: float, a: float, b: float,
                   method: str = "segment",
                   chunk: int | None = None) -> State:
    """``rounds`` deterministic full-GD steps."""

    for _ in range(rounds):
        state = full_gradient_step(problem, state, rho=rho, lam=lam, a=a,
                                   b=b, method=method, chunk=chunk)
    return state


def _fit(
    problem: Problem | SparseProblem,
    spec: G.GridSpec,
    cfg: GossipMCConfig,
    generator: torch.Generator,
    *,
    state: State,
    num_rounds: int,
    eval_every: int = 0,
    mode: str = "wave",
    method: str = "segment",
    chunk: int | None = None,
    progress_cb: Callable[[int, float, State], None] | None = None,
) -> tuple[State, list[tuple[int, float]]]:
    """Run ``num_rounds`` rounds of wave (or full-GD) updates from
    ``state``.

    One round ≈ num_structures sequential iterations of Algorithm 1; the
    cost history is reported against the equivalent sequential iteration
    count ``t``.  The wave order of each round is drawn from
    ``generator``; ``progress_cb(round, cost, state)`` fires at every eval
    boundary."""

    tables = wave_tables(spec.p, spec.q, state.U.device)
    history: list[tuple[int, float]] = []
    eval_every = eval_every or num_rounds

    for rd in range(num_rounds):
        if mode == "full":
            state = full_gradient_step(
                problem, state, rho=cfg.rho, lam=cfg.lam, a=cfg.a, b=cfg.b,
                method=method, chunk=chunk,
            )
        else:
            order = torch.randperm(len(tables), generator=generator,
                                   device=generator.device).tolist()
            for w in order:
                state = wave_step(
                    problem, state, tables[w],
                    rho=cfg.rho, lam=cfg.lam, a=cfg.a, b=cfg.b,
                    method=method, chunk=chunk,
                )
        if (rd + 1) % eval_every == 0 or rd == num_rounds - 1:
            cost = float(obj.total_cost(problem, state.U, state.W, cfg.lam,
                                        method=method))
            history.append((int(state.t), cost))
            if progress_cb:
                progress_cb(rd + 1, cost, state)
    return state, history
