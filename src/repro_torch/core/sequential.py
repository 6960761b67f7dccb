"""Algorithm 1, verbatim: online sequential SGD over random structures.

Port of ``repro.core.sequential``.  One iteration = pick one structure
uniformly, compute the SGD gradient of its cost (with normalization
coefficients), update the three touched blocks with step size
γ_t = a/(1+bt).  The three blocks go through the f-gradient kernel in one
launch.  The structure indices are drawn from a ``torch.Generator`` on the
problem's device, so no iteration waits on the host.

The session entry point is ``repro_torch.mc.Trainer.fit(problem,
schedule="sequential")``, which runs :func:`_fit`.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import GossipMCConfig
from repro_torch.core import grid as G
from repro_torch.core import objective as obj
from repro_torch.core.state import Problem, State, Tables, build_tables
from repro_torch.sparse.store import SparseProblem


def sgd_structure_step(
    problem: Problem | SparseProblem,
    state: State,
    tables: Tables,
    s,
    *,
    rho: float,
    lam: float,
    a: float,
    b: float,
    method: str = "segment",
    chunk: int | None = None,
) -> State:
    """One Algorithm-1 iteration (lines 3–4) on structure ``s`` (an int
    or a 0-d index tensor)."""

    idx = tables.blocks[s].long()               # (3, 2)
    bi, bj = idx[:, 0], idx[:, 1]
    u3 = state.U[bi, bj]
    w3 = state.W[bi, bj]
    if isinstance(problem, SparseProblem):      # layout="sparse": O(nnz) f-part
        gu3, gw3 = obj.structure_grads_sparse(
            problem.entries.gather(bi, bj), u3, w3,
            tables.cf[s], tables.cu[s], tables.cw[s],
            rho=rho, lam=lam, method=method, chunk=chunk,
        )
    else:
        gu3, gw3 = obj.structure_grads(
            problem.xb[bi, bj], problem.maskb[bi, bj], u3, w3,
            tables.cf[s], tables.cu[s], tables.cw[s], rho=rho, lam=lam,
        )
    lr = obj.gamma(state.t.float(), a, b)
    U = state.U.index_put((bi, bj), -lr * gu3, accumulate=True)
    W = state.W.index_put((bi, bj), -lr * gw3, accumulate=True)
    return State(U, W, state.t + 1)


def run_chunk(
    problem: Problem | SparseProblem,
    state: State,
    tables: Tables,
    generator: torch.Generator,
    num_iters: int,
    cfg: GossipMCConfig,
    method: str = "segment",
    chunk: int | None = None,
) -> State:
    """``num_iters`` Algorithm-1 iterations, structures drawn uniformly."""

    picks = torch.randint(0, tables.blocks.shape[0], (num_iters,),
                          generator=generator, device=generator.device)
    for s in picks:
        state = sgd_structure_step(
            problem, state, tables, s,
            rho=cfg.rho, lam=cfg.lam, a=cfg.a, b=cfg.b,
            method=method, chunk=chunk,
        )
    return state


def _fit(
    problem: Problem | SparseProblem,
    spec: G.GridSpec,
    cfg: GossipMCConfig,
    generator: torch.Generator,
    *,
    state: State,
    num_iters: int,
    eval_every: int = 0,
    method: str = "segment",
    chunk: int | None = None,
    progress_cb: Callable[[int, float, State], None] | None = None,
) -> tuple[State, list[tuple[int, float]]]:
    """Run Algorithm 1 for ``num_iters`` iterations from ``state``,
    logging the paper's Table-2 cost every ``eval_every`` iterations;
    ``progress_cb(done, cost, state)`` fires at every eval boundary."""

    structures = G.enumerate_structures(spec.p, spec.q)
    tables = build_tables(spec.p, spec.q, structures, state.U.device)
    history: list[tuple[int, float]] = []
    eval_every = eval_every or num_iters
    done = 0
    while done < num_iters:
        step_n = min(eval_every, num_iters - done)
        state = run_chunk(problem, state, tables, generator, step_n, cfg,
                          method, chunk)
        done += step_n
        cost = float(obj.total_cost(problem, state.U, state.W, cfg.lam,
                                    method=method))
        history.append((done, cost))
        if progress_cb:
            progress_cb(done, cost, state)
    return state, history
