"""Paper Table 2 through the port: synthetic convergence of Exp#1–#6.

The port's twin of ``benchmarks/table2_synthetic.py``: one
``CompletionProblem`` per experiment (dense layout), one ``Trainer``
warm-started across the paper's iteration checkpoints with the
deterministic ``FullGD`` schedule (the same objective and the same γ_t
decay per structure update as the sequential algorithm).  Exp#5/#6
(5000²/10000²) run reduced horizons unless ``full``.  ::

    python -m repro_torch.launch.paper_tables [--full] [--device cpu]

prints one ``table2_<name>,<us per iter>,t0=…;t80000=…`` row per
experiment, as the JAX benchmark does.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.gossip_mc import EXPERIMENTS
from repro_torch.core.state import State, init_state
from repro_torch.data import lowrank_problem
from repro_torch.mc import CompletionProblem, FullGD, Trainer
from repro_torch.mc.trainer import synchronize

CHECKPOINTS = (80_000, 160_000, 240_000, 280_000, 400_000)
REDUCED_CHECKPOINTS = (10_000, 20_000)   # m >= 5000 without ``full``


def checkpoints_for(name: str, full: bool = False) -> tuple[int, ...]:
    if not full and EXPERIMENTS[name].m >= 5000:
        return REDUCED_CHECKPOINTS
    return CHECKPOINTS


def run_experiment(name: str, full: bool = False, *, device="cuda",
                   state: State | None = None,
                   checkpoints: tuple[int, ...] | None = None,
                   problem: CompletionProblem | None = None):
    """(rows, wall seconds, final ``State``) of one experiment: ``rows``
    is ``[(t, cost), ...]`` from t = 0 to the last checkpoint.

    ``state`` injects the initial factors (parity tests hand the JAX
    package's), else they come from ``init_state`` on a generator of the
    device seeded with the preset's seed.  ``checkpoints`` overrides the
    paper's; ``problem`` reuses a problem already built."""

    cfg = EXPERIMENTS[name]
    if checkpoints is None:
        checkpoints = checkpoints_for(name, full)
    if problem is None:
        ds = lowrank_problem(cfg.m, cfg.n, cfg.rank, density=cfg.density,
                             seed=1)
        problem = CompletionProblem.from_dataset(ds, cfg.p, cfg.q, cfg.rank,
                                                 device=device)
    n_struct = problem.spec.num_structures

    trainer = Trainer(cfg)
    if state is None:
        gen = torch.Generator(device=problem.device).manual_seed(cfg.seed)
        state = init_state(gen, problem.spec)
    rows = [(0, problem.total_cost(state, cfg.lam))]
    synchronize(problem.device)
    t0 = time.perf_counter()
    for target_t in checkpoints:
        rounds = max(1, (target_t - int(state.t)) // n_struct)
        res = trainer.fit(problem, FullGD(num_rounds=rounds,
                                          eval_every=rounds), state=state)
        state = res.state
        rows.append((res.t, res.final_cost))
    synchronize(problem.device)
    return rows, time.perf_counter() - t0, state


def row(name: str, rows, wall: float) -> str:
    """The benchmark's ``table2_<name>,<us per iter>,<trajectory>`` line."""

    per_iter_us = wall * 1e6 / max(rows[-1][0], 1)
    traj = ";".join(f"t{t}={c:.3e}" for t, c in rows)
    return f"table2_{name},{per_iter_us:.3f},{traj}"


def main(full: bool = False, device="cuda"):
    names = list(EXPERIMENTS)
    if not full:
        names = [n for n in names if EXPERIMENTS[n].m < 10000]
    for name in names:
        rows, wall, _ = run_experiment(name, full, device=device)
        print(row(name, rows, wall))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's horizons for Exp#5/#6, and Exp#6")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(full=args.full, device=args.device)
