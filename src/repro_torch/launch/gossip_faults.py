"""Chaos bench through the port: gossip convergence under deterministic
fault injection.

The port's twin of ``benchmarks/gossip_faults.py``, with its flags, its
row fields and its loud failures.  Sweeps drop probability × staleness
bound on an R×C grid of ``torch.distributed`` ranks (one block a rank,
``--grid 2 2`` by default) and records, per cell, the held-out RMSE, the
final cost and the fault counters the fit streamed into
``repro_torch.obs``, plus two proof columns:

* ``p0_bit_identical``: the ``p_drop=0`` fault-path fit is bit-identical
  to the fault-free (``faults=None``) fit.
* ``rmse_vs_clean``: RMSE ratio against the fault-free fit at equal
  rounds.

Observed drop counts are checked against ``FaultPlan.replay`` masked to
the edges that exist (the same pure function the step evaluates):
injected == observed, or the bench fails.  ::

    python -m repro_torch.launch.gossip_faults [--rounds 60] \\
        [--drops 0,0.05,0.1,0.2] [--staleness-bounds 1,3] \\
        [--p-straggle 0.0] [--grid 2 2] [--json out.json] [--device cpu]

Every rank runs the sweep on its tile (``launch.gossip.run_on_grid``);
the rows are rank 0's, whose ``gossip_*`` counters are the grid's sums.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.data import lowrank_problem
from repro_torch.faults import FaultPlan, edges_exist
from repro_torch.launch.gossip import run_on_grid, shutdown
from repro_torch.mc import CompletionProblem, Gossip, Trainer
from repro_torch.mesh import MeshPlan

FAULT_COUNTERS = ("gossip_edges_dropped_total", "gossip_stale_rounds_total",
                  "gossip_straggled_edges_total")


def _counter_snapshot():
    snap = obs.snapshot()["counters"]
    return {k: snap.get(k, 0.0) for k in FAULT_COUNTERS}


def expected_drops(fp: FaultPlan, plan: MeshPlan, rounds: int) -> int:
    """Exact drop count from the replay, masked to the edges that exist on
    the plan's rank grid (boundary ranks have no outer neighbours)."""

    rp = fp.replay(rounds, plan.num_devices)
    return int((rp["drops"] & edges_exist(plan)[None]).sum())


def _sweep_rank(rank, device, rounds, drops, bounds, p_straggle, seed, grid):
    dr, dc = grid
    p, q = dr, dc
    m = n = 32 * max(p, q, 2)
    plan = MeshPlan.build(p, q, grid=grid)
    ds = lowrank_problem(m, n, 4, density=0.3, seed=seed)
    problem = CompletionProblem.from_dataset(ds, p, q, 4, layout="sparse",
                                             plan=plan, device=device)
    cfg = GossipMCConfig(m=m, n=n, p=p, q=q, rank=4)

    def fit(faults, max_staleness=3):
        return Trainer(cfg).fit(
            problem, Gossip(num_rounds=rounds, plan=plan, faults=faults,
                            max_staleness=max_staleness), seed=seed)

    clean = fit(None)
    clean_rmse = clean.rmse()

    rows = []
    p0_bit_identical = None
    for pd in drops:
        for bound in bounds:
            fp = FaultPlan(key=seed, p_drop_edge=pd, p_straggle=p_straggle)
            before = _counter_snapshot()
            res = fit(fp, max_staleness=bound)
            after = _counter_snapshot()
            counters = {k: after[k] - before[k] for k in FAULT_COUNTERS}

            if pd == 0.0 and p_straggle == 0.0 and p0_bit_identical is None:
                p0_bit_identical = bool(
                    np.array_equal(clean.state.U.cpu().numpy(),
                                   res.state.U.cpu().numpy())
                    and np.array_equal(clean.state.W.cpu().numpy(),
                                       res.state.W.cpu().numpy()))

            expected = expected_drops(fp, plan, rounds)
            got = counters["gossip_edges_dropped_total"]
            if got != expected:
                raise AssertionError(
                    f"fault replay mismatch at p_drop={pd}: observed "
                    f"{got} dropped edges, FaultPlan.replay says {expected}"
                )

            rmse = res.rmse()
            # synchronous-round critical path: a round with >=1 straggling
            # edge runs at straggler_scale; modelled, never slept
            p_round = 1.0 - (1.0 - p_straggle) ** max(plan.num_halo_edges, 1)
            rows.append({
                "p_drop": pd, "max_staleness": bound,
                "p_straggle": p_straggle, "rounds": rounds,
                "rmse": float(rmse), "final_cost": float(res.final_cost),
                "rmse_vs_clean": float(rmse / clean_rmse),
                "counters": counters,
                "expected_drops": expected,
                "sim_round_slowdown":
                    1.0 + p_round * (fp.straggler_scale - 1.0),
                "ms_per_round": 1e3 * res.wall_time / rounds,
            })
            if rank == 0:
                print(f"gossip_faults p_drop={pd} bound={bound}: "
                      f"rmse={rmse:.4f} ({rows[-1]['rmse_vs_clean']:.2f}x "
                      f"clean), dropped="
                      f"{counters['gossip_edges_dropped_total']:.0f}, "
                      f"stale_rounds="
                      f"{counters['gossip_stale_rounds_total']:.0f}",
                      flush=True)
    return {
        "grid": f"{p}x{q}", "devices": plan.num_devices, "m": m, "n": n,
        "clean_rmse": float(clean_rmse),
        "clean_final_cost": float(clean.final_cost),
        "p0_bit_identical": p0_bit_identical,
        "rows": rows,
        "metrics": obs.snapshot(),
    }


def run_sweep(rounds: int, drops: list[float], bounds: list[int],
              p_straggle: float, seed: int = 0, grid=(2, 2),
              device: str = "cuda", timeout: float = 900.0) -> dict:
    """The sweep on an R×C rank grid; rank 0's result."""

    return run_on_grid(_sweep_rank, tuple(grid), rounds, drops, bounds,
                       p_straggle, seed, tuple(grid), device=device,
                       timeout=timeout)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--drops", type=str, default="0,0.05,0.1,0.2")
    ap.add_argument("--staleness-bounds", type=str, default="1,3")
    ap.add_argument("--p-straggle", type=float, default=0.0)
    ap.add_argument("--grid", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    drops = [float(x) for x in args.drops.split(",")]
    bounds = [int(x) for x in args.staleness_bounds.split(",")]
    try:
        result = run_sweep(args.rounds, drops, bounds, args.p_straggle,
                           grid=args.grid, device=args.device)
    finally:
        shutdown()
    print(f"grid {result['grid']}: clean rmse {result['clean_rmse']:.4f}, "
          f"p_drop=0 bit-identical: {result['p0_bit_identical']}")
    if args.json:
        out = {"bench": "gossip_faults", "device": args.device,
               "config": {"rounds": args.rounds, "drops": drops,
                          "staleness_bounds": bounds,
                          "p_straggle": args.p_straggle,
                          "p_drop": max(drops), "grid": list(args.grid)},
               **result}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
