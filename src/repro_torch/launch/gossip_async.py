"""Round-time vs RMSE frontier through the port: asynchronous stochastic
gossip (DESIGN.md §15) against synchronous full-gradient rounds at equal
wall-clock budget.

The port's twin of ``benchmarks/gossip_async.py``, with its flags, its
row fields and its loud failures, on an R×C grid of ``torch.distributed``
ranks (one block a rank, ``--grid 2 2`` by default).  Three arms on the
same plan-placed sparse problem:

* ``sync_full`` — synchronous full-gradient rounds; its wall time is the
  budget every other arm must fit inside.
* ``sync_minibatch`` — stochastic rounds (``batch=``), exchange every
  round.
* ``async_minibatch`` — stochastic rounds with the ``exchange_every``
  clock, one arm per ``e``.

Each stochastic arm gets its rounds from a two-point calibration (slope =
marginal round cost, intercept = per-fit fixed cost), so the frontier
compares equal wall clock, not equal rounds.  Every rank times every fit
and the grid takes the slowest rank's time (one ``all_reduce``), so all
ranks pick the same round counts.  Proof columns:

* ``async_e1_bit_identical``: ``exchange_every=1, max_staleness=0,
  batch=None`` is bit-identical to the synchronous step.
* per-arm ``counters``: ``skipped == rounds - ceil(rounds/e)`` exactly,
  or the bench fails.  ::

    python -m repro_torch.launch.gossip_async [--rounds R] [--batch B] \\
        [--exchange-every 2,4] [--smoke] [--grid 2 2] [--json out.json] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.data import lowrank_problem
from repro_torch.launch.gossip import run_on_grid, shutdown
from repro_torch.mc import CompletionProblem, Gossip, Trainer
from repro_torch.mesh import MeshPlan

ARM_COUNTERS = ("train_gossip_rounds_total", "train_gossip_halo_bytes_total",
                "gossip_skipped_exchanges_total", "gossip_stale_rounds_total")


def _counter_snapshot():
    snap = obs.snapshot()["counters"]
    return {k: snap.get(k, 0.0) for k in ARM_COUNTERS}


def check_skips(name: str, rounds: int, e: int, counters: dict) -> None:
    """The exact skip accounting of an async arm: ``rounds -
    ceil(rounds / e)`` skipped exchanges, or ``AssertionError``."""

    want = rounds - -(-rounds // e)
    got = int(counters["gossip_skipped_exchanges_total"])
    if got != want:
        raise AssertionError(
            f"{name}: skip accounting off — observed {got} skipped "
            f"exchanges over {rounds} rounds at e={e}, schedule says {want}")


def _slowest(seconds: float, plan: MeshPlan) -> float:
    """The slowest rank's seconds (every rank gets the same number)."""

    if plan.is_single_device:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def _frontier_rank(rank, device, smoke, rounds_sync, batch, exchange_every,
                   seed, grid):
    p, q = grid
    if smoke:
        m = n = 128 * max(p, q, 2)
        r, density = 8, 0.3
        batch = batch or 512
        rounds_sync = rounds_sync or 8
    else:
        # full-gradient rounds must be compute-bound (nnz/block >> batch)
        # for the frontier to measure gradient economics, not dispatch
        m = n = 1024 * max(p, q, 2)
        r, density = 16, 0.3
        batch = batch or 8192
        rounds_sync = rounds_sync or 16
    plan = MeshPlan.build(p, q, grid=grid)
    ds = lowrank_problem(m, n, r, density=density, seed=seed)
    problem = CompletionProblem.from_dataset(ds, p, q, r, layout="sparse",
                                             plan=plan, device=device)
    cfg = GossipMCConfig(m=m, n=n, p=p, q=q, rank=r)
    nnz_per_block = float(problem.data.nnz.float().mean())

    def fit(R, **kw):
        t0 = time.perf_counter()
        res = Trainer(cfg).fit(
            problem, Gossip(num_rounds=R, plan=plan, **kw), seed=seed)
        return res, _slowest(time.perf_counter() - t0, plan)

    def measured_arm(name, R, budget=None, fixed=0.0, **kw):
        before = _counter_snapshot()
        res, wall = fit(R, **kw)
        if budget is not None and wall > 1.05 * budget and wall > fixed:
            # calibration under-billed the marginal round cost and the arm
            # overshot its wall budget: rescale on the measured marginal
            # cost and re-run once (equal wall clock is the claim)
            R = max(4, int(R * max(budget - fixed, 0.1 * budget)
                           / (wall - fixed)))
            before = _counter_snapshot()
            res, wall = fit(R, **kw)
        after = _counter_snapshot()
        counters = {k: after[k] - before[k] for k in ARM_COUNTERS}
        e = kw.get("exchange_every", 1)
        if kw.get("async_rounds"):
            check_skips(name, R, e, counters)
        rmse = float(res.rmse())
        row = {"arm": name, "rounds": R, "wall_seconds": wall,
               "ms_per_round": wall / R * 1e3, "rmse": rmse,
               "final_cost": float(res.final_cost), "batch": kw.get("batch"),
               "exchange_every": e if kw.get("async_rounds") else 1,
               "counters": counters}
        if rank == 0:
            print(f"gossip_async {name}: {R} rounds {wall:.2f}s "
                  f"({row['ms_per_round']:.1f} ms/rd) rmse={rmse:.4f}",
                  flush=True)
        return row

    def rounds_for(budget, cal_lo, cal_hi, **kw):
        """Two-point calibration -> (rounds, fixed) for the wall budget."""
        _, t_lo = fit(cal_lo, **kw)
        _, t_hi = fit(cal_hi, **kw)
        slope = max((t_hi - t_lo) / float(cal_hi - cal_lo), 1e-4)
        fixed = max(t_lo - cal_lo * slope, 0.0)
        rounds = max(4, min(16 * rounds_sync, int((budget - fixed) / slope)))
        return rounds, fixed

    # load both step variants off the clock
    fit(2)
    fit(2, batch=batch)

    rows = [measured_arm("sync_full", rounds_sync)]
    budget = rows[0]["wall_seconds"]
    cal = (max(2, rounds_sync // 2), max(4, rounds_sync))

    R, fixed = rounds_for(budget, *cal, batch=batch)
    rows.append(measured_arm("sync_minibatch", R, budget=budget,
                             fixed=fixed, batch=batch))
    for e in exchange_every:
        kw = dict(batch=batch, async_rounds=True, exchange_every=e,
                  max_staleness=e)
        fit(2, **kw)
        R, fixed = rounds_for(budget, *cal, **kw)
        rows.append(measured_arm(f"async_minibatch_e{e}", R, budget=budget,
                                 fixed=fixed, **kw))

    # proof: degenerate async == sync, bit for bit
    a, _ = fit(8)
    b, _ = fit(8, async_rounds=True, exchange_every=1, max_staleness=0)
    bit_identical = bool(torch.equal(a.state.U, b.state.U)
                         and torch.equal(a.state.W, b.state.W))

    sync_rmse = rows[0]["rmse"]
    in_budget = [row for row in rows[1:]
                 if row["wall_seconds"] <= 1.1 * budget]
    best = min(in_budget or rows[1:], key=lambda row: row["rmse"])
    dominates = bool(best["rmse"] <= sync_rmse
                     and best["wall_seconds"] <= 1.1 * budget)
    if rank == 0:
        print(f"gossip_async: budget {budget:.2f}s, sync rmse "
              f"{sync_rmse:.4f}, best stochastic arm {best['arm']} rmse "
              f"{best['rmse']:.4f} ({best['wall_seconds']:.2f}s), e1 "
              f"bit-identical: {bit_identical}", flush=True)
    return {
        "grid": f"{p}x{q}", "devices": plan.num_devices, "m": m, "n": n,
        "rank": r, "density": density, "nnz_per_block": nnz_per_block,
        "budget_seconds": budget, "async_e1_bit_identical": bit_identical,
        "stochastic_dominates": dominates, "rows": rows,
        "metrics": obs.snapshot(),
    }


def run_frontier(smoke: bool, rounds_sync: int | None, batch: int | None,
                 exchange_every: list[int], seed: int = 0, grid=(2, 2),
                 device: str = "cuda", timeout: float = 1800.0) -> dict:
    """The frontier on an R×C rank grid; rank 0's result."""

    return run_on_grid(_frontier_rank, tuple(grid), smoke, rounds_sync,
                       batch, list(exchange_every), seed, tuple(grid),
                       device=device, timeout=timeout)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="sync full-gradient anchor rounds (sets the budget)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--exchange-every", type=str, default="2,4")
    ap.add_argument("--smoke", action="store_true",
                    help="small scale: envelope/counter checks only, no "
                    "dominance claim")
    ap.add_argument("--grid", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    es = [int(x) for x in args.exchange_every.split(",")]
    try:
        result = run_frontier(args.smoke, args.rounds, args.batch, es,
                              grid=args.grid, device=args.device)
    finally:
        shutdown()

    if not result["async_e1_bit_identical"]:
        raise AssertionError("async e=1 s=0 is not bit-identical to sync")
    if not args.smoke and not result["stochastic_dominates"]:
        raise AssertionError(
            "stochastic rounds did not dominate sync full-gradient rounds "
            f"at equal wall clock: {result['rows']}")

    if args.json:
        out = {"bench": "gossip_async", "device": args.device,
               "config": {"rounds_sync": result["rows"][0]["rounds"],
                          "batch": result["rows"][1]["batch"],
                          "exchange_every": max(es), "async_rounds": True,
                          "smoke": args.smoke, "grid": list(args.grid)},
               **result}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
