"""Streaming ingestion through the port: append throughput, then a warm
refit against a cold fit.

The port's twin of ``benchmarks/streaming_ingest.py``: the two halves of
the online loop on one ``CompletionProblem``, the same flags with the same
defaults, the same rows.

* **append throughput** — ``CompletionProblem.append`` batches of held-back
  ratings spliced into the sorted padded-COO store (per-batch wall →
  entries/s), swept over batch sizes, each batch repeated against the same
  base store.  The store's capacity never changes.
* **refit vs cold fit** — ``Trainer.refit`` (the warm start) against a
  same-seed cold ``Trainer.fit`` on the grown problem: rounds, wall
  seconds and held-out RMSE of each.  ::

    python -m repro_torch.launch.streaming [--m 400] [--n 400] \\
        [--grid 4 4] [--rank 5] [--density 0.3] [--stream-frac 0.15] \\
        [--batches 100 1000 10000] [--headroom 2048] [--rounds 600] \\
        [--refit-rounds 150] [--device cpu]

``split``, ``ingest``, ``append_sweep`` and ``refit_vs_cold`` are the
pieces; ``chip_smoke.py`` calls them with the MovieLens-1M cell and its own
schedules.  Every wall time ends with a synchronize of the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.data import lowrank_problem
from repro_torch.mc import CompletionProblem, Incremental, Trainer, Wave
from repro_torch.mc.trainer import synchronize


def split(ds, stream_frac: float, seed: int = 0):
    """The training ratings as (rows, cols, vals) and a seeded split of
    their indices into (base, stream), the stream ``stream_frac`` of them."""

    rr, cc = np.nonzero(ds.train_mask)
    vv = ds.x[rr, cc]
    perm = np.random.default_rng(seed).permutation(len(rr))
    cut = int((1.0 - stream_frac) * len(rr))
    return (rr, cc, vv), (perm[:cut], perm[cut:])


def ingest(ds, coo, base, p: int, q: int, rank: int, *, headroom: int,
           mean_center: bool = False, device="cuda"):
    """(problem of the base ratings on the sparse layout, ms it took)."""

    rr, cc, vv = coo
    t0 = time.perf_counter()
    problem = CompletionProblem.from_entries(
        rr[base], cc[base], vv[base], ds.x.shape, p, q, rank,
        headroom=headroom, mean_center=mean_center, dataset=ds,
        device=device)
    synchronize(problem.device)
    return problem, (time.perf_counter() - t0) * 1e3


def append_sweep(problem, coo, stream, batches) -> list[dict]:
    """Per batch size: the first ``batch`` streamed ratings appended to
    ``problem`` ``max(3, 2000 // batch)`` times (timing only; every append
    starts from the same base store), ms per append and entries/s, and
    ``splice_ms``, the mean of the store's own ``ingest_append_seconds``
    over those appends (the rest of an append is the problem's: input
    checks, dedupe, centring, the seen table)."""

    rr, cc, vv = coo
    hist = obs.histogram("ingest_append_seconds")
    rows = []
    for batch in batches:
        take = stream[:batch] if batch <= len(stream) else stream
        reps = max(3, 2000 // max(len(take), 1))
        n0, s0 = hist.count, hist.sum
        t0 = time.perf_counter()
        for _ in range(reps):
            problem.append(rr[take], cc[take], vv[take])
        synchronize(problem.device)
        dt = (time.perf_counter() - t0) / reps
        rows.append({"batch": int(len(take)), "append_ms": dt * 1e3,
                     "entries_per_s": len(take) / max(dt, 1e-12),
                     "splice_ms": 1e3 * (hist.sum - s0)
                     / max(hist.count - n0, 1)})
    return rows


def _timed(problem, fn):
    synchronize(problem.device)
    t0 = time.perf_counter()
    res = fn()
    synchronize(problem.device)
    return res, time.perf_counter() - t0


def refit_vs_cold(problem, coo, stream, cfg, schedule, *,
                  refit_rounds: int | None = None, seed: int = 0) -> dict:
    """Fit ``problem`` with ``schedule``, append the stream, then refit
    (``Trainer.refit``'s default schedule, ``refit_rounds`` rounds when
    given) and cold-fit the grown problem with ``schedule`` from the same
    seed.  Returns the three ``FitResult``s, their rounds and wall
    seconds, the grown problem and the trainer."""

    rr, cc, vv = coo
    trainer = Trainer(cfg)
    result, t_fit = _timed(problem, lambda: trainer.fit(problem, schedule,
                                                        seed=seed))
    fresh = problem.append(rr[stream], cc[stream], vv[stream])
    kw = {} if refit_rounds is None else {"num_rounds": refit_rounds}
    refit, t_refit = _timed(problem, lambda: trainer.refit(result, fresh,
                                                           **kw))
    cold, t_cold = _timed(problem, lambda: trainer.fit(fresh, schedule,
                                                       seed=seed))
    n_refit = refit_rounds or Incremental().num_rounds
    return {"result": result, "refit": refit, "cold": cold, "fresh": fresh,
            "trainer": trainer,
            "rounds": {"initial fit": schedule.num_rounds,
                       "warm refit": n_refit,
                       "cold fit": schedule.num_rounds},
            "wall_s": {"initial fit": t_fit, "warm refit": t_refit,
                       "cold fit": t_cold}}


def print_appends(rows, n_stream: int) -> None:
    print(f"\nappend throughput ({n_stream} streamed entries held back):")
    print(f"{'batch':>8} {'ms':>9} {'entries/s':>12}")
    for row in rows:
        print(f"{row['batch']:8d} {row['append_ms']:9.2f} "
              f"{row['entries_per_s']:12,.0f}")


def print_refit(out: dict, n_stream: int) -> None:
    """The benchmark's refit-against-cold-fit table."""

    fits = {"initial fit": out["result"], "warm refit": out["refit"],
            "cold fit": out["cold"]}
    rounds = out["rounds"]
    print(f"\nrefit vs cold fit after appending {n_stream} entries:")
    print(f"{'':>12} {'rounds':>7} {'wall_s':>8} {'rmse':>9}")
    for label, res in fits.items():
        print(f"{label:>12} {rounds[label]:7d} {out['wall_s'][label]:8.1f} "
              f"{res.rmse():9.4f}")
    t_cold, t_refit = out["wall_s"]["cold fit"], out["wall_s"]["warm refit"]
    gap = out["refit"].rmse() - out["cold"].rmse()
    print(f"refit speedup {t_cold / max(t_refit, 1e-9):.1f}x wall at "
          f"{rounds['warm refit']}/{rounds['cold fit']} rounds, rmse gap "
          f"{gap:+.2e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=400)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--grid", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--stream-frac", type=float, default=0.15)
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[100, 1000, 10000],
                    help="append batch sizes to sweep")
    ap.add_argument("--headroom", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--refit-rounds", type=int, default=None,
                    help="default rounds//4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p, q = args.grid
    refit_rounds = args.refit_rounds or max(args.rounds // 4, 1)
    ds = lowrank_problem(args.m, args.n, args.rank, density=args.density,
                         seed=0)
    coo, (base, stream) = split(ds, args.stream_frac)
    problem, ingest_ms = ingest(ds, coo, base, p, q, args.rank,
                                headroom=args.headroom, device=args.device)
    print(f"matrix {args.m}x{args.n} grid {p}x{q} rank {args.rank} "
          f"(device={problem.device})")
    print(f"ingest: {len(base)} entries in {ingest_ms:.1f}ms, capacity "
          f"{problem.data.capacity}/block, headroom {args.headroom}")
    print_appends(append_sweep(problem, coo, stream, args.batches),
                  len(stream))
    cfg = GossipMCConfig(m=problem.spec.m, n=problem.spec.n, p=p, q=q,
                         rank=args.rank, a=1e-3, b=1e-5, rho=1e2)
    out = refit_vs_cold(problem, coo, stream, cfg,
                        Wave(num_rounds=args.rounds),
                        refit_rounds=refit_rounds)
    print_refit(out, len(stream))


if __name__ == "__main__":
    main()
