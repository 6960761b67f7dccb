"""The MovieLens-1M streaming cell's warm refit in both packages, from one
base state, on the CPU.

    PYTHONPATH=src python scripts/refit_gap.py port --out DIR
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/refit_gap.py jax --out DIR

The cell is ``chip_smoke.py``'s ``[stream]`` cell: ``movielens_proxy()``
(6040 x 3706, 800k training ratings), 15% of the training ratings held
back as the stream (``launch/streaming.split``, seed 0), the rest ingested
with the stream's largest per-block count as headroom, mean-centred, a
5 x 5 grid, rank 15, rho = 1e3, lam = 1e-6, a = 2e-4, b = 5e-7.

``port`` (``repro_torch``, no JAX): 800 FullGD rounds on the base from
seed 0, the stream appended, then from that base state the two refits
(``Incremental``: 40 Wave rounds, seed 0; ``"full"``: 40 FullGD rounds);
it writes the base state to ``DIR/base.npz`` and prints the held-out RMSE
of each fit.  ``jax`` (the JAX package, no torch): the same cell, the
port's base state injected, the same two refits (JAX draws its own wave
order from its seed), their RMSEs.  Each mode imports only its own
package.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

P = Q = 5
RANK = 15
HP = dict(rho=1e3, lam=1e-6, a=2.0e-4, b=5.0e-7)
BASE_ROUNDS, REFIT_ROUNDS, STREAM_FRAC = 800, 40, 0.15


def cell(movielens_proxy):
    """(dataset, (rows, cols, vals), base and stream indices, headroom):
    the split of ``launch/streaming.split``."""

    ds = movielens_proxy()
    rr, cc = np.nonzero(ds.train_mask)
    vv = ds.x[rr, cc]
    perm = np.random.default_rng(0).permutation(len(rr))
    cut = int((1.0 - STREAM_FRAC) * len(rr))
    base, stream = perm[:cut], perm[cut:]
    m, n = ds.x.shape
    mb, nb = -(-m // P), -(-n // Q)
    blk = (rr[stream] // mb) * Q + cc[stream] // nb
    headroom = int(np.bincount(blk, minlength=P * Q).max())
    return ds, (rr, cc, vv), base, stream, headroom


def run_port(out: str) -> None:
    from repro_torch.config import GossipMCConfig
    from repro_torch.data import movielens_proxy
    from repro_torch.mc import CompletionProblem, FullGD, Trainer

    ds, (rr, cc, vv), base, stream, headroom = cell(movielens_proxy)
    problem = CompletionProblem.from_entries(
        rr[base], cc[base], vv[base], ds.x.shape, P, Q, RANK,
        headroom=headroom, mean_center=True, dataset=ds, device="cpu")
    cfg = GossipMCConfig(m=problem.spec.m, n=problem.spec.n, p=P, q=Q,
                         rank=RANK, **HP)
    trainer = Trainer(cfg)
    t0 = time.perf_counter()
    result = trainer.fit(problem, FullGD(num_rounds=BASE_ROUNDS), seed=0)
    print(f"port base: {BASE_ROUNDS} FullGD rounds in "
          f"{time.perf_counter() - t0:.1f}s, RMSE {result.rmse():.6f}",
          flush=True)
    grown = problem.append(rr[stream], cc[stream], vv[stream])
    np.savez(os.path.join(out, "base.npz"), U=result.state.U.numpy(),
             W=result.state.W.numpy(), t=int(result.state.t))
    for schedule in ("incremental", "full"):
        res = trainer.refit(result, grown, schedule,
                            num_rounds=REFIT_ROUNDS)
        print(f"port refit {schedule}: {REFIT_ROUNDS} rounds, RMSE "
              f"{res.rmse():.6f}, cost {res.final_cost:.6e}", flush=True)


def run_jax(out: str) -> None:
    import jax.numpy as jnp

    from repro.config import GossipMCConfig
    from repro.core.state import State
    from repro.data import movielens_proxy
    from repro.mc import CompletionProblem, Trainer

    ds, (rr, cc, vv), base, stream, headroom = cell(movielens_proxy)
    problem = CompletionProblem.from_entries(
        rr[base], cc[base], vv[base], ds.x.shape, P, Q, RANK,
        headroom=headroom, mean_center=True, dataset=ds)
    cfg = GossipMCConfig(m=problem.spec.m, n=problem.spec.n, p=P, q=Q,
                         rank=RANK, **HP)
    grown = problem.append(rr[stream], cc[stream], vv[stream])
    saved = np.load(os.path.join(out, "base.npz"))
    state = State(jnp.asarray(saved["U"]), jnp.asarray(saved["W"]),
                  jnp.asarray(int(saved["t"]), jnp.int32))
    trainer = Trainer(cfg)
    for schedule in ("incremental", "full"):
        # Trainer.refit is fit(problem, schedule, seed, state=result.state)
        res = trainer.fit(grown, schedule, seed=0, state=state,
                          num_rounds=REFIT_ROUNDS)
        print(f"jax refit {schedule} from the port's base state: "
              f"{REFIT_ROUNDS} rounds, RMSE {res.rmse():.6f}, cost "
              f"{res.final_cost:.6e}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=["port", "jax"])
    ap.add_argument("--out", required=True,
                    help="directory of the base state (written by port)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    (run_port if args.side == "port" else run_jax)(args.out)


if __name__ == "__main__":
    main()
