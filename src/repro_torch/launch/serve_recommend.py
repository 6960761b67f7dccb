"""Top-k serving throughput through the port, whole or item-sharded over a
grid of ranks.

The port's twin of ``benchmarks/serve_recommend.py``: batched masked
top-k through ``RecommendService`` on a MovieLens-scale index, the same
flags with the same defaults, the same lines (users/s, scores/s, the
service's p50/p99 and the item-shard count).  Index sources:

* default: random factors at the requested shape (serving cost does not
  depend on factor values);
* ``--from-fit``: a ``movielens_proxy`` fit through ``Trainer.fit``
  (``Wave``; under ``--sharded``, ``Gossip`` on the grid) and
  ``FitResult.to_recommend_index``;
* ``--sharded``: R·C ranks (``--grid``) through
  ``launch.gossip.run_on_grid``, the catalog's item axis sharded over
  them (``RecommendService(plan=)``, the two-stage top-k); rank 0 prints.
* ``--engine``: serving straight from a grid fit through
  ``ServingEngine`` (:func:`serve_fit_rank`, int8 and f32) on the
  ``--grid`` ranks, over :func:`serve_requests`' requests, held against
  the unsharded engine; then the grid engine's two collectives alone
  (:func:`collective_floor`).  Prints one JSON line per part and exits
  non-zero when an answer disagrees.  With a card for every rank the
  grid's default group is ``nccl``, else ``gloo`` (``launch/gossip.py``).
  ::

    python -m repro_torch.launch.serve_recommend [--users 6040] \\
        [--items 3706] [--rank 16] [--batch 256] [--k 10] [--iters 50] \\
        [--density 0.02] [--from-fit] [--rounds 30] [--sharded] \\
        [--engine] [--grid 2 2] [--json PATH] [--device cpu]

:func:`serve_fit_rank` is the grid's rank body for serving straight from
a grid fit: every rank builds its tile from a ``ProblemRecipe``, fits
``Gossip``, and builds ``FitResult.to_engine()`` (its item shard); rank 0
sends the requests, with one hot refresh (from a longer fit) between
them, and holds the answers against the unsharded engine over the same
factors.  ``chip_smoke.py`` and the tests run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.core.gossip import host_collectives
from repro_torch.core.state import resolve_device
from repro_torch.data import movielens_proxy
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.launch.gossip import ProblemRecipe, run_on_grid
from repro_torch.mc import CompletionProblem, Gossip, Trainer, Wave
from repro_torch.mesh import MeshPlan, current_rank
from repro_torch.serve.recommend import (RecommendIndex, RecommendService,
                                        build_seen_table)
from repro_torch.serving import DEFAULT_BUCKETS, ServingEngine
from repro_torch.serving.engine import GRID_TIMEOUT

HP = dict(rho=1e3, lam=1e-6, a=2.0e-4, b=5.0e-7)
RTOL = 1e-5         # f32 grid engine's scores against the unsharded engine


def random_index(users: int, items: int, rank: int, density: float,
                 device) -> RecommendIndex:
    """Seeded random factors and a seen table of the given density."""

    rng = np.random.default_rng(0)
    u = rng.normal(size=(users, rank)).astype(np.float32)
    w = rng.normal(size=(items, rank)).astype(np.float32)
    mask = (rng.random((users, items)) < density).astype(np.float32)
    seen = build_seen_table(mask, items)
    return RecommendIndex(*(torch.from_numpy(a).to(device)
                            for a in (u, w, seen)))


def _proxy_problem(args, plan, device) -> CompletionProblem:
    ds = movielens_proxy(num_users=args.users, num_items=args.items,
                         num_ratings=int(args.users * args.items
                                         * args.density), seed=0)
    return CompletionProblem.from_dataset(
        ds, 4, 4, args.rank, layout="sparse", mean_center=True, plan=plan,
        device=device)


def fitted_index(args, plan, device) -> RecommendIndex:
    """The proxy fitted for ``args.rounds`` rounds: ``Wave`` alone,
    ``Gossip`` on a grid (``plan``)."""

    problem = _proxy_problem(args, plan, device)
    spec = problem.spec
    cfg = GossipMCConfig(m=spec.m, n=spec.n, p=4, q=4, rank=args.rank, **HP)
    sched = (Wave(num_rounds=args.rounds) if plan is None
             else Gossip(num_rounds=args.rounds))
    res = Trainer(cfg).fit(problem, sched, seed=0)
    if current_rank() == 0:
        print(f"trained {args.rounds} {sched.name} rounds: "
              f"cost={res.final_cost:.3e} rmse={res.rmse():.4f} "
              f"({res.wall_time:.1f}s)", flush=True)
    return res.to_recommend_index()


def bench(service: RecommendService, args) -> dict:
    """The reference bench's loop: a warm-up request, then ``iters``
    batches of ``batch`` uniform users; every rank of a sharded service
    runs it alike."""

    rng = np.random.default_rng(1)
    batches = [rng.integers(0, service.num_users, args.batch).astype(np.int32)
               for _ in range(args.iters)]
    service.recommend(batches[0])
    obs.reset()
    service.reset_metrics()
    t0 = time.perf_counter()
    for ub in batches:
        service.recommend(ub)
    dt = time.perf_counter() - t0          # recommend() waited for the card
    total = args.batch * args.iters
    return {"users": service.num_users, "items": service.num_items,
            "item_shards": service.num_item_shards,
            "per_batch_ms": dt / args.iters * 1e3,
            "users_per_s": total / dt,
            "scores_per_s": total * service.num_items / dt,
            "serving": service.metrics()}


def _run(args, plan, device) -> dict:
    index = (fitted_index(args, plan, device) if args.from_fit
             else random_index(args.users, args.items, args.rank,
                               args.density, device))
    service = RecommendService(index, batch=args.batch, k=args.k, plan=plan)
    out = bench(service, args)
    out["seen_width"] = int(index.seen.shape[1])
    return out


def _bench_rank(rank, device, args, grid):
    plan = (MeshPlan.build(4, 4, grid=grid) if args.from_fit
            else MeshPlan.for_world(grid[0] * grid[1]))
    return _run(args, plan, device)


def _report(args, out, device) -> None:
    print(f"index: {out['users']} users x {out['items']} items, rank "
          f"{args.rank}, seen table width {out['seen_width']}, "
          f"{out['item_shards']} item shard(s) (device={device})")
    print(f"batch={args.batch} k={args.k}: {out['per_batch_ms']:.2f} "
          f"ms/batch, {out['users_per_s']:,.0f} users/s, "
          f"{out['scores_per_s'] / 1e6:,.0f}M scores/s")
    lat = out["serving"]["latency"]
    if lat["count"]:
        print(f"service: p50={lat['p50'] * 1e3:.2f}ms "
              f"p99={lat['p99'] * 1e3:.2f}ms over {lat['count']} batches, "
              f"{out['serving']['qps']:.1f} req/s")


# ---------------------------------------------------------------------- #
# serving straight from a grid fit
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """One :func:`serve_fit_rank` run: the problem's recipe and config, the
    ``Gossip`` rounds of the fit served first and of the refit (from its
    state, run while the engine serves) the engine is refreshed to, the
    requests answered before and after the refresh (int32 user-id
    arrays), and the engine's layout, buckets and k."""

    recipe: ProblemRecipe
    cfg: GossipMCConfig
    rounds: int
    refit_rounds: int
    before: tuple
    after: tuple
    quant: Optional[str] = None
    quant_method: Optional[str] = None
    buckets: tuple = DEFAULT_BUCKETS
    k: int = 10


def serve_fit_rank(rank, device, job: ServeJob, grid) -> dict:
    """Rank body: fit on the grid, serve from the fit while refitting,
    compare (rank 0).

    Every rank builds its tile (``recipe.build(plan)``), fits ``Gossip``
    for ``job.rounds`` rounds and builds ``fit.to_engine()`` (the fit's
    plan: this rank's item shard).  Rank 0 submits ``job.before``; while
    its engine answers them, every rank fits ``job.refit_rounds`` more
    rounds from the fit (the refit's collectives beside the engine's),
    then refreshes to the refit, and rank 0 submits ``job.after``.  Rank
    0 returns the answers' agreement with an unsharded engine over the
    same fits: ``items_equal``, ``scores_bitwise``, ``scores_max_abs``
    and ``scores_max_rel`` (relative to the largest |score|), with the
    sharded engine's startup seconds, per-bucket latencies (the unsharded
    engine's in ``one_buckets``) and request latency.  Every rank returns
    its shard's width and the sharded engine's ``dequant_score``
    launches."""

    plan = MeshPlan.build(job.recipe.p, job.recipe.q, grid=grid)
    problem = job.recipe.build(plan, device)
    trainer = Trainer(job.cfg)
    t0 = time.perf_counter()
    fit = trainer.fit(problem, Gossip(num_rounds=job.rounds), seed=0)
    out = {"rank": rank, "fit_s": time.perf_counter() - t0,
           "fit_ms_per_round": 1e3 * fit.wall_time / job.rounds}
    obs.reset()
    launches0 = quant_ops.dequant_score.launches
    t0 = time.perf_counter()
    engine = fit.to_engine(buckets=job.buckets, k=job.k, quant=job.quant,
                           quant_method=job.quant_method)
    out.update(startup_s=time.perf_counter() - t0,
               shard_items=engine._bufs.shard_items,
               compiles=obs.counter("serve_compiles_total").value)
    with engine:
        t0 = time.perf_counter()
        futures = ([engine.submit(x) for x in job.before] if rank == 0
                   else [])
        refit = trainer.fit(problem, Gossip(num_rounds=job.refit_rounds),
                            state=fit.state)
        out["refit_s"] = time.perf_counter() - t0
        engine.refresh(refit)
        if rank == 0:
            futures += [engine.submit(x) for x in job.after]
            got = [f.result(timeout=GRID_TIMEOUT) for f in futures]
            out["serve_s"] = time.perf_counter() - t0
            m = engine.metrics()
            out["buckets"] = {b: m["buckets"][b] for b in engine.ladder.sizes}
            out["request"] = m["latency"]
            out["users"] = sum(len(x) for x in (*job.before, *job.after))
    out["launches"] = quant_ops.dequant_score.launches - launches0
    if rank == 0:
        obs.reset()
        with ServingEngine(fit.to_recommend_index(), buckets=job.buckets,
                           k=job.k, quant=job.quant,
                           quant_method=job.quant_method) as one:
            want = [one.recommend(x) for x in job.before]
            one.refresh(refit)
            want += [one.recommend(x) for x in job.after]
            m = one.metrics()
        out["one_buckets"] = {b: m["buckets"][b] for b in one.ladder.sizes}
        out.update(agreement(got, want))
    return out


def agreement(got, want) -> dict:
    """Items exactly, scores bitwise or by their largest difference,
    over lists of (items, scores) answers."""

    items = all(np.array_equal(g[0], w[0]) for g, w in zip(got, want))
    bitwise = all(np.array_equal(g[1].view(np.int32), w[1].view(np.int32))
                  for g, w in zip(got, want))
    diff = 0.0
    for g, w in zip(got, want):
        d = np.abs(g[1].astype(np.float64) - w[1])
        d[g[1] == w[1]] = 0.0              # equal infinities included
        diff = max(diff, float(d.max()))
    scale = max(float(np.abs(w[1][np.isfinite(w[1])]).max(initial=0.0))
                for w in want)
    return {"items_equal": items, "scores_bitwise": bitwise,
            "scores_max_abs": diff,
            "scores_max_rel": diff / scale if scale else diff}


def serve_requests(rng, count: int, m: int) -> list:
    """``count`` requests: every edge of the default bucket ladder and one
    split first, the rest log-uniform in 1..3000 users, user ids uniform
    over the m users."""

    sizes = [1, 16, 17, 64, 65, 256, 257, 1024, 1025, 3000]
    sizes += np.exp(rng.uniform(0, np.log(3000), count - len(sizes))
                    ).astype(int).clip(1, 3000).tolist()
    return [rng.integers(0, m, size).astype(np.int32) for size in sizes]


def collective_floor(device, k: int) -> dict:
    """ms a call of a grid engine's two collectives alone at the top
    bucket, on groups as the engine's: the message broadcast (3 + 1024
    int32) on a ``gloo`` group, and the all-gather of every rank's packed
    (1024, 2k) int64 candidates on a group of the default backend (card
    tensors under ``nccl``, else host tensors); the wall of 50 calls
    after a barrier, ended by a synchronize of the card.  A collective:
    every rank calls it."""

    bucket, reps = DEFAULT_BUCKETS[-1], 50
    msg_group, group = dist.new_group(backend="gloo"), dist.new_group()
    msg = torch.zeros(3 + bucket, dtype=torch.int32)
    packed = torch.zeros((bucket, 2 * k), dtype=torch.int64,
                         device="cpu" if host_collectives(device, group)
                         else device)
    parts = [torch.empty_like(packed) for _ in range(dist.get_world_size())]
    out = {}
    for label, fn in (
            ("broadcast_ms", lambda: dist.broadcast(msg, src=0,
                                                    group=msg_group)),
            ("all_gather_ms", lambda: dist.all_gather(parts, packed,
                                                      group=group))):
        fn()
        dist.barrier(group=msg_group)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if packed.is_cuda:
            torch.cuda.synchronize(device)
        out[label] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _engine_rank(rank, device, jobs, grid) -> dict:
    """``--engine``'s rank body: :func:`serve_fit_rank` for each job,
    then :func:`collective_floor`."""

    out = {label: serve_fit_rank(rank, device, job, grid)
           for label, job in jobs.items()}
    out["backend"] = dist.get_backend()
    out["collectives"] = collective_floor(device,
                                         next(iter(jobs.values())).k)
    return out


def engine_bench(args, device) -> bool:
    """``--engine``: int8 and f32 grid engines from a ``Gossip`` fit of
    ``args.rounds`` rounds (refreshed to ``args.rounds // 8`` more) of the
    MovieLens proxy on 4x4 blocks; prints one JSON line per part and
    returns whether every answer agreed with the unsharded engine (int8
    items and scores bitwise, f32 items exactly and scores within
    ``RTOL`` of the largest)."""

    recipe = ProblemRecipe(
        "movielens_proxy", dict(num_users=args.users, num_items=args.items,
                                num_ratings=int(args.users * args.items
                                                * args.density), seed=0),
        p=4, q=4, rank=args.rank, layout="sparse", mean_center=True)
    cfg = GossipMCConfig(m=-(-args.users // 4) * 4,
                         n=-(-args.items // 4) * 4, p=4, q=4,
                         rank=args.rank, **HP)
    rng = np.random.default_rng(11)
    before = serve_requests(rng, 200, args.users)
    after = serve_requests(rng, 50, args.users)
    jobs = {label: ServeJob(recipe, cfg, args.rounds,
                            max(1, args.rounds // 8), tuple(before),
                            tuple(after), quant=quant, quant_method=method,
                            k=args.k)
            for label, quant, method in (("int8", "int8", "fused"),
                                         ("f32", None, None))}
    grid = tuple(args.grid)
    outs = run_on_grid(_engine_rank, grid, jobs, grid, device=device.type,
                       timeout=GRID_TIMEOUT)
    ok = True
    for label in jobs:
        c = outs[0][label]
        print(json.dumps({
            "part": f"engine {label}", "grid": grid,
            "backend": outs[0]["backend"],
            **{key: c[key] for key in (
                "items_equal", "scores_bitwise", "scores_max_abs",
                "scores_max_rel", "fit_ms_per_round", "startup_s",
                "serve_s", "users")},
            "p50_p99_ms": {b: [1e3 * h["p50"], 1e3 * h["p99"]]
                           for b, h in c["buckets"].items()},
            "unsharded_p50_p99_ms": {b: [1e3 * h["p50"], 1e3 * h["p99"]]
                                     for b, h in c["one_buckets"].items()},
            "launches_by_rank": [o[label]["launches"] for o in outs]}),
            flush=True)
        ok &= c["items_equal"] and (c["scores_bitwise"] if label == "int8"
                                    else c["scores_max_rel"] <= RTOL)
    print(json.dumps({"part": "collectives",
                      "by_rank": [o["collectives"] for o in outs]}),
          flush=True)
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=6040)
    ap.add_argument("--items", type=int, default=3706)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--density", type=float, default=0.02,
                    help="seen-item density for the exclusion table")
    ap.add_argument("--from-fit", action="store_true",
                    help="build the index by fitting a MovieLens proxy")
    ap.add_argument("--rounds", type=int, default=30,
                    help="rounds of the --from-fit fit")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the item axis over the --grid ranks")
    ap.add_argument("--engine", action="store_true",
                    help="serve from a Gossip fit on the --grid ranks "
                         "through ServingEngine against the unsharded one")
    ap.add_argument("--grid", type=int, nargs=2, default=(2, 2),
                    help="rank grid of --sharded and --engine (R C)")
    ap.add_argument("--json", type=str, default=None,
                    help="write the results as JSON to this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.engine:
        if not engine_bench(args, device):
            sys.exit("serve_recommend --engine: a grid engine's answers "
                     "differ from the unsharded engine's")
        return
    if args.sharded:
        out = run_on_grid(_bench_rank, tuple(args.grid), args,
                          tuple(args.grid), device=device.type,
                          timeout=GRID_TIMEOUT)[0]
    else:
        out = _run(args, None, device)
    _report(args, out, device.type)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), **out}, f, indent=1,
                      default=str)


if __name__ == "__main__":
    main()
