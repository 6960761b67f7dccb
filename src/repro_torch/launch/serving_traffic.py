"""Serving traffic bench through the port: Poisson arrivals against the
bucket engine and against the ready-on-first-call ``RecommendService``.

The port's twin of ``benchmarks/serving_traffic.py``, with its flags and
defaults, its printed lines and its ``--json`` payload keys (``engine``,
``engine_metrics``, ``baseline``, ``quant``, ``overlap_at_k``,
``index_bytes``, ``method_sweep_ms``).  One request tape — exponential
inter-arrival times at ``--rate`` and log-uniform request sizes across
the bucket ladder, drawn by numpy from ``--seed`` exactly as the JAX
script draws them — is replayed through the same queue discipline
(``serving.queue``'s worker):

* **baseline**: ``RecommendService`` behind a ``ServeWorker``; every
  request pads to one fixed batch and the first batch pays the one-time
  costs inside its latency (counted by ``serve_warmup_batches_total``);
* **engine**: ``ServingEngine``, every bucket readied before the first
  arrival (``serve_compiles_total == len(buckets)``).

``--quant`` replays the tape through an f32 engine and then an int8
engine, reports both indexes' bytes and the mean per-user overlap@k of
their answers (``--k`` rises to 100) — **below 0.99 the run fails** —
and times one full query of each ``kernels.quant`` method at the top
bucket: CUDA events on the card, the median of 50 calls and its spread
(``method_sweep_spread_ms``: p10, p90, min, max).  That
``--json`` file, written on the card into
``kernels/quant/method_sweep.json``, is the table ``resolve_method``
reads for ``method=None``.

``--from-fit`` serves the Table 3 cell's fit instead of random factors:
``movielens_proxy()`` (6040 × 3706), 5 × 5 blocks, r = 15, mean-centred,
``--rounds`` sparse FullGD rounds.  ::

    python -m repro_torch.launch.serving_traffic [--users 4000] \\
        [--items 2000] [--rank 16] [--density 0.02] [--buckets 16,64,256] \\
        [--k 10] [--requests 200] [--rate 100] [--seed 0] \\
        [--baseline-batch 256] [--quant] [--quant-method M] \\
        [--from-fit] [--rounds 800] [--json PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.core.state import init_state, resolve_device
from repro_torch.data import movielens_proxy
from repro_torch.kernels.quant import METHODS, resolve_method
from repro_torch.launch.bench_json import emit_json
from repro_torch.mc import CompletionProblem, FullGD, Trainer
from repro_torch.serve.quant import index_nbytes, quantize_index
from repro_torch.serve.recommend import (RecommendIndex, RecommendService,
                                        build_seen_table, recommend_topk)
from repro_torch.serving import ServingEngine
from repro_torch.serving.queue import ServeWorker

OVERLAP_GATE = 0.99
SWEEP_CALLS = 50      # timed full queries of each method
# the Table 3 cell (chip_smoke.py's [main]): grid, rank, hyperparameters
FIT_GRID, FIT_RANK = (5, 5), 15
FIT_HP = dict(rho=1e3, lam=1e-6, a=2.0e-4, b=5.0e-7)


def random_index(users: int, items: int, rank: int, density: float,
                 seed: int, device) -> RecommendIndex:
    """The JAX script's ``_random_index``: the same numpy draws."""

    rng = np.random.default_rng(seed)
    u = rng.normal(size=(users, rank)).astype(np.float32)
    w = rng.normal(size=(items, rank)).astype(np.float32)
    mask = rng.random((users, items)) < density
    seen = build_seen_table(mask.astype(np.float32), items)
    return RecommendIndex(*(torch.from_numpy(a).to(device)
                            for a in (u, w, seen)))


def fitted_index(rounds: int, device) -> RecommendIndex:
    """The Table 3 cell's index: ``rounds`` sparse FullGD rounds on
    ``movielens_proxy()``, 5 × 5 blocks, r = 15, from a seeded state."""

    ds = movielens_proxy()
    p, q = FIT_GRID
    problem = CompletionProblem.from_dataset(
        ds, p, q, FIT_RANK, layout="sparse", mean_center=True, device=device)
    spec = problem.spec
    cfg = GossipMCConfig(m=spec.m, n=spec.n, p=p, q=q, rank=FIT_RANK,
                         **FIT_HP)
    state0 = init_state(torch.Generator(device=device).manual_seed(0), spec)
    res = Trainer(cfg).fit(problem, FullGD(num_rounds=rounds), state=state0)
    return res.to_recommend_index()


def make_schedule(requests: int, rate: float, users: int, seed: int,
                  buckets) -> tuple[np.ndarray, list]:
    """One shared traffic tape: (inter-arrival seconds, user-id arrays),
    the JAX script's ``_make_schedule`` draw for draw."""

    rng = np.random.default_rng(seed + 1)
    gaps = rng.exponential(1.0 / rate, size=requests)
    # log-uniform sizes spanning the ladder: plenty of small requests,
    # some full-bucket ones, a few oversize multi-chunk ones
    log_hi = np.log(buckets[-1] * 1.25)
    sizes = np.exp(rng.uniform(0.0, log_hi, size=requests))
    sizes = np.maximum(1, sizes.astype(int))
    reqs = [rng.integers(0, users, size=s).astype(np.int32) for s in sizes]
    return gaps, reqs


def drive(submit, gaps, reqs, timeout: float = 300.0):
    """Replay the tape: submit at arrival, stamp completion by callback.
    Returns (latency seconds a request, achieved QPS, the answers' item
    arrays)."""

    n = len(reqs)
    t_done = [0.0] * n
    t_sub = [0.0] * n
    futures = []
    for i in range(n):
        time.sleep(gaps[i])
        t_sub[i] = time.perf_counter()
        f = submit(reqs[i])
        f.add_done_callback(
            lambda f, i=i: t_done.__setitem__(i, time.perf_counter()))
        futures.append(f)
    answers = [np.asarray(f.result(timeout=timeout)[0]) for f in futures]
    lats = np.array([d - s for s, d in zip(t_sub, t_done)])
    window = max(t_done) - t_sub[0]
    qps = n / window if window > 0 else 0.0
    return lats, qps, answers


def mean_overlap(answers_a, answers_b, k: int) -> float:
    """Mean per-user overlap@k between two phases' answers on one tape."""

    per_user = []
    for a, b in zip(answers_a, answers_b):
        for row_a, row_b in zip(a, b):
            per_user.append(len(set(row_a) & set(row_b)) / k)
    return float(np.mean(per_user))


def summarize(lats, qps, compiles) -> dict:
    return {
        "p50_ms": float(np.percentile(lats, 50) * 1e3),
        "p99_ms": float(np.percentile(lats, 99) * 1e3),
        "mean_ms": float(lats.mean() * 1e3),
        "max_ms": float(lats.max() * 1e3),
        "qps": float(qps),
        "compiles": float(compiles),
    }


def method_sweep(qidx, user_ids, k: int, calls: int = SWEEP_CALLS):
    """One full query (``recommend_topk``) of each method on ``qidx``:
    the median ms of ``calls`` calls after one warm-up, and the spread
    (p10, p90, min, max).  On the card each call is timed by CUDA events
    around it; on the CPU by the host clock."""

    cuda = user_ids.device.type == "cuda"
    medians, spread = {}, {}
    for m in METHODS:
        def fn():
            return recommend_topk(qidx, user_ids, k=k, method=m)

        fn()
        ts = []
        for _ in range(calls):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
        medians[m] = float(np.median(ts))
        spread[m] = {"p10": float(np.percentile(ts, 10)),
                     "p90": float(np.percentile(ts, 90)),
                     "min": float(min(ts)), "max": float(max(ts))}
    return medians, spread


def replay(index, gaps, reqs, *, buckets, k: int, quant: bool = False,
           quant_method: str | None = None, baseline_batch: int = 256,
           seed: int = 0, log=print):
    """The bench on ``index``: baseline (without ``quant``), engine, and
    with ``quant`` the int8 engine, the overlap gate and the method
    sweep.  Returns (payload, extra): ``payload`` has the JAX script's
    JSON keys; ``extra`` the engine's ``answers``, the int8 engine's
    ``quant_answers`` and ``method_sweep_spread_ms``."""

    buckets = tuple(buckets)
    device = index.seen.device
    baseline = None
    if not quant:
        # ---- baseline: ready-on-first-call service behind the queue --- #
        obs.reset()
        service = RecommendService(index, batch=baseline_batch, k=k)
        worker = ServeWorker(lambda req: service.recommend(req.user_ids),
                             name="baseline-service")
        try:
            base_lats, base_qps, _ = drive(worker.submit, gaps, reqs)
        finally:
            worker.shutdown()
        # the one-time costs the baseline paid in-band
        base_compiles = obs.counter("serve_warmup_batches_total").value
        baseline = summarize(base_lats, base_qps, base_compiles)
        log(f"baseline (batch={baseline_batch}, compile in-band): "
            f"p50={baseline['p50_ms']:.2f}ms p99={baseline['p99_ms']:.2f}ms "
            f"qps={baseline['qps']:.1f} compiles={base_compiles:.0f}")

    # ---- engine: every bucket readied before the first arrival -------- #
    obs.reset()                 # envelope metrics == engine phase only
    t0 = time.perf_counter()
    with ServingEngine(index, buckets=buckets, k=k) as eng:
        startup_s = time.perf_counter() - t0
        eng_lats, eng_qps, eng_answers = drive(eng.submit, gaps, reqs)
        eng.drain()
        engine = summarize(eng_lats, eng_qps,
                           obs.counter("serve_compiles_total").value)
        engine["startup_compile_s"] = float(startup_s)
        em = eng.metrics()
    log(f"engine (buckets={buckets}, startup compile {startup_s:.2f}s): "
        f"p50={engine['p50_ms']:.2f}ms p99={engine['p99_ms']:.2f}ms "
        f"qps={engine['qps']:.1f} compiles={engine['compiles']:.0f} "
        f"(all at startup)")
    if baseline is not None:
        log(f"engine p99 / baseline p99 = "
            f"{engine['p99_ms'] / baseline['p99_ms']:.3f}")

    payload = dict(
        engine=engine,
        engine_metrics={"queue_wait": em["queue_wait"],
                        "buckets": {str(b): s for b, s in
                                    em["buckets"].items()},
                        "refreshes": em["refreshes"]},
    )
    extra = {"answers": eng_answers}
    if baseline is not None:
        payload["baseline"] = baseline
    if not quant:
        return payload, extra

    # ---- quant: the int8 engine replays the identical tape ------------ #
    qidx = quantize_index(index)
    index_bytes = {
        "f32": index_nbytes(index),
        "int8": index_nbytes(qidx),
        "ratio": index_nbytes(qidx) / index_nbytes(index),
    }
    uids = torch.as_tensor(
        np.random.default_rng(seed + 2)
        .integers(0, index.num_users, buckets[-1]).astype(np.int32),
        device=device)
    sweep, spread = method_sweep(qidx, uids, k)
    method = resolve_method(quant_method, device)
    log("method sweep (full query, ms): "
        + ", ".join(f"{m}={v:.3f} (p10 {spread[m]['p10']:.3f}, p90 "
                    f"{spread[m]['p90']:.3f})" for m, v in sweep.items())
        + f"; serving method={method}")

    obs.reset()                 # envelope metrics == the int8 phase
    t0 = time.perf_counter()
    with ServingEngine(qidx, buckets=buckets, k=k,
                       quant_method=method) as qeng:
        q_startup_s = time.perf_counter() - t0
        q_lats, q_qps, q_answers = drive(qeng.submit, gaps, reqs)
        qeng.drain()
        quant_row = summarize(q_lats, q_qps,
                              obs.counter("serve_compiles_total").value)
    quant_row["startup_compile_s"] = float(q_startup_s)
    quant_row["method"] = method

    overlap = mean_overlap(eng_answers, q_answers, k)
    log(f"quant engine (int8, {method}): "
        f"p50={quant_row['p50_ms']:.2f}ms p99={quant_row['p99_ms']:.2f}ms "
        f"qps={quant_row['qps']:.1f}; "
        f"index bytes {index_bytes['int8']}/{index_bytes['f32']} "
        f"= {index_bytes['ratio']:.3f}x; overlap@{k}={overlap:.4f}")
    # the accuracy gate is the bench: a quant run that degrades the answers
    # fails, it never lands as a green JSON
    if not overlap >= OVERLAP_GATE:
        raise AssertionError(f"int8 overlap@{k} = {overlap:.4f} < "
                             f"{OVERLAP_GATE} accuracy gate")
    payload.update(quant=quant_row, overlap_at_k=overlap,
                   index_bytes=index_bytes, method_sweep_ms=sweep)
    extra.update(quant_answers=q_answers, method_sweep_spread_ms=spread)
    return payload, extra


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=4000)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--density", type=float, default=0.02)
    ap.add_argument("--buckets", type=str, default="16,64,256")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-batch", type=int, default=256)
    ap.add_argument("--quant", action="store_true",
                    help="compare f32 vs int8 engines on the same tape")
    ap.add_argument("--quant-method", type=str, default=None,
                    choices=METHODS,
                    help="int8 scoring method (default: the committed "
                         "sweep for the device, else its fallback)")
    ap.add_argument("--from-fit", action="store_true",
                    help="serve the Table 3 cell's fit (ML-1M proxy, 5x5, "
                         "r=15) instead of random factors")
    ap.add_argument("--rounds", type=int, default=800,
                    help="FullGD rounds of the --from-fit fit")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quant and args.k == ap.get_default("k"):
        args.k = 100          # retrieval-stage contract (module docstring)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    device = resolve_device(args.device)

    if args.from_fit:
        index = fitted_index(args.rounds, device)
        args.users, args.items = index.num_users, index.num_items
        args.rank = int(index.u.shape[1])
    else:
        index = random_index(args.users, args.items, args.rank,
                             args.density, args.seed, device)
    gaps, reqs = make_schedule(args.requests, args.rate, args.users,
                               args.seed, buckets)
    total_users = sum(len(r) for r in reqs)
    print(f"index: {args.users} users x {args.items} items rank {args.rank} "
          f"(backend={device.type}); traffic: {args.requests} "
          f"requests, {total_users} users, rate {args.rate}/s, "
          f"sizes 1..{max(len(r) for r in reqs)}")
    payload, extra = replay(index, gaps, reqs, buckets=buckets, k=args.k,
                            quant=args.quant, quant_method=args.quant_method,
                            baseline_batch=args.baseline_batch,
                            seed=args.seed)
    if args.json:
        config = {"users": args.users, "items": args.items,
                  "rank": args.rank,
                  "density": None if args.from_fit else args.density,
                  "buckets": list(buckets), "k": args.k,
                  "requests": args.requests, "rate": args.rate,
                  "seed": args.seed, "baseline_batch": args.baseline_batch,
                  "quant": bool(args.quant), "from_fit": args.from_fit,
                  "rounds": args.rounds if args.from_fit else None,
                  "sweep_calls": SWEEP_CALLS}
        extras = ({"method_sweep_spread_ms": extra["method_sweep_spread_ms"]}
                  if args.quant else {})
        emit_json(args.json, "serving_traffic", config, device,
                  **payload, **extras)
    return payload


if __name__ == "__main__":
    main()
