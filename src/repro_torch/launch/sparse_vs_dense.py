"""Sparse vs dense objective bench through the port: where the sparse
store overtakes the dense masked layout.

The port's twin of ``benchmarks/sparse_vs_dense.py``, with its flags and
its row keys.  Times the Table-2 objective and the full ∇L on the same
``CompletionProblem`` while sweeping density, in three configurations:
dense masked tensors, the segment-sorted sparse store (the default), and
the scatter engine, all selected through ``with_layout``/``with_engine``,
never through other entry points.  On the card the three go through the
hand-written kernels (``masked_factor_grad``, ``sddmm_segment_grad``,
``sddmm_factor_grad``); the dense kernel reads O(m·n) values and masks
whatever the density, the sparse ones O(nnz).

Each row also holds the engines' agreement: the max absolute difference
of ∇L against dense (the JAX script's ``maxdiff_*``) and, relative to
max|∇L| and to |cost|, ``grad_reldiff_*`` and ``cost_reldiff_*``.  The
``*_ms`` times are the JAX script's, calls queued back to back on the
host clock, so a call costs the larger of its host and its device time;
on the card each row adds the device time alone (``*_device_ms``: one
CUDA graph of 10 calls, replayed), where the kernels' own crossover
shows.

``--chunks`` sweeps ``EngineOptions.chunk``, which tunes only the CPU
path's segment reduce (``sparse/objective.py``); on the card the kernels
do not read it, so the twin times nothing for it there and says so.  ::

    python -m repro_torch.launch.sparse_vs_dense [--m 2048] [--n 2048] \\
        [--grid 4 4] [--rank 8] [--densities 0.01 0.02 0.05] \\
        [--iters 10] [--chunks 16 32 64] [--json PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import GossipMCConfig
from repro_torch.core.state import init_state, resolve_device
from repro_torch.data import lowrank_problem
from repro_torch.launch.bench_json import emit_json
from repro_torch.mc import CompletionProblem


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, iters=10) -> float:
    fn()                                                   # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3        # ms


def _graph_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device ms a call on the card: ``calls`` calls captured in one CUDA
    graph, the median of ``reps`` replays between CUDA events (no host
    time inside)."""

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                               # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(sorted(times)[len(times) // 2])


def _maxdiff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _reldiff(a, b) -> float:
    """max |a − b| over the leaves, relative to max |b|."""

    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def engines(ds, p: int, q: int, rank: int, device):
    """The three configurations of one dataset: dense, segment-sorted
    sparse and scatter, through ``with_layout``/``with_engine`` only."""

    dense = CompletionProblem.from_dataset(ds, p, q, rank, layout="dense",
                                           device=device)
    sorted_ = dense.with_layout("sparse")                  # segment method
    return dense, sorted_, sorted_.with_engine(method="scatter")


def sweep(m: int, n: int, grid, rank: int, densities, *, iters: int = 10,
          chunks=(16, 32, 64), device="cuda", state=None) -> list[dict]:
    """One row per density (the JAX script's keys, plus the relative
    agreements; the problem from ``lowrank_problem`` at seed 0, as the JAX
    script's).  ``state`` is the initial ``State`` every engine is
    evaluated at (default: drawn from seed 0 on ``device``)."""

    device = resolve_device(device)
    p, q = grid
    cfg = GossipMCConfig(m=m, n=n, p=p, q=q, rank=rank)
    rho, lam = cfg.rho, cfg.lam
    rows = []
    st = state
    for d in densities:
        dense, sorted_, scatter = engines(
            lowrank_problem(m, n, rank, density=d, seed=0), p, q, rank,
            device)
        if st is None:
            st = init_state(torch.Generator(device=device).manual_seed(0),
                            dense.spec)
        nnz = int(sorted_.data.nnz.sum())

        def grad(pr):
            return lambda: pr.full_gradients(st, rho=rho, lam=lam)

        def cost(pr):
            return lambda: pr.total_cost_device(st, lam)

        tc_d = _time(cost(dense), device, iters)
        tc_s = _time(cost(sorted_), device, iters)
        tg_d = _time(grad(dense), device, iters)
        tg_s = _time(grad(sorted_), device, iters)
        tg_u = _time(grad(scatter), device, iters)
        gd, gs, gu = (grad(pr)() for pr in (dense, sorted_, scatter))
        c_d, c_s, c_u = (cost(pr)() for pr in (dense, sorted_, scatter))

        device_ms = {}
        if device.type == "cuda":
            chunk_sweep = best_chunk = None     # the kernels do not read it
            device_ms = {
                "cost_dense_device_ms": _graph_ms(cost(dense)),
                "cost_sparse_device_ms": _graph_ms(cost(sorted_)),
                "grad_dense_device_ms": _graph_ms(grad(dense)),
                "grad_sorted_device_ms": _graph_ms(grad(sorted_)),
                "grad_scatter_device_ms": _graph_ms(grad(scatter))}
        else:
            chunk_sweep = {
                str(c): _time(grad(sorted_.with_engine(chunk=c)), device,
                              iters) for c in chunks}
            best_chunk = int(min(chunk_sweep, key=chunk_sweep.get))

        rows.append({
            "density": d,
            "nnz": nnz,
            "cost_dense_ms": tc_d,
            "cost_sparse_ms": tc_s,
            "grad_dense_ms": tg_d,
            "grad_sorted_ms": tg_s,
            "grad_scatter_ms": tg_u,
            "grad_sorted_speedup": tg_d / tg_s,
            "grad_scatter_speedup": tg_d / tg_u,
            "maxdiff_sorted_vs_dense": _maxdiff(gs, gd),
            "maxdiff_scatter_vs_dense": _maxdiff(gu, gd),
            "grad_reldiff_sorted_vs_dense": _reldiff(gs, gd),
            "grad_reldiff_scatter_vs_dense": _reldiff(gu, gd),
            "cost_reldiff_sorted_vs_dense": _reldiff([c_s], [c_d]),
            "cost_reldiff_scatter_vs_dense": _reldiff([c_u], [c_d]),
            "chunk_sweep_ms": chunk_sweep,
            "chunk_best": best_chunk,
            **device_ms,
        })
    return rows


def report(rows, chunks, device, log=print) -> None:
    """The JAX script's three tables."""

    log("\nobjective (Table-2 cost):")
    log(f"{'density':>8} {'nnz':>10} {'dense_ms':>9} {'sparse_ms':>10} "
        f"{'speedup':>8}")
    for r in rows:
        log(f"{r['density']:8.3f} {r['nnz']:10d} {r['cost_dense_ms']:9.2f} "
            f"{r['cost_sparse_ms']:10.2f} "
            f"{r['cost_dense_ms'] / r['cost_sparse_ms']:7.1f}x")

    log("\nfull gradient (∇L): sorted segment-reduce vs unsorted scatter "
        "vs dense")
    log(f"{'density':>8} {'nnz':>10} {'dense_ms':>9} {'sorted_ms':>10} "
        f"{'scatter_ms':>11} {'sorted_x':>9} {'scatter_x':>10} "
        f"{'maxdiff':>10}")
    for r in rows:
        log(f"{r['density']:8.3f} {r['nnz']:10d} {r['grad_dense_ms']:9.2f} "
            f"{r['grad_sorted_ms']:10.2f} {r['grad_scatter_ms']:11.2f} "
            f"{r['grad_sorted_speedup']:8.1f}x "
            f"{r['grad_scatter_speedup']:9.1f}x "
            f"{r['maxdiff_sorted_vs_dense']:10.2e}")

    if torch.device(device).type == "cuda":
        log("\ndevice ms a call (CUDA-graph replays, no host time): cost "
            "dense / sparse, ∇L dense / sorted / scatter")
        for r in rows:
            log(f"{r['density']:8.3f} {r['nnz']:10d} "
                f"{r['cost_dense_device_ms']:9.4f} "
                f"{r['cost_sparse_device_ms']:9.4f}  "
                f"{r['grad_dense_device_ms']:9.4f} "
                f"{r['grad_sorted_device_ms']:9.4f} "
                f"{r['grad_scatter_device_ms']:9.4f}")
        log("\nsegment-reduce chunk sweep: not run on cuda (EngineOptions."
            "chunk tunes only the CPU path; the kernels do not read it)")
        return
    log("\nsegment-reduce chunk sweep (sorted ∇L, ms):")
    hdr = " ".join(f"c={c:<4d}" for c in chunks)
    log(f"{'density':>8}  {hdr}  best")
    for r in rows:
        cells = " ".join(f"{r['chunk_sweep_ms'][str(c)]:6.2f}"
                         for c in chunks)
        log(f"{r['density']:8.3f}  {cells}  c={r['chunk_best']}")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--grid", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--densities", type=float, nargs="+",
                    default=[0.01, 0.02, 0.05])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunks", type=int, nargs="+", default=[16, 32, 64],
                    help="segment-reduce chunk sizes to sweep "
                         "(EngineOptions.chunk; the CPU path only)")
    ap.add_argument("--json", type=str, default=None,
                    help="write results as JSON to this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    p, q = args.grid
    print(f"matrix {args.m}x{args.n} grid {p}x{q} rank {args.rank} "
          f"({args.iters} iters, backend={device.type})")
    rows = sweep(args.m, args.n, (p, q), args.rank, args.densities,
                 iters=args.iters, chunks=args.chunks, device=device)
    report(rows, args.chunks, device)
    if args.json:
        emit_json(args.json, "sparse_vs_dense",
                  {"m": args.m, "n": args.n, "p": p, "q": q,
                   "rank": args.rank, "iters": args.iters,
                   "chunks": args.chunks}, device, rows=rows)
    return rows


if __name__ == "__main__":
    main()
