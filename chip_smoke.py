#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build: compile the CUDA kernels (``kernels/csrc/*.cu``, one ``nvcc``
   each, all at once) and print the build seconds and the card's name and
   power limit.
2. Kernels against their plain PyTorch versions, at the main path's
   shapes (the full 5x5 stack of MovieLens-1M-scale blocks): error, the
   kernel's and the plain version's time (CUDA events; median over
   CUDA-graph replays, so the host's launch cost is not in it), and the
   least time the card could take (bytes over HBM rate or operations over
   f32 rate, whichever is larger, counted from this run's data).
3. The main path through the user entry points, each phase with the
   launch counters set to 0 just before it and read just after:
   ``CompletionProblem`` -> ``Trainer.fit`` (FullGD on the sparse store
   with the segment and scatter methods and on the dense layout, one Wave
   round on each layout, Sequential iterations on each layout) ->
   ``FitResult`` -> ``recommend_topk`` for 256 users.  Checks: costs
   finite and falling, each kernel launched in its phase, sparse and dense
   FullGD states agree, top-k agrees with a float64 host reference.

The configuration is the paper's Table 3 cell at MovieLens-1M scale
(``benchmarks/table3_rmse.py --full``): the 6040x3706 ``movielens_proxy``
with 1M ratings (800k for training), a 5x5 grid, rank 15, mean-centred,
rho=1e3, lam=1e-6, a=2e-4, b=5e-7; random initial factors from seed 0.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` summary, and the line before that the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.config import GossipMCConfig  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.data import movielens_proxy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.masked_factor_grad import ops as mfg_ops  # noqa: E402
from repro_torch.kernels.masked_factor_grad.ref import (  # noqa: E402
    masked_factor_grad_ref,
)
from repro_torch.kernels.sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.sddmm.ref import sddmm_factor_grad_ref  # noqa: E402
from repro_torch.kernels.sddmm.segment import (  # noqa: E402
    sddmm_segment_grad_ref,
)
from repro_torch.mc import (  # noqa: E402
    CompletionProblem,
    FullGD,
    Sequential,
    Trainer,
    Wave,
)
from repro_torch.serve.recommend import recommend_topk  # noqa: E402

P = Q = 5
RANK = 15
CFG = dict(rho=1e3, lam=1e-6, a=2.0e-4, b=5.0e-7)
FULL_ROUNDS = 40
TOL = 1e-5          # |kernel - plain| <= TOL * (|plain| + max|plain|)
STATE_RTOL = 1e-4   # sparse vs dense FullGD after FULL_ROUNDS rounds

WRAPPERS = {
    "sddmm_segment_grad": sddmm_ops.sddmm_segment_grad,
    "sddmm_factor_grad": sddmm_ops.sddmm_factor_grad,
    "masked_factor_grad": mfg_ops.masked_factor_grad,
}
META = {
    "sddmm_segment_grad": ("src/repro_torch/kernels/csrc/sddmm.cu",
                           "src/repro/kernels/sddmm/segment_kernel.py:113"),
    "sddmm_factor_grad": ("src/repro_torch/kernels/csrc/sddmm.cu",
                          "src/repro/kernels/sddmm/kernel.py:82"),
    "masked_factor_grad": (
        "src/repro_torch/kernels/csrc/masked_factor_grad.cu",
        "src/repro/kernels/masked_factor_grad/kernel.py:75"),
}
# (HBM bytes/s, f32 non-tensor flop/s): NVIDIA data sheets, dense rates
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks(name: str) -> tuple[float, float]:
    for key in ("PCIe", "NVL", "H100"):
        if key in name:
            return PEAKS[key]
    fail(f"no peak rates known for {name!r}")


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def graph_ms(fn, calls: int = 10, reps: int = 25) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events; the
    median replay over ``calls``."""

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def eager_ms(fn, reps: int = 25) -> float:
    """Time of one eager ``fn()`` as a caller sees it (host launch cost
    included): median over ``reps`` calls between CUDA events."""

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_breakdown(fn, calls: int = 5) -> dict[str, float]:
    """Device ms per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` (CUPTI) over ``calls`` calls."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if us > 0:
            # "void (anonymous namespace)::segment_kernel<16>(int const*, ..."
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].strip() or "other"
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return out


def compare(got, want) -> tuple[float, float]:
    """(max abs error, max error / (|plain| + max|plain|)) over outputs."""

    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        scale = float(w.abs().max())
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / (w.double().abs() + scale
                                           + 1e-30)).max()))
    return abs_err, rel_err


def kernel_phase(sparse, dense, state, card):
    """Each kernel against its plain version on the main path's stack."""

    bw, flops = peaks(card)
    ent, U, W = sparse.data.entries, state.U, state.W
    X, Mk = dense.data.xb, dense.data.maskb
    B, M, r = U.shape[0] * U.shape[1], U.shape[2], U.shape[3]
    N, E = W.shape[2], ent.capacity
    nnz = int(sparse.data.nnz.sum())
    factor_bytes = 2 * 4 * B * (M + N) * r + 4 * B   # U, W in; gU, gW, loss out
    sparse_ops = nnz * (6 * r + 4)
    work = {
        "sddmm_segment_grad": (
            lambda: sddmm_ops.sddmm_segment_grad(ent, U, W),
            lambda: sddmm_segment_grad_ref(ent, U, W),
            nnz * 5 * 4 + 4 * B * (M + N + 2) + factor_bytes, sparse_ops),
        "sddmm_factor_grad": (
            lambda: sddmm_ops.sddmm_factor_grad(ent, U, W),
            lambda: sddmm_factor_grad_ref(ent, U, W),
            nnz * 4 * 4 + factor_bytes, sparse_ops),
        "masked_factor_grad": (
            lambda: mfg_ops.masked_factor_grad(X, Mk, U, W),
            lambda: masked_factor_grad_ref(X, Mk, U, W),
            2 * 4 * B * M * N + factor_bytes, B * M * N * (6 * r + 4)),
    }
    rows = []
    for name, (kern, plain, nbytes, ops) in work.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err, rel_err = compare(got, want)
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        row = {
            "name": name, "route": "cuda", "source": META[name][0],
            "replaces": META[name][1], "launches": 0,
            "max_abs_err": abs_err, "max_rel_err": rel_err, "tolerance": TOL,
            "ms": graph_ms(kern), "plain_ms": graph_ms(plain),
            "eager_ms": eager_ms(kern), "plain_eager_ms": eager_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "library_ms": None,
            "device_breakdown_ms": device_breakdown(kern),
            "shape": {"blocks": B, "mb": M, "nb": N, "r": r, "E": E,
                      "nnz": nnz},
        }
        print(json.dumps(row), flush=True)
        if not rel_err <= TOL:
            fail(f"{name} disagrees with its plain version: "
                 f"max error {rel_err:.3e} > {TOL:.0e}")
        rows.append(row)
    return rows


def run_phase(label, expect, fit):
    """Drive one phase of the main path with the counters at 0; fail
    unless each kernel in ``expect`` launched."""

    reset_counts()
    t0 = time.perf_counter()
    result = fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    costs = [c for _, c in result.history]
    print(f"[main] {label}: t={result.t} costs={costs} "
          f"wall={seconds:.3f}s launches={got}", flush=True)
    if not np.isfinite(costs).all():
        fail(f"{label}: non-finite cost {costs}")
    for name in expect:
        if got[name] == 0:
            fail(f"{label}: {name} was never launched")
    return result, got


def check_topk(index, users, items, scores, k):
    """Top-k against a float64 host reference, where scores have no ties."""

    u = index.u.double().cpu().numpy()[users]
    w = index.w.double().cpu().numpy()
    ref = u @ w.T
    seen = index.seen.cpu().numpy()[users]
    for b in range(len(users)):
        s = seen[b][seen[b] < w.shape[0]]
        ref[b, s] = -np.inf
    order = np.argsort(-ref, axis=1)[:, :k]
    top = np.take_along_axis(ref, order, 1)
    tie_free = (np.abs(np.diff(top, axis=1)) > 1e-6).all(axis=1)
    if tie_free.sum() < len(users) // 2:
        fail("top-k check: too few tie-free users")
    if not np.array_equal(items.cpu().numpy()[tie_free], order[tie_free]):
        fail("recommend_topk disagrees with the host reference")
    if not np.allclose(scores.double().cpu().numpy(), top, rtol=1e-4,
                       atol=1e-4):
        fail("recommend_topk scores disagree with the host reference")
    return int(tie_free.sum())


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {json.dumps(built)} total {time.perf_counter() - t0:.2f}s",
          flush=True)

    # data and problems through the user entry points
    t0 = time.perf_counter()
    ds = movielens_proxy()
    sparse = CompletionProblem.from_dataset(ds, P, Q, RANK, layout="sparse",
                                            mean_center=True)
    dense = CompletionProblem.from_dataset(ds, P, Q, RANK, layout="dense",
                                           mean_center=True)
    scatter = sparse.with_engine(method="scatter")
    spec = sparse.spec
    cfg = GossipMCConfig(m=spec.m, n=spec.n, p=P, q=Q, rank=RANK, **CFG)
    state0 = init_state(torch.Generator(device="cuda").manual_seed(0), spec)
    print(f"[data] {spec} train nnz={int(sparse.data.nnz.sum())} "
          f"E={sparse.data.capacity} test={len(ds.test_vals)} "
          f"setup {time.perf_counter() - t0:.2f}s", flush=True)

    # 2. kernels against their plain versions
    rows = kernel_phase(sparse, dense, state0, card)

    # 3. main path; a two-round warm-up per problem first, so that the
    # timed phases do not pay PyTorch's one-time CUDA module loading
    total = dict.fromkeys(WRAPPERS, 0)
    trainer = Trainer(cfg)
    for problem in (sparse, scatter, dense):
        trainer.fit(problem, FullGD(num_rounds=2), state=state0)
        trainer.fit(problem, Wave(num_rounds=1), seed=0)
    runs = [
        ("FullGD sparse/segment", ["sddmm_segment_grad"], lambda: trainer.fit(
            sparse, FullGD(num_rounds=FULL_ROUNDS, eval_every=10),
            state=state0)),
        ("FullGD sparse/scatter", ["sddmm_factor_grad"], lambda: trainer.fit(
            scatter, FullGD(num_rounds=10, eval_every=5), state=state0)),
        ("FullGD dense", ["masked_factor_grad"], lambda: trainer.fit(
            dense, FullGD(num_rounds=FULL_ROUNDS, eval_every=10),
            state=state0)),
        ("Wave sparse", ["sddmm_segment_grad"], lambda: trainer.fit(
            sparse, Wave(num_rounds=1), seed=1)),
        ("Wave dense", ["masked_factor_grad"], lambda: trainer.fit(
            dense, Wave(num_rounds=1), seed=1)),
        ("Sequential sparse", ["sddmm_segment_grad"], lambda: trainer.fit(
            sparse, Sequential(num_iters=300, eval_every=100), seed=2)),
        ("Sequential dense", ["masked_factor_grad"], lambda: trainer.fit(
            dense, Sequential(num_iters=100, eval_every=50), seed=2)),
    ]
    results = {}
    for label, expect, fit in runs:
        results[label], got = run_phase(label, expect, fit)
        for name, n in got.items():
            total[name] += n
    for label in ("FullGD sparse/segment", "FullGD sparse/scatter",
                  "FullGD dense"):
        res = results[label]
        costs = [c for _, c in res.history]
        if not costs[-1] < costs[0]:
            fail(f"{label}: cost did not fall: {costs}")
        rounds = res.t // (2 * (P - 1) * (Q - 1))
        print(f"[main] {label}: {1e3 * res.wall_time / rounds:.3f} ms/round "
              f"over {rounds} rounds (cost evals included), held-out RMSE "
              f"{res.rmse():.4f}", flush=True)

    a = results["FullGD sparse/segment"].state
    b = results["FullGD dense"].state
    for x, y, nm in ((a.U, b.U, "U"), (a.W, b.W, "W")):
        scale = float(y.abs().max())
        if not torch.allclose(x, y, rtol=STATE_RTOL, atol=1e-5 * scale):
            fail(f"sparse and dense FullGD {nm} disagree: max diff "
                 f"{float((x - y).abs().max()):.3e} (max |{nm}| {scale:.3e})")
    print(f"[main] sparse and dense FullGD states agree after {FULL_ROUNDS} "
          f"rounds (rtol {STATE_RTOL:.0e})", flush=True)

    reset_counts()
    index = results["FullGD sparse/segment"].to_recommend_index()
    users = torch.arange(0, 256 * 23, 23, device="cuda")
    recommend_topk(index, users, k=10)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    items, scores = recommend_topk(index, users, k=10)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    if items.shape != (256, 10) or not torch.isfinite(scores).all():
        fail(f"recommend_topk gave {tuple(items.shape)} / non-finite scores")
    n_checked = check_topk(index, users.cpu().numpy(), items, scores, 10)
    print(f"[main] recommend_topk: 256 users, k=10, {ms:.3f} ms, "
          f"{n_checked} tie-free users equal to the host reference",
          flush=True)

    for row in rows:
        row["launches"] = total[row["name"]]
    print(f"[main] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
