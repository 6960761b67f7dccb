"""Serving launcher: tensor-parallel decode on a grid of ranks (port of
``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch internvl2-76b --tp 4 \\
        --batch 4 --seq-len 2048 --steps 32 [--device cpu]
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --tp 4 --batch 4 --seq-len 4096 --steps 8 [--device cpu]
    python -m repro_torch.launch.serve --arch whisper-large-v3 --tp 2 \\
        --batch 4 --seq-len 448 --steps 8 [--device cpu]
    python -m repro_torch.launch.serve --arch granite-34b --tp 4 \\
        --batch 32 --seq-len 32768 --steps 16 [--device cpu]

As the reference does, it runs ``--steps`` decode steps of
``make_serve_step`` from a zero cache at position ``seq_len - 1``,
feeding each step's greedy token back, and prints ``[serve] ... tok/s``.
There is no prefill, so no prompt, frames or patches: mamba2 and zamba2
decode from a zero SSM state, whisper from a zero cross-attention cache.
The parameters are seeded shards (``train/shard.py::init_shard``, seed 0),
so ``--tp 1`` and ``--tp N`` serve the same weights and print the same
greedy tokens.  Every arch serves on ``--tp`` ranks where its query heads
split (``models/api.py::tp_refusal``); where its KV heads do not
(granite-34b's one), each rank holds every KV head over its slice of the
positions, as the rules cut the cache, and each rank's cache bytes are
printed beside the one process's.  A batch equal to a stacking dim of
its cache (zamba2's 9 units, whisper's 32 decoder layers) is refused by
the step (``lm_engine._check_cache``).

``--tp N`` sets the ``model`` axis: N ranks of ``launch/gossip.py``'s
``run_on_grid``, one card a rank (``nccl``) where the machine has N
cards, else sharing one card (``gloo``, collectives staged through the
host).  A MoE arch (granite-moe-3b-a800m, deepseek-v2-lite-16b) is
served expert parallel on those ranks, its experts padded to a multiple
of N (``ep_pad_to``) and combined by the psum form, as the reference's
launcher serves it.  Rank 0 times its collectives (the card
synchronised around each) and the printout gives their calls, bytes and
seconds a step, over all steps and over the steps after the first (in
which ``nccl`` makes its communicators); on a card one more step runs,
rank 0's under the profiler, for its device busy share.  ``--seq-len``
and ``--batch`` cut the named ``--shape`` (``decode_32k``'s batch of 128
at 32k positions is sized for the reference's 256-chip pod); every cut
is printed.  ``--multi-pod`` is
refused: the port serves on ``model`` ranks only.  ``--device cpu`` is
the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.config import (
    ARCHS,
    MeshConfig,
    ShapeConfig,
    get_model_config,
    get_shape,
)
from repro_torch.core.state import resolve_device
from repro_torch.launch.gossip import pick_backend, run_on_grid
from repro_torch.launch.lm_engine import make_serve_step
from repro_torch.models import Ctx, build_model
from repro_torch.models.api import cache_specs, tp_refusal
from repro_torch.train.shard import init_shard

SEED = 0


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def busy_share(fn, device) -> dict:
    """One ``fn()`` under ``torch.profiler`` (CUDA activity): its host
    milliseconds (ended by a synchronize) and the share of them the
    device spent in kernels and copies."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(ev, "device_time_total", 0.0)
                  for ev in prof.key_averages())
    return {"wall_ms": 1e3 * wall, "busy": busy_us / (1e6 * wall)}


def serve_rank(rank, device, cfg, shape: ShapeConfig, mesh_cfg: MeshConfig,
               steps: int) -> dict:
    """One rank's decode loop: its shards, a zero cache shard, ``steps``
    greedy steps.  Returns the tokens (steps, B), the loop's seconds, each
    step's seconds (the card synchronised after it), rank 0's collectives
    (``TP.stats``: calls, host seconds with the card synchronised around
    each, bytes; ``collectives_first_step`` those of the first step, in
    which ``nccl`` makes its communicators) and the rank's bytes of shards
    and cache and its peak device memory; on a card, one more step on
    every rank, rank 0's under the profiler with its collectives untimed
    (``busy_share``)."""

    group = dist.group.WORLD if dist.is_initialized() else None
    ep = cfg.moe is not None and mesh_cfg.model > 1
    ctx = Ctx(attn_impl="kernel", ep_pad_to=mesh_cfg.model if ep else 0)
    model = build_model(cfg, ctx, device=device)
    step, info = make_serve_step(model, group, mesh_cfg, shape)
    params = init_shard(SEED, cfg, ctx, mesh_cfg, rank, device)
    tp = info["model"].ctx.tp
    if tp is not None:
        tp.timed = rank == 0
    cache = info["model"].init_cache(shape.global_batch, info["max_len"])
    tok = torch.zeros(shape.global_batch, dtype=torch.int32, device=device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    out, step_s, first = [], [], {}
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok, shape.seq_len - 1)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
        sync()
        step_s.append(time.perf_counter() - t0)
        if len(step_s) == 1 and tp is not None:
            first = {op: list(row) for op, row in tp.stats.items()}
    busy = None
    if cuda:
        if tp is not None:
            tp.timed = False
        run = lambda: step(params, cache, tok, shape.seq_len - 1)  # noqa: E731
        if rank == 0:
            busy = busy_share(run, device)
        else:
            run()
            sync()
    return {"tokens": torch.stack(out).cpu().tolist(), "profile": busy,
            "seconds": sum(step_s), "step_seconds": step_s,
            "collectives": {} if tp is None else tp.stats,
            "collectives_first_step": first,
            "param_bytes": _nbytes(params), "cache_bytes": _nbytes(cache),
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if cuda else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks on the model axis")
    ap.add_argument("--batch", type=int, help="cut the shape's batch")
    ap.add_argument("--seq-len", type=int, help="cut the shape's length")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: the JAX package's multi-pod mesh")
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod: the JAX package's pod x data x model mesh; "
                 "the port serves on the ranks of the model axis only "
                 "(--tp), and data-parallel or FSDP serving is not ported "
                 "(ROADMAP.md queue 1, item 6.8)")

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    shape = get_shape(args.shape)
    cuts = []
    batch = args.batch or shape.global_batch
    seq_len = args.seq_len or shape.seq_len
    if batch != shape.global_batch:
        cuts.append(f"batch {shape.global_batch} -> {batch}")
    if seq_len != shape.seq_len:
        cuts.append(f"seq_len {shape.seq_len} -> {seq_len}")
    if cuts:
        shape = ShapeConfig(f"{shape.name}-cut", seq_len, batch, shape.kind)
    reason = tp_refusal(cfg, args.tp)
    if reason:
        raise NotImplementedError(reason)
    mesh_cfg = MeshConfig(data=1, model=args.tp, fsdp=False)
    backend = (pick_backend(device.type, args.tp) if args.tp > 1
               else "none")
    print(f"[serve] {cfg.name} on {args.tp} rank(s) ({backend}, "
          f"{device.type}); cuts: {', '.join(cuts) or 'none'}", flush=True)

    if args.tp == 1:
        ranks = [serve_rank(0, device, cfg, shape, mesh_cfg, args.steps)]
    else:
        ranks = run_on_grid(serve_rank, (1, args.tp), cfg, shape, mesh_cfg,
                            args.steps, device=device.type)
    # the one process's cache at the same batch and depth, on meta
    max_len = shape.seq_len + (cfg.num_patch_tokens if cfg.family == "vlm"
                               else 0)
    one_cache = _nbytes(cache_specs(build_model(cfg, device="meta"),
                                    shape.global_batch, max_len))
    for r, res in enumerate(ranks):
        peak = ("n/a" if res["peak_bytes"] is None
                else f"{res['peak_bytes'] / 2**30:.2f} GiB")
        print(f"[serve] rank {r}: parameters {res['param_bytes'] / 1e9:.3f} "
              f"GB, cache {res['cache_bytes'] / 1e9:.3f} GB (one process: "
              f"{one_cache / 1e9:.3f} GB), peak {peak}", flush=True)
    dt, step_s = ranks[0]["seconds"], sorted(ranks[0]["step_seconds"])
    print(f"[serve] greedy tokens (step x batch): {ranks[0]['tokens']}",
          flush=True)
    print(f"[serve] {args.steps} decode steps x batch {shape.global_batch}: "
          f"{args.steps * shape.global_batch / dt:.1f} tok/s; a step "
          f"{1e3 * step_s[len(step_s) // 2]:.3f} ms median, the first "
          f"{1e3 * ranks[0]['step_seconds'][0]:.3f} ms (rank 0)", flush=True)
    if ranks[0]["profile"] is not None:
        prof = ranks[0]["profile"]
        print(f"[serve] rank 0 one more step under the profiler: "
              f"{prof['wall_ms']:.3f} ms, device busy "
              f"{100 * prof['busy']:.1f}%", flush=True)
    for op, (calls, secs, nbytes) in sorted(ranks[0]["collectives"].items()):
        print(f"[serve] rank 0 {op}: {calls / args.steps:g} calls, "
              f"{nbytes / args.steps:.0f} bytes, {1e3 * secs / args.steps:.3f}"
              f" ms a step ({100 * secs / dt:.1f}% of the steps; the card "
              "synchronised around each)", flush=True)
    if args.steps > 1 and ranks[0]["collectives"]:
        # the steps after the first, whose collectives make no communicator
        later = sum(ranks[0]["step_seconds"][1:])
        first = ranks[0]["collectives_first_step"]
        for op, (calls, secs, _) in sorted(ranks[0]["collectives"].items()):
            secs -= first.get(op, [0, 0.0, 0])[1]
            print(f"[serve] rank 0 {op}, steps 2-{args.steps}: "
                  f"{1e3 * secs / (args.steps - 1):.3f} ms a step "
                  f"({100 * secs / later:.1f}% of those steps)", flush=True)
    return {"ranks": ranks, "shape": shape, "cuts": cuts, "backend": backend,
            "one_process_cache_bytes": one_cache}


if __name__ == "__main__":
    main()
