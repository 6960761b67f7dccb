"""Serving launcher: decode on a ``pod x data x model`` grid of ranks (port
of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen1.5-32b --data 2 --tp 2 \
        --batch 8 --seq-len 4096 --steps 8 [--device cpu]
    python -m repro_torch.launch.serve --arch internvl2-76b --tp 4 \
        --batch 4 --seq-len 2048 --steps 32 [--device cpu]
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
        --tp 4 --batch 4 --seq-len 4096 --steps 8 [--device cpu]
    python -m repro_torch.launch.serve --arch whisper-large-v3 --tp 2 \
        --batch 4 --seq-len 448 --steps 8 [--device cpu]
    python -m repro_torch.launch.serve --arch granite-34b --tp 4 \
        --batch 32 --seq-len 32768 --steps 16 [--device cpu]
    python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --shape long_500k --data 2 --tp 2 --steps 8 [--device cpu]

As the reference does, it runs ``--steps`` decode steps of
``make_serve_step`` from a zero cache at position ``seq_len - 1``,
feeding each step's greedy token back, and prints ``[serve] ... tok/s``.
There is no prefill, so no prompt, frames or patches: mamba2 and zamba2
decode from a zero SSM state, whisper from a zero cross-attention cache.
The parameters are seeded shards (``train/shard.py::init_shard``, seed 0),
so every grid serves the same weights and prints the same greedy tokens.
Every arch serves on ``--tp`` model ranks where its query heads split
(``models/api.py::tp_refusal``); where its KV heads do not
(granite-34b's one), each rank holds every KV head over its slice of the
positions, as the rules cut the cache.  A batch equal to a stacking dim
of its cache (zamba2's 9 units, whisper's 32 decoder layers) is refused
by the step (``lm_engine._check_cache``).

The grid is the reference launcher's: ``--data N`` data ranks (one pod;
``--multi-pod`` two, as ``multi_pod_config``) times ``--tp`` model ranks,
FSDP on over the data ranks (``MeshConfig.fsdp``, the reference's
default) unless ``--no-fsdp``, the batch cut over ``pod x data``, and the
``Ctx`` built as the reference builds it (``dp`` the batch axes, a MoE
arch's experts padded to a multiple of ``--tp`` and combined by the psum
form).  The dense, VLM, MoE, SSM and hybrid families serve data
parallel.  A batch that does not split over ``pod x data`` (``--shape
long_500k``: B = 1 at 524,288 positions, mamba2-780m's and zamba2-2.7b's
cell) runs whole on every rank, and the rules cut its KV caches' positions
over the data ranks; the encoder-decoder family on data ranks and MLA at
such a batch are refused naming their ROADMAP item
(``train/shard.py::check_mesh``).  The ranks are ``launch/gossip.py``'s
``run_on_grid``: one card a rank (``nccl``) where the machine has that
many cards, else all on one card (``gloo``, collectives staged through
the host).  Each rank's parameter and cache bytes are printed beside the
one process's and beside ``--no-fsdp``'s (``shard_nbytes`` of the
specs), and its cache's KV and SSM-state bytes beside the one process's.
Rank 0 times its collectives (the card synchronised around each): its
model group's, its FSDP gathers (one a unit), the partial softmax's
all-reduces over its data group where the KV positions are cut on
``"data"`` and the logits' gather over its batch group, in calls, bytes
and seconds a step, over all
steps and over the steps after the first (in which ``nccl`` makes its
communicators); on a card one more step runs, rank 0's under the
profiler, for its device busy share.  ``--seq-len`` and ``--batch`` cut
the named ``--shape`` (``decode_32k``'s batch of 128 at 32k positions is
sized for the reference's 256-chip pod); every cut is printed.
``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.models.api import cache_specs, param_specs, tp_refusal
from repro_torch.optim.optimizers import tree_map_with_path
from repro_torch.train import sharding as S
from repro_torch.train.shard import (check_mesh, init_shard,
                                     rank_cache_pspecs, shard_nbytes)

SEED = 0


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _gb(n: int) -> str:
    return f"{n / 1e9:.6g} GB"


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


def _groups(info) -> dict:
    """A step's rank's groups other than its model group, by the prefix
    of their ops in ``collectives``."""

    ctx = info["model"].ctx
    return {"fsdp": ctx.fsdp, "kv_seq": ctx.kv_seq,
            "batch": info["grid"].batch}


def collectives(info) -> dict:
    """The rank's collective records by op: its model group's
    (``TP.stats``), its FSDP gathers (``"fsdp_all_gather"``), the partial
    softmax's over its data group (``"kv_seq_all_reduce"``,
    ``"kv_seq_all_reduce_max"``) and the logits' gather over its batch
    group (``"batch_all_gather"``)."""

    tp = info["model"].ctx.tp
    out = {} if tp is None else dict(tp.stats)
    for name, group in _groups(info).items():
        if group is not None:
            out.update({f"{name}_{op}": row
                        for op, row in group.stats.items()})
    return out


def set_timed(info, on: bool) -> None:
    """Set ``timed`` on every group of a step's rank (``collectives``)."""

    for tp in (info["model"].ctx.tp, *_groups(info).values()):
        if tp is not None:
            tp.timed = on


def serve_rank(rank, device, cfg, shape: ShapeConfig, mesh_cfg: MeshConfig,
               steps: int) -> dict:
    """One rank's decode loop: its shards, a zero cache shard, ``steps``
    greedy steps.  Returns the tokens (steps, B), the loop's seconds, each
    step's seconds (the card synchronised after it), rank 0's collectives
    (``collectives``: calls, host seconds with the card synchronised
    around each, bytes; ``collectives_first_step`` those of the first
    step, in which ``nccl`` makes its communicators) and the rank's bytes
    of shards and cache and its peak device memory; on a card, one more
    step on every rank, rank 0's under the profiler with its collectives
    untimed (``busy_share``)."""

    group = dist.group.WORLD if dist.is_initialized() else None
    ctx = serving_ctx(cfg, mesh_cfg)
    model = build_model(cfg, ctx, device=device)
    step, info = make_serve_step(model, group, mesh_cfg, shape)
    params = init_shard(SEED, cfg, ctx, mesh_cfg, rank, device)
    set_timed(info, rank == 0)
    cache = info["model"].init_cache(info["grid"].rows(shape.global_batch),
                                     info["max_len"])
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
        if len(step_s) == 1:
            first = {op: list(row) for op, row in collectives(info).items()}
    busy = None
    if cuda:
        set_timed(info, False)
        run = lambda: step(params, cache, tok, shape.seq_len - 1)  # noqa: E731
        if rank == 0:
            busy = busy_share(run, device)
        else:
            run()
            sync()
    return {"tokens": torch.stack(out).cpu().tolist(), "profile": busy,
            "seconds": sum(step_s), "step_seconds": step_s,
            "collectives": collectives(info),
            "collectives_first_step": first,
            "param_bytes": _nbytes(params), "cache_bytes": _nbytes(cache),
            "cache_parts": cache_parts(cache, lambda x: x.numel()
                                       * x.element_size()),
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if cuda else None}


# an SSM state's leaves (``SSMState``); every other cache leaf is an
# attention cache's (k and v, MLA's latents, whisper's cross k and v)
STATE_LEAVES = ("h", "conv_x", "conv_B", "conv_C")


def cache_parts(cache, nbytes, specs=None) -> dict:
    """``{"kv": bytes, "state": bytes}`` of a cache tree: ``nbytes(leaf)``
    or, with ``specs``, ``nbytes(leaf, spec)``, summed over its attention
    caches' leaves and its SSM states' leaves."""

    out = {"kv": 0, "state": 0}

    def visit(path, x, *spec):
        out["state" if S.leaf_name(path) in STATE_LEAVES
            else "kv"] += nbytes(x, *spec)

    if specs is None:
        tree_map_with_path(visit, cache)
    else:
        tree_map_with_path(visit, cache, specs)
    return out


def serving_ctx(cfg, mesh_cfg: MeshConfig) -> Ctx:
    """The ``Ctx`` the reference launcher builds: the kernel attention, a
    MoE arch's experts padded to the model axis, the batch axes as
    ``dp``."""

    ep = cfg.moe is not None and mesh_cfg.model > 1
    return Ctx(attn_impl="kernel", ep_pad_to=mesh_cfg.model if ep else 0,
               dp=S.dp_axes(mesh_cfg))


def rank_bytes(cfg, shape: ShapeConfig, mesh_cfg: MeshConfig,
               cache_dtype=torch.bfloat16) -> dict:
    """A rank's bytes of parameters and cache by the specs (``meta``;
    nothing is allocated): at ``mesh_cfg``, without FSDP, and in one
    process, each ``(parameter bytes, cache bytes)``; and under
    ``"parts"`` the cache's ``cache_parts`` at ``mesh_cfg`` and in one
    process (``{"grid": ..., "one": ...}``)."""

    ctx = dataclasses.replace(serving_ctx(cfg, mesh_cfg),
                              cache_dtype=cache_dtype)
    meta = build_model(cfg, ctx, device="meta")
    shapes = param_specs(meta)
    max_len = shape.seq_len + (cfg.num_patch_tokens if cfg.family == "vlm"
                               else 0)
    cshapes = cache_specs(meta, shape.global_batch, max_len)
    out = {}
    for key, mc in (("grid", mesh_cfg),
                    ("no_fsdp", dataclasses.replace(mesh_cfg, fsdp=False)),
                    ("one", MeshConfig(data=1, model=1, fsdp=False))):
        pspecs = S.param_pspecs(cfg, shapes, mc)
        cspecs = rank_cache_pspecs(cshapes, S.cache_pspecs_tree(
            cfg, shape, mc, cshapes))
        out[key] = (shard_nbytes(shapes, pspecs, mc),
                    shard_nbytes(cshapes, cspecs, mc))
        if key != "no_fsdp":
            out.setdefault("parts", {})[key] = cache_parts(
                cshapes, lambda x, spec, mc=mc: shard_nbytes(x, spec, mc),
                cspecs)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks on the model axis")
    ap.add_argument("--data", type=int, default=1,
                    help="ranks on the data axis (a pod's)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods, as the reference's multi_pod_config")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="weights whole over the data ranks")
    ap.add_argument("--batch", type=int, help="cut the shape's batch")
    ap.add_argument("--seq-len", type=int, help="cut the shape's length")
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

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
    pods = 2 if args.multi_pod else 1
    mesh_cfg = MeshConfig(multi_pod=args.multi_pod, pod=pods,
                          data=args.data, model=args.tp,
                          fsdp=not args.no_fsdp)
    check_mesh(mesh_cfg, cfg, shape.global_batch)
    world = mesh_cfg.num_devices
    backend = pick_backend(device.type, world) if world > 1 else "none"
    print(f"[serve] {cfg.name} on {pods} x {args.data} x {args.tp} "
          f"(pod x data x model) rank(s), FSDP "
          f"{'on' if mesh_cfg.fsdp and args.data > 1 else 'off'} "
          f"({backend}, {device.type}); cuts: {', '.join(cuts) or 'none'}",
          flush=True)

    if world == 1:
        ranks = [serve_rank(0, device, cfg, shape, mesh_cfg, args.steps)]
    else:
        ranks = run_on_grid(serve_rank, (pods * args.data, args.tp), cfg,
                            shape, mesh_cfg, args.steps, device=device.type)
    reckoned = rank_bytes(cfg, shape, mesh_cfg)
    (one_p, one_c), (nf_p, nf_c) = reckoned["one"], reckoned["no_fsdp"]
    one_parts = reckoned["parts"]["one"]
    for r, res in enumerate(ranks):
        peak = ("n/a" if res["peak_bytes"] is None
                else f"{res['peak_bytes'] / 2**30:.2f} GiB")
        parts = res["cache_parts"]
        print(f"[serve] rank {r}: parameters {_gb(res['param_bytes'])} "
              f"(one process: {_gb(one_p)}, --no-fsdp: {_gb(nf_p)}), cache "
              f"{_gb(res['cache_bytes'])} (one process: {_gb(one_c)}, "
              f"--no-fsdp: {_gb(nf_c)}): KV {_gb(parts['kv'])} (one "
              f"process: {_gb(one_parts['kv'])}), SSM state "
              f"{_gb(parts['state'])} (one process: "
              f"{_gb(one_parts['state'])}); peak {peak}", flush=True)
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
            "mesh_cfg": mesh_cfg, "one_process_cache_bytes": one_c,
            "reckoned_bytes": reckoned}


if __name__ == "__main__":
    main()
