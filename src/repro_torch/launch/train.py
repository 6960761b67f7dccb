"""LM training launcher on one card or a ``pod x data x model`` grid of
ranks (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch gemma2-2b --shape train_4k \\
        --steps 500 --microbatch 8 --ckpt DIR --ckpt-every 100 [--device cpu]
    python -m repro_torch.launch.train --arch gemma2-2b --shape train_4k \\
        --data 2 --tp 2 [--multi-pod] --microbatch 128 --steps 2 \\
        --ckpt DIR [--device cpu]

Data comes from ``LMTokenPipeline(vocab, seq_len, global_batch)`` at each
step; the model is built with ``Ctx(attn_impl="ref", remat=True)`` (the
flash kernel has no backward; ``train_ctx``: the MoE family on model
ranks in the psum form, its experts padded to the axis, as the
reference's launcher builds it) and trained by ``train/step.py``'s
``make_sharded_train_step`` with the optimizer of ``TrainConfig``'s
defaults (its clip over the whole tree).  Fault tolerance: a checkpoint
of ``{"p": params, "o": opt_state}`` every ``--ckpt-every`` steps and at
the end (atomic, in the JAX package's format), and a restart resumes from
the latest valid one; the pipeline is a pure function of (seed, step), so
a resumed run continues the exact stream.

The grid is the reference launcher's mesh: ``--data N`` data ranks (one
pod; ``--multi-pod`` two, as ``multi_pod_config``), FSDP on over the
data ranks, the batch and each microbatch part cut over ``pod x data``,
and ``--tp M`` model ranks in each data row, holding its heads, FFN
columns and vocab range (the logits never gathered: a vocab-parallel
cross-entropy); ranks = pods·N·M, rank = (pod·N + data)·M + model.  The
dense and MoE families only on more than one rank (item 6.2c), with
query heads that divide ``--tp`` (item 6.8); the KV heads need not
(granite-34b's one KV head trains at ``--tp 4``: each rank gathers k and
v whole, or computes them whole where the rules keep ``wk``/``wv``
whole); the MoE family trains with expert parallelism on the model
ranks, as the reference's launcher trains it.  The ranks
are ``launch/gossip.py``'s ``run_on_grid``: one card a rank (``nccl``)
where the machine has that many cards, else all on one card (``gloo``,
collectives staged through the host).  Every grid starts from one seeded
init (``model.init``, one card's), each rank keeping its slice
(``train/shard.py::shard_params``).  A checkpoint holds the whole tree:
each FSDP and model shard is gathered whole to rank 0, which saves; a
restart reads the whole leaves on every rank and keeps its slice, so a
checkpoint written on one grid restores on another and on one card.
Rank 0 prints its bytes of parameters and state beside one card's, each
step's seconds, its collectives (the card synchronised around each) and,
on a card, the last step's device busy share under the profiler (that
step's collectives untimed).

The reference's multi-host flag has no counterpart here: ``--distributed``
raises (the ranks run on one host).  The reference parses ``--sync`` and
never reads it; the port accepts only ``allreduce`` (the exact gradient),
rather than silently ignoring ``gossip``: gossip data-parallel training
runs on ranks through ``train/gossip_dp.py``.

``--arch`` takes the token-only archs: the JAX launcher builds
``{"tokens", "targets"}`` batches only, so whisper-large-v3 (frames) and
internvl2-76b (patches) fail there at the batch's missing key; the port
adds no frame or patch pipeline that the reference lacks.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (
    ARCHS,
    MeshConfig,
    TrainConfig,
    get_model_config,
    get_shape,
)
from repro_torch.core.state import resolve_device
from repro_torch.data import LMTokenPipeline
from repro_torch.launch.gossip import pick_backend, run_on_grid
from repro_torch.launch.serve import busy_share
from repro_torch.models import Ctx, build_model
from repro_torch.models.api import param_specs
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.shard import check_train_mesh, dp_size, shard_params
from repro_torch.train.step import make_sharded_train_step, shard_state


# the archs whose batches are tokens and targets alone
TOKEN_ARCHS = [a for a in ARCHS
               if get_model_config(a).family not in ("encdec", "vlm")]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _groups(info) -> dict:
    grid = info["grid"]
    return {"fsdp": grid.fsdp, "batch": grid.batch, "pod": grid.pod,
            "model": grid.model}


def collectives(info) -> dict:
    """The rank's collective records by op (``[calls, seconds, bytes]``):
    its FSDP gathers and reduce-scatters and the clip's all-reduce
    (``"fsdp_*"``), the replicated gradients', the loss's and the valid
    targets' all-reduces over the batch group (``"batch_all_reduce"``),
    the FSDP gradients' over the pods (``"pod_all_reduce"``) and the
    model group's: the row-parallel products' sums and their conjugates'
    gradients, the lookup's, the cross-entropy's, the clip's and, where
    the rules keep ``wk``/``wv`` whole under a split ``wo``, their
    gradients' (``"model_all_reduce"``), the logits' maxima
    (``"model_all_reduce_max"``) and, where they cut ``wk``/``wv`` in
    parts of a head, the k/v gathers and their backward's
    reduce-scatters (``"model_all_gather"``,
    ``"model_reduce_scatter"``)."""

    out = {}
    for name, group in _groups(info).items():
        if group is not None:
            out.update({f"{name}_{op}": list(row)
                        for op, row in group.stats.items()})
    return out


def _set_timed(info, on: bool) -> None:
    for group in _groups(info).values():
        if group is not None:
            group.timed = on


def train_ctx(cfg, mesh_cfg: MeshConfig) -> Ctx:
    """The model's ``Ctx``, as the reference's launcher builds it: the
    plain attention (``"ref"``), remat, and for the MoE family on more
    than one model rank expert parallelism in the psum form with the
    experts padded to the model axis (``ep_pad_to``,
    ``src/repro/launch/train.py:59–63``)."""

    ep = cfg.moe is not None and mesh_cfg.model > 1
    return Ctx(attn_impl="ref", remat=True,
               ep_pad_to=mesh_cfg.model if ep else 0, moe_impl="psum")


def train_rank(rank, device, cfg, shape, mesh_cfg: MeshConfig,
               tc: TrainConfig, steps: int, ckpt: str,
               ckpt_every: int) -> dict:
    """One rank's training loop (see the module docstring): its losses,
    each step's seconds (the card synchronised after it; a profiled
    step's the profiler's own wall, without its processing), the step it
    started from, rank 0's collectives, the rank's bytes of parameters
    and state, its peak device memory and, on a card, rank 0's profile of
    the last step."""

    group = dist.group.WORLD if dist.is_initialized() else None
    world = mesh_cfg.num_devices
    model = build_model(cfg, train_ctx(cfg, mesh_cfg), device=device)
    step, info = make_sharded_train_step(model, group, mesh_cfg, shape, tc)
    optimizer = info["optimizer"]
    mgr = CheckpointManager(ckpt)
    shapes = param_specs(model)
    restored = mgr.restore({"p": shapes, "o": optimizer.init(shapes)},
                           device="cpu")
    if restored:
        start, tree = restored
        params, opt_state = shard_state(tree["p"], tree["o"], info, rank,
                                        device)
        del tree
        if rank == 0:
            print(f"[launch] resumed at step {start}", flush=True)
    else:
        start = 0
        params = model.init(torch.Generator(device=device).manual_seed(
            tc.seed))
        if world > 1:
            params = shard_params(params, info["pspecs"], mesh_cfg, rank)
        opt_state = optimizer.init(params)
    specs = {"p": info["pspecs"], "o": info["ospecs"]}

    def save(at: int) -> None:
        # the checkpoint's gathers are not a step's collectives
        _set_timed(info, False)
        tree = {"p": params, "o": opt_state}
        if world > 1:
            tree = info["grid"].whole(tree, specs, keep=rank == 0)
        if rank == 0:
            mgr.save(at, tree)
        del tree
        if world > 1:
            dist.barrier()

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    pipe = LMTokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch)
    losses, step_s, profile, first = [], [], None, {}
    t0 = time.perf_counter()
    for i in range(start, steps):
        tok, tgt = pipe.batch_at(i)
        batch = {"tokens": tok, "targets": tgt}
        run = lambda: step(params, opt_state, batch)  # noqa: E731
        profiled = cuda and i == steps - 1 and steps - start > 1
        _set_timed(info, rank == 0 and not profiled)
        sync()
        t_step = time.perf_counter()
        if profiled and rank == 0:
            out = []
            profile = busy_share(lambda: out.append(run()), device)
            params, opt_state, metrics = out[0]
            # the step's own wall, without the profiler's processing
            step_s.append(profile["wall_ms"] / 1e3)
        else:
            params, opt_state, metrics = run()
            sync()
            step_s.append(time.perf_counter() - t_step)
        losses.append(float(metrics["loss"]))
        if len(step_s) == 1:
            first = collectives(info)
        if rank == 0 and (i + 1) % 10 == 0:
            print(f"[launch] step {i+1} loss {losses[-1]:.4f} "
                  f"({(i+1-start)/(time.perf_counter()-t0):.2f} it/s)",
                  flush=True)
        if (i + 1) % ckpt_every == 0:
            save(i + 1)
    _set_timed(info, False)
    save(steps)
    return {"losses": losses, "start": start, "step_seconds": step_s,
            "collectives": collectives(info),
            "collectives_first_step": first, "profile": profile,
            "param_bytes": _nbytes(params), "opt_bytes": _nbytes(opt_state),
            "reckoned_bytes": (info["param_bytes"], info["opt_bytes"]),
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if cuda else None,
            "params": params if world == 1 else None,
            "opt_state": opt_state if world == 1 else None}


def _gb(n: int) -> str:
    return f"{n / 1e9:.6g} GB"


def one_card_bytes(cfg, tc: TrainConfig) -> tuple[int, int]:
    """One card's bytes of parameters and optimizer state (``meta``)."""

    shapes = param_specs(build_model(cfg, device="meta"))
    return _nbytes(shapes), _nbytes(make_optimizer(tc).init(shapes))


def train(argv=None) -> dict:
    """The launcher; returns its ranks' results (``train_rank``), the
    grid, the backend, the losses and, on one card, ``params`` and
    ``opt_state`` (on a grid the shards stay on their ranks: ``None``)."""

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=TOKEN_ARCHS, required=True,
                    help="a token-only arch (the launcher's batches hold "
                         "no frames or patches)")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--data", type=int, default=1,
                    help="ranks on the data axis (a pod's), FSDP over them")
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods, as the reference's multi_pod_config")
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks on the model axis in each data row (the "
                         "query heads must divide it)")
    ap.add_argument("--sync", choices=["allreduce", "gossip"],
                    default="allreduce")
    ap.add_argument("--microbatch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--distributed", action="store_true",
                    help="not ported: jax.distributed multi-host start-up")
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    if args.distributed:
        ap.error("--distributed starts the JAX package's multi-host runtime; "
                 "the multi-host half of launch/mesh.py has no twin in the "
                 "port, whose ranks run on one host (--data, --multi-pod)")
    if args.sync != "allreduce":
        ap.error("--sync gossip: the JAX launcher parses this flag and never "
                 "reads it; the step computes the exact gradient, and "
                 "gossip data-parallel training is train/gossip_dp.py's "
                 "make_gossip_dp_step on a rank grid")

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    shape = get_shape(args.shape)
    pods = 2 if args.multi_pod else 1
    mesh_cfg = MeshConfig(multi_pod=args.multi_pod, pod=pods, data=args.data,
                          model=args.tp, fsdp=True)
    check_train_mesh(mesh_cfg, cfg, shape.global_batch, args.microbatch)
    tc = TrainConfig(total_steps=args.steps, microbatch=args.microbatch,
                     checkpoint_dir=args.ckpt)
    world = mesh_cfg.num_devices
    backend = pick_backend(device.type, world) if world > 1 else "none"
    parts = max(args.microbatch, 1)
    print(f"[launch] {cfg.name} on {pods} x {args.data} x {args.tp} (pod x "
          f"data x model) rank(s), FSDP {'on' if args.data > 1 else 'off'} "
          f"({backend}, {device.type}); {shape.global_batch} x "
          f"{shape.seq_len} tokens a step in {parts} part(s), "
          f"{shape.global_batch // parts // dp_size(mesh_cfg)} row(s) of "
          "each a rank", flush=True)
    job = (cfg, shape, mesh_cfg, tc, args.steps, args.ckpt, args.ckpt_every)
    if world == 1:
        ranks = [train_rank(0, device, *job)]
    else:
        # a training run has no deadline, as the reference launcher's has
        # none (run_on_grid's default would end the ranks after 600 s),
        # nor has a collective: rank 0 may process a profile or write a
        # checkpoint while the others wait
        ranks = run_on_grid(train_rank, (pods * args.data, args.tp), *job,
                            device=device.type, timeout=None)
    report(ranks, cfg, tc, shape)
    return {"ranks": ranks, "mesh_cfg": mesh_cfg, "backend": backend,
            "losses": ranks[0]["losses"], "params": ranks[0]["params"],
            "opt_state": ranks[0]["opt_state"]}


def report(ranks, cfg, tc: TrainConfig, shape) -> None:
    """Rank 0's numbers of a run, and every rank's bytes."""

    one_p, one_o = one_card_bytes(cfg, tc)
    for r, res in enumerate(ranks):
        peak = ("n/a" if res["peak_bytes"] is None
                else f"{res['peak_bytes'] / 2**30:.2f} GiB")
        print(f"[launch] rank {r}: parameters {_gb(res['param_bytes'])} + "
              f"optimizer state {_gb(res['opt_bytes'])} (reckoned "
              f"{_gb(res['reckoned_bytes'][0])} + "
              f"{_gb(res['reckoned_bytes'][1])}; one card {_gb(one_p)} + "
              f"{_gb(one_o)}); peak {peak}", flush=True)
    r0 = ranks[0]
    if not r0["step_seconds"]:
        return
    tokens = shape.global_batch * shape.seq_len
    secs = r0["step_seconds"]
    print(f"[launch] losses {r0['losses']}; step seconds {secs}; tokens/s "
          f"by step {[round(tokens / x, 1) for x in secs]} (rank 0)",
          flush=True)
    if r0["profile"] is not None:
        print(f"[launch] rank 0 last step under the profiler: "
              f"{r0['profile']['wall_ms']:.3f} ms, device busy "
              f"{100 * r0['profile']['busy']:.1f}%", flush=True)
    timed = secs[:-1] if r0["profile"] is not None else secs
    first = r0["collectives_first_step"]
    for op, (calls, sec, nbytes) in sorted(r0["collectives"].items()):
        print(f"[launch] rank 0 {op}: {calls / len(timed):g} calls, "
              f"{nbytes / len(timed):.0f} bytes, "
              f"{1e3 * sec / len(timed):.3f} ms a step "
              f"({100 * sec / sum(timed):.1f}% of the timed steps; the card "
              "synchronised around each)", flush=True)
        if len(timed) > 1:
            later = sec - first.get(op, [0, 0.0, 0])[1]
            print(f"[launch] rank 0 {op}, timed steps after the first: "
                  f"{100 * later / sum(timed[1:]):.1f}% of them", flush=True)


def main(argv=None):
    """``train(argv)``'s one-card ``(params, opt_state)``."""

    out = train(argv)
    return out["params"], out["opt_state"]


if __name__ == "__main__":
    main()
