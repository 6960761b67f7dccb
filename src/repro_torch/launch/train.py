"""LM training launcher for one card (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch gemma2-2b --shape train_4k \\
        --steps 500 --microbatch 8 --ckpt DIR --ckpt-every 100 [--device cpu]

Data comes from ``LMTokenPipeline(vocab, seq_len, global_batch)`` at each
step; the model is built with ``Ctx(attn_impl="ref", remat=True)`` (the
flash kernel has no backward) and trained by ``make_train_step`` with the
optimizer of ``TrainConfig``'s defaults.  Fault tolerance: a checkpoint of
``{"p": params, "o": opt_state}`` every ``--ckpt-every`` steps and at the
end (atomic, in the JAX package's format), and a restart resumes from the
latest valid one; the pipeline is a pure function of (seed, step), so a
resumed run continues the exact stream.

The reference's mesh and multi-host flags have no counterpart here:
``--multi-pod`` and ``--distributed`` raise (there is no twin of
``launch/mesh.py``; gossip data-parallel training runs on ranks through
``train/gossip_dp.py``).  The reference parses ``--sync`` and never reads
it; the port accepts only ``allreduce`` (one card: the exact gradient),
rather than silently ignoring ``gossip``.

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

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (
    ARCHS,
    TrainConfig,
    get_model_config,
    get_shape,
)
from repro_torch.core.state import resolve_device
from repro_torch.data import LMTokenPipeline
from repro_torch.models import Ctx, build_model
from repro_torch.optim import make_optimizer
from repro_torch.train.step import make_train_step


# the archs whose batches are tokens and targets alone
TOKEN_ARCHS = [a for a in ARCHS
               if get_model_config(a).family not in ("encdec", "vlm")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=TOKEN_ARCHS, required=True,
                    help="a token-only arch (the launcher's batches hold "
                         "no frames or patches)")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: the JAX package's multi-pod mesh")
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

    if args.multi_pod or args.distributed:
        ap.error("--multi-pod and --distributed set up the JAX package's "
                 "device mesh across pods and hosts; launch/mesh.py has no "
                 "twin in the port, which trains on one card here and runs "
                 "gossip data-parallel ranks through train/gossip_dp.py")
    if args.sync != "allreduce":
        ap.error("--sync gossip: the JAX launcher parses this flag and never "
                 "reads it; one card computes the exact gradient, and "
                 "gossip data-parallel training is train/gossip_dp.py's "
                 "make_gossip_dp_step on a rank grid")

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    shape = get_shape(args.shape)
    model = build_model(cfg, Ctx(attn_impl="ref", remat=True), device=device)
    tc = TrainConfig(total_steps=args.steps, microbatch=args.microbatch,
                     checkpoint_dir=args.ckpt)
    optimizer = make_optimizer(tc)
    step = make_train_step(model, tc, optimizer)

    params = model.init(torch.Generator(device=device).manual_seed(tc.seed))
    opt_state = optimizer.init(params)
    mgr = CheckpointManager(args.ckpt)
    start = 0
    restored = mgr.restore({"p": params, "o": opt_state}, device=device)
    if restored:
        start, tree = restored
        params, opt_state = tree["p"], tree["o"]
        print(f"[launch] resumed at step {start}")

    pipe = LMTokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch)
    t0 = time.time()
    for i in range(start, args.steps):
        tok, tgt = pipe.batch_at(i)
        params, opt_state, metrics = step(
            params, opt_state, {"tokens": tok, "targets": tgt})
        if (i + 1) % 10 == 0:
            print(f"[launch] step {i+1} loss {float(metrics['loss']):.4f} "
                  f"({(i+1-start)/(time.time()-t0):.2f} it/s)")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"p": params, "o": opt_state})
    mgr.save(args.steps, {"p": params, "o": opt_state})
    return params, opt_state


if __name__ == "__main__":
    main()
