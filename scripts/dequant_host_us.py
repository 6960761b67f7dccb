#!/usr/bin/env python3
"""Host microseconds a call of the ``dequant_score`` wrapper takes.

    python3 scripts/dequant_host_us.py [--src DIR] [--batch 1024]
        [--items 3706] [--rank 15]

Imports ``repro_torch`` from ``DIR`` (the ``src`` directory of a checkout;
by default this repository's), builds its ``dequant_score`` kernel there,
and times the wrapper ``kernels/quant/ops.py::dequant_score`` on seeded
int8 codes as ``chip_smoke.first_kernel_and_host`` times it: ``--calls``
calls queued back to back, wall time over the calls, ``--rounds`` rounds,
the median round.  Prints one JSON line with the card's name.

To compare two commits, unpack the other into a directory that
``.gitignore`` lists and run both trees in one session on one card, in
the order A B B A.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--items", type=int, default=3706)
    ap.add_argument("--rank", type=int, default=15)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.kernels.quant import ops

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs an "
                 "NVIDIA GPU")
    rng = np.random.default_rng(0)
    B, n, r = args.batch, args.items, args.rank
    codes = [rng.integers(-127, 128, (B, r)).astype(np.int8),
             rng.lognormal(-3.0, 1.0, B).astype(np.float32),
             rng.integers(-127, 128, (n, r)).astype(np.int8),
             rng.lognormal(-3.0, 1.0, n).astype(np.float32)]
    codes = [torch.from_numpy(a).cuda() for a in codes]
    ops.dequant_score(*codes, method="fused")          # builds, loads
    rounds = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            ops.dequant_score(*codes, method="fused")
        rounds.append((time.perf_counter() - t0) / args.calls * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"src": os.path.relpath(os.path.abspath(args.src),
                                             ROOT),
                      "card": torch.cuda.get_device_name(0),
                      "shape": {"B": B, "n": n, "r": r},
                      "host_us": statistics.median(rounds),
                      "rounds_us": rounds}), flush=True)
