#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[tp]`` phase alone on a machine with a card.

    python3 scripts/tp_phase.py

Builds the CUDA kernels, then runs ``chip_smoke.tp_phase``: the flash
kernel at a tensor-parallel rank's internvl2 shape against its plain
version, internvl2-76b (8 of 80 layers) served by one process, then by
four ``model`` ranks, and the gates and timings the phase prints.  With
four cards the ranks take one each and talk over ``nccl``; with one they
share it over ``gloo``.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an "
                "NVIDIA GPU")
    t0 = time.perf_counter()
    print(f"[build] {cs._build.build()}", flush=True)
    row = {"launches": 0}
    cs.tp_phase(torch.cuda.get_device_name(0), row)
    print(f"[tp] {time.perf_counter() - t0:.1f}s with the build", flush=True)
