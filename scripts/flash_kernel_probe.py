#!/usr/bin/env python3
"""Where the flash kernel's time goes on the card, and the rate it could
reach.  Needs an NVIDIA H100 (or another sm_90a card) and ``nvcc``::

    python3 scripts/flash_kernel_probe.py

1. The ``mma.sync.m16n8k8`` TF32 rate of the card: a kernel in which every
   warp runs eight independent chains of that MMA (the instruction that
   ``kernels/csrc/flash_attention.cu`` uses), at one CTA of 8 warps per SM
   (the flash kernel's occupancy) and at four.
2. The flash kernel built with ``-DFLASH_PHASE_CLOCKS`` at the gemma2-2b
   prefill shapes (q (4, 8, 8000, 256), k/v (4, 4, 8000, 256), causal,
   softcap 50; global and window 4096): its time (CUDA events, median of 5)
   and the share of the warps' SM cycles in each phase of its key-tile
   loop.  The clocks cost a few instructions per phase, so these times are
   a little above the uninstrumented kernel's.

Prints one JSON object per measurement.  The builds go to
``src/repro_torch/kernels/_build`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import _build  # noqa: E402

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 1);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += c[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_run(float* out, int blocks, int iters) {
  mma_peak<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
PHASES = ("wait K tile + barrier", "Q.K^T", "mask + softmax",
          "wait V tile + barrier + issue next K", "P.V", "barrier")


def compile_so(name: str, src: str, extra=()) -> ctypes.CDLL:
    _build._OUT.mkdir(parents=True, exist_ok=True)
    out = _build._OUT / f"{name}.so"
    subprocess.run([_build.nvcc(), *_build.FLAGS, *extra, "-o", str(out),
                    src], check=True)
    return ctypes.CDLL(str(out))


def events_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def mma_peak(card: str) -> None:
    src = _build._OUT / "mma_peak.cu"
    _build._OUT.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_PEAK_CU)
    lib = compile_so("mma_peak", str(src))
    lib.mma_peak_run.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 256, device="cuda")
    iters = 20000
    for per_sm in (1, 4):
        blocks = per_sm * sms

        def run():
            if lib.mma_peak_run(out.data_ptr(), blocks, iters) != 0:
                raise RuntimeError("mma_peak failed to launch")

        ms = events_ms(run, reps=3)
        flops = blocks * 8 * iters * 8 * (2 * 16 * 8 * 8)
        print(json.dumps({"probe": "mma.sync m16n8k8 tf32", "card": card,
                          "ctas_per_sm": per_sm, "warps_per_sm": 8 * per_sm,
                          "ms": ms, "tflops": flops / ms / 1e9}), flush=True)


def phases(card: str) -> None:
    lib = compile_so("flash_attention-phases",
                     str(_build._CSRC / "flash_attention.cu"),
                     ("-DFLASH_PHASE_CLOCKS",))
    lib.flash_attention.argtypes, lib.flash_attention.restype = (
        _build.SIGNATURES["flash_attention"]["flash_attention"])
    lib.flash_phase_read.argtypes = (ctypes.c_void_p,)
    B, Hq, Hkv, L, D = 4, 8, 4, 8000, 256
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(s, generator=g, device="cuda")
               for s in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for label, window in (("global", 0), ("local", 4096)):
        def run():
            rc = lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Hq, Hkv, L, L, D, D, 1, window, 50.0, 0, 0, 1, stream)
            _build.check("flash_attention", rc)

        ms = events_ms(run)
        _build.check("flash_phase_reset", lib.flash_phase_reset())
        run()
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 7)()
        _build.check("flash_phase_read", lib.flash_phase_read(sums))
        cycles = list(sums)[:6]
        total = sum(cycles)
        print(json.dumps({
            "probe": "flash_attention phases", "card": card, "layer": label,
            "ms_instrumented": ms, "warps": sums[6],
            "cycles_per_warp": total / sums[6],
            "share": {name: c / total for name, c in zip(PHASES, cycles)}}),
            flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_kernel_probe: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    mma_peak(card)
    phases(card)


if __name__ == "__main__":
    main()
