"""Per-device dequant-score method selection (``method=None``).

Port of ``repro.kernels.quant.autotune`` without the committed sweep: the
JAX package's ``benchmarks/BENCH_quant.json`` was measured with XLA on a
CPU and says nothing about this port, and no sweep on the card exists yet.
An explicit ``method=`` always wins; ``None`` resolves from the device the
tensors live on:

* ``cpu``  — ``"dequant"``: the plain f32 matmul rides the BLAS kernel;
  the fused path's exact integer dot is a float64 product there.
* ``cuda`` — ``"fused"``: the hand-written kernel reads the int8 codes
  once and accumulates their products in int32.
"""

from __future__ import annotations

import torch

METHODS = ("fused", "dequant")

FALLBACK_METHOD = {"cpu": "dequant", "cuda": "fused"}


def resolve_method(method: str | None, device) -> str:
    """The scoring method for tensors on ``device``.

    ``method`` not None → validated and returned unchanged.  Otherwise the
    per-device default above, else ``"dequant"`` (correct everywhere)."""

    if method is not None:
        if method not in METHODS:
            raise ValueError(
                f"unknown dequant-score method {method!r}; "
                f"expected one of {METHODS}"
            )
        return method
    return FALLBACK_METHOD.get(torch.device(device).type, "dequant")
