"""Per-device dequant-score method selection (``method=None``).

Port of ``repro.kernels.quant.autotune``.  An explicit ``method=`` always
wins; ``None`` consults the **committed** sweep ``method_sweep.json`` beside
this file — the ``--quant`` arm of ``launch/serving_traffic.py`` times one
full scoring query per method on the card and writes ``method_sweep_ms``
with its spread, the card's name and power limit and the geometry
(``--json``) — for the device type the tensors live on, and falls back to
a fixed per-device default when no committed sweep covers it.  The JAX
package's ``benchmarks/BENCH_quant.json`` was measured with XLA on a CPU
and says nothing about this port, so it is not read.

Fallback rationale:

* ``cpu``  — ``"dequant"``: the plain f32 matmul rides the BLAS kernel;
  the fused path's exact integer dot is a float64 product there.
* ``cuda`` — ``"fused"``: the hand-written kernel reads the int8 codes
  once and accumulates their products in int32.

The lookup reads one small JSON at most once per process.
"""

from __future__ import annotations

import functools
import json
import os

import torch

METHODS = ("fused", "dequant")

FALLBACK_METHOD = {"cpu": "dequant", "cuda": "fused"}

# the committed sweep (measured on the card; keyed by its "backend")
SWEEP_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "method_sweep.json")


def _sweep_table(path: str) -> dict[str, str]:
    """device type -> fastest method from a committed --quant sweep."""

    with open(path) as f:
        data = json.load(f)
    sweep = {m: float(ms) for m, ms in
             (data.get("method_sweep_ms") or {}).items() if m in METHODS}
    if not sweep:
        return {}
    return {data.get("backend", "cpu"): min(sweep, key=sweep.get)}


@functools.lru_cache(maxsize=None)
def _committed_sweep() -> dict[str, str]:
    try:
        return _sweep_table(SWEEP_PATH)
    except (OSError, ValueError, KeyError):
        return {}


def resolve_method(method: str | None, device) -> str:
    """The scoring method for tensors on ``device``.

    ``method`` not None → validated and returned unchanged.  Otherwise the
    committed sweep's winner for the device's type, else the per-device
    default above, else ``"dequant"`` (correct everywhere)."""

    if method is not None:
        if method not in METHODS:
            raise ValueError(
                f"unknown dequant-score method {method!r}; "
                f"expected one of {METHODS}"
            )
        return method
    kind = torch.device(device).type
    best = _committed_sweep().get(kind)
    if best is not None:
        return best
    return FALLBACK_METHOD.get(kind, "dequant")
