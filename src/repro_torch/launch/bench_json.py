"""The JSON envelope of the port's benchmark twins (the counterpart of
``benchmarks/run.py::bench_json``): ``bench``, ``backend`` (the device
type the run used), ``machine`` (platform, Python, torch and CUDA
versions, device count, and on a card its name and power limit as
``nvidia-smi`` reports them), ``config``, the payload's keys at top
level, and ``metrics``, a snapshot of the ``repro_torch.obs`` registry."""

from __future__ import annotations

import json
import platform
import subprocess

import torch

from repro_torch import obs


def card_info() -> dict:
    """``{"name", "power_limit"}`` of card 0 from ``nvidia-smi`` (None
    where it cannot be read)."""

    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in line.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0), "power_limit": None}


def machine_info(device) -> dict:
    kind = torch.device(device).type
    out = {"platform": platform.platform(),
           "python": platform.python_version(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "backend": kind,
           "device_count": (torch.cuda.device_count() if kind == "cuda"
                            else 1)}
    if kind == "cuda":
        out["card"] = card_info()
    return out


def bench_json(bench: str, config: dict, device, **payload) -> dict:
    out = {"bench": bench, "backend": torch.device(device).type,
           "machine": machine_info(device), "config": config}
    for k, v in payload.items():
        if k in out:
            raise ValueError(f"payload key {k!r} collides with the envelope")
        out[k] = v
    out["metrics"] = obs.snapshot()
    return out


def emit_json(path: str, bench: str, config: dict, device,
              **payload) -> dict:
    """Write :func:`bench_json` to ``path`` and return it."""

    out = bench_json(bench, config, device, **payload)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
    return out
