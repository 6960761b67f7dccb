"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` on its own
into a shared library for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o kernels/_build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
kernel is rebuilt and a current one is reused.  Building happens at first
use, never at import (the CPU tests import every module); :func:`build`
starts one ``nvcc`` per missing library, all at once, and waits for them.
The libraries are loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, sizes are ``c_int``, floats ``c_float``, and every launch
entry returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> {C entry: (argtypes, restype)}
SIGNATURES = {
    "sddmm": {
        "sddmm_num_partials": ((_I, _I, _I), _I),    # B E r
        # rows cols vals valid col_perm row_ptr col_ptr U W | loss gU gW
        # partials | B E M N r | stream
        "sddmm_segment_grad": ((_P,) * 13 + (_I,) * 5 + (_P,), _I),
        # rows cols vals valid U W | loss gU gW partials | B E M N r | stream
        "sddmm_factor_grad": ((_P,) * 10 + (_I,) * 5 + (_P,), _I),
        # the first scatter design at any shape: the same arguments
        "sddmm_factor_grad_first": ((_P,) * 10 + (_I,) * 5 + (_P,), _I),
        "sddmm_cluster_size": ((_I,) * 4, _I),       # B M N r
    },
    "masked_factor_grad": {
        "mfg_num_partials": ((_I,), _I),                    # M
        # X mask U W | loss gU gW partials | B M N r | stream
        "masked_factor_grad": ((_P,) * 8 + (_I,) * 4 + (_P,), _I),
    },
    "dequant_score": {
        # Q_u s_u Q_w s_w | out | B n r | stream
        "dequant_score": ((_P,) * 5 + (_I,) * 3 + (_P,), _I),
        # the first kernel at any rank: the same arguments
        "dequant_score_first": ((_P,) * 5 + (_I,) * 3 + (_P,), _I),
        # the calling thread's last launch: BM << 16 | BN, -1 first
        "dequant_score_last_kernel": ((), _I),
    },
    "flash_attention": {
        # q k v | o | B Hq Hkv Lq Lk D Dv causal window | softcap | q_offset
        # dtype aligned | stream
        "flash_attention": ((_P,) * 4 + (_I,) * 9 + (_F,) + (_I,) * 3
                            + (_P,), _I),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return _OUT / f"{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` each, all started together.  Returns seconds per library
    built; raises with the compiler's output when one fails."""

    names = list(SIGNATURES) if names is None else list(names)
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds = {}
    try:
        for name, (t0, tmp, out, proc) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            if log.strip():
                print(f"[nvcc {name}]\n{log.rstrip()}")
            os.replace(tmp, out)             # atomic: never a half-written .so
    finally:                                 # a failed build stops the others
        for _, tmp, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
                tmp.unlink(missing_ok=True)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its C signatures declared."""

    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def on_card(*tensors) -> bool:
    """Kernel dispatch: True for CUDA tensors (launch the kernel), False
    for CPU tensors (run the plain version); anything else raises.  There
    is no fallback from the card to a plain version."""

    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(
            "kernel inputs must share one device, got "
            f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type == "cuda"


def expect(t, name: str, dtype, shape) -> None:
    """Raise unless ``t`` has the dtype and shape a kernel takes."""

    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")


def check(entry: str, rc: int) -> None:
    """Raise when a launch entry reported a CUDA error."""

    if rc != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {rc}")
