"""Device-dispatching wrapper of the dense f-gradient kernel.

``masked_factor_grad(x, mask, u, w)`` takes blocks with any leading batch
axes — X, mask (..., M, N), U (..., M, r), W (..., N, r) — and returns
``(loss, gU, gW)`` with the same leading axes.  A CUDA tensor launches the
hand-written kernel in ``kernels/csrc/masked_factor_grad.cu`` once over the
whole stack; a CPU tensor runs the plain version.  There is no size
threshold and no fallback from the card.  Launches are counted in
``masked_factor_grad.launches``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_factor_grad.ref import masked_factor_grad_ref

MAX_RANK = 256


def masked_factor_grad(x, mask, u, w):
    """(loss, gU, gW): loss = ‖mask⊙(X−UWᵀ)‖², gU = −2RW, gW = −2RᵀU."""

    if not _build.on_card(x, mask, u, w):
        return masked_factor_grad_ref(x, mask, u, w)
    lead = tuple(u.shape[:-2])
    M, r = u.shape[-2:]
    N = w.shape[-2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank r={r} outside the kernel's range "
                         f"[1, {MAX_RANK}]")
    _build.expect(x, "X", torch.float32, (*lead, M, N))
    _build.expect(mask, "mask", torch.float32, (*lead, M, N))
    _build.expect(u, "U", torch.float32, (*lead, M, r))
    _build.expect(w, "W", torch.float32, (*lead, N, r))
    B = math.prod(lead)
    ins = [t.contiguous() for t in (x, mask, u, w)]
    loss = torch.empty(lead, dtype=torch.float32, device=u.device)
    gu = torch.empty_like(ins[2])
    gw = torch.empty_like(ins[3])
    lib = _build.load("masked_factor_grad")
    partials = torch.empty((B, lib.mfg_num_partials(M)),
                           dtype=torch.float32, device=u.device)
    rc = lib.masked_factor_grad(
        *(t.data_ptr() for t in (*ins, loss, gu, gw, partials)),
        B, M, N, r, torch.cuda.current_stream(u.device).cuda_stream)
    _build.check("masked_factor_grad", rc)
    masked_factor_grad.launches += 1
    return loss, gu, gw


masked_factor_grad.launches = 0
