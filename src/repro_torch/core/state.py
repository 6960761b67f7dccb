"""Gossip-MC problem + state containers (NamedTuples of tensors).

Port of ``repro.core.state``.  Every tensor lives on the problem's device;
``State.t`` stays an int32 scalar tensor like the reference's, so the step
size γ_t is computed in float32 from it exactly as there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import grid as G


class Problem(NamedTuple):
    """Blockified matrix-completion problem (static data)."""

    xb: torch.Tensor     # (p, q, mb, nb) float32
    maskb: torch.Tensor  # (p, q, mb, nb) float32


class State(NamedTuple):
    """Learnable state of the gossip grid."""

    U: torch.Tensor      # (p, q, mb, r) float32
    W: torch.Tensor      # (p, q, nb, r) float32
    t: torch.Tensor      # scalar int32 — structure-update count (paper's t)


class Tables(NamedTuple):
    """Per-structure lookup tables, on the problem's device.

    blocks:  (S, 3, 2) int32 — (pivot, vert, horiz) block coords
    cf:      (S, 3) f32      — f normalization coefficients of the 3 blocks
    cu:      (S, 2) f32      — U-pair coef for (pivot, horiz) sides
    cw:      (S, 2) f32      — W-pair coef for (pivot, vert) sides
    """

    blocks: torch.Tensor
    cf: torch.Tensor
    cu: torch.Tensor
    cw: torch.Tensor


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; CUDA must really be there.

    Entry points default to ``device="cuda"``.  Without a card that default
    raises instead of carrying on silently on the CPU."""

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device=\"cpu\" to "
            "run the port's plain PyTorch path on the CPU"
        )
    return device


def build_tables(p: int, q: int, structures: np.ndarray, device) -> Tables:
    coefs = G.normalization_coefficients(p, q)
    blocks = np.zeros((len(structures), 3, 2), np.int32)
    cf = np.zeros((len(structures), 3), np.float32)
    cu = np.zeros((len(structures), 2), np.float32)
    cw = np.zeros((len(structures), 2), np.float32)
    for s, (kind, i, j) in enumerate(structures):
        trio = G.structure_blocks(int(kind), int(i), int(j))
        blocks[s] = trio
        for b3, (bi, bj) in enumerate(trio):
            cf[s, b3] = coefs["f"][bi, bj]
        pivot, vert, horiz = trio
        # U-pair is the horizontal pair between pivot and horiz
        pj = min(pivot[1], horiz[1])
        cu[s, :] = coefs["dU"][pivot[0], pj]
        # W-pair is the vertical pair between pivot and vert
        pi = min(pivot[0], vert[0])
        cw[s, :] = coefs["dW"][pi, vert[1]]
    return Tables(*(torch.from_numpy(a).to(device)
                    for a in (blocks, cf, cu, cw)))


def init_state(generator: torch.Generator, spec: G.GridSpec,
               scale: float = 1.0) -> State:
    """Random init (paper: 'initialized randomly') on the generator's device.

    Entries ~ N(0, scale²/r) so that (U Wᵀ) entries start O(scale²).  Torch
    and JAX draw different numbers from one seed; parity tests inject the
    reference's state through ``repro_torch.convert`` instead."""

    device = generator.device
    sd = float(scale / np.sqrt(spec.r))
    U = sd * torch.randn((spec.p, spec.q, spec.mb, spec.r),
                         generator=generator, device=device)
    W = sd * torch.randn((spec.p, spec.q, spec.nb, spec.r),
                         generator=generator, device=device)
    return State(U, W, torch.zeros((), dtype=torch.int32, device=device))


def make_problem(x: np.ndarray, mask: np.ndarray, spec: G.GridSpec,
                 device) -> Problem:
    xb, mb = G.blockify(x * mask, mask, spec)
    return Problem(torch.from_numpy(xb.astype(np.float32)).to(device),
                   torch.from_numpy(mb.astype(np.float32)).to(device))
