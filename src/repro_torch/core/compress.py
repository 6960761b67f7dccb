"""Gossip-message compression.

Port of ``repro.core.compress``.  Halo messages (block-edge factor
matrices) are what travels between ranks every round.  Two compressors,
both with deterministic decompression:

* ``int8``  — symmetric per-tensor quantization (4× smaller messages)
* ``topk``  — magnitude top-k sparsification with **error feedback**
              (the residual is fed back into the next round's message,
              which keeps consensus unbiased; Stich et al. 2018 style)

Compression is applied to the *message*, never the state.  The wire
carries the decompressed-at-sender values; ``message_bytes`` charges the
compressed byte count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.state import resolve_device


class CompressState(NamedTuple):
    """Error-feedback memory, the same shape as the message."""

    residual: torch.Tensor


def init_state(msg_shape, dtype=torch.float32, device="cuda") -> CompressState:
    """Zero error-feedback memory on ``device`` (the card unless
    ``device="cpu"``)."""

    return CompressState(torch.zeros(msg_shape, dtype=dtype,
                                     device=resolve_device(device)))


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Keep the top ``fraction`` entries by magnitude (per tensor)."""

    k = max(1, int(fraction * x.numel()))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


def compress_message(
    x: torch.Tensor, method: str, state: CompressState | None = None,
    topk_fraction: float = 0.25,
) -> tuple[torch.Tensor, CompressState | None]:
    """The (decompressed-at-sender) message actually transmitted and the
    updated error-feedback state.  The wire format is modelled by
    round-tripping through the compressor; ``message_bytes`` charges the
    compressed byte count."""

    if method == "none":
        return x, state
    if state is not None:
        x = x + state.residual
    if method == "int8":
        q, s = int8_compress(x)
        sent = int8_decompress(q, s)
    elif method == "topk":
        sent = topk_mask(x, topk_fraction)
    else:
        raise ValueError(f"unknown compression {method!r}")
    new_state = CompressState(x - sent) if state is not None else None
    return sent, new_state


def message_bytes_n(n: int, method: str, topk_fraction: float = 0.25) -> int:
    """Wire bytes for an n-element message."""

    if method == "none":
        return n * 4
    if method == "int8":
        return n + 4
    if method == "topk":
        k = max(1, int(topk_fraction * n))
        return k * 8  # value + index
    raise ValueError(method)


def message_bytes(x: torch.Tensor, method: str,
                  topk_fraction: float = 0.25) -> int:
    return message_bytes_n(x.numel(), method, topk_fraction)
