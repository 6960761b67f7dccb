"""Model API of the port (``repro.models.api`` for the dense, MoE, SSM
and hybrid families): ``build_model(cfg, ctx, device) -> Model``.

A ``Model`` packages init / loss / prefill / decode / init_cache behind
one signature, as in the JAX package; batches are dicts ``{"tokens": (B,
L) int}``, with ``"targets"`` (B, L) for ``loss``.  The dense, MoE and
SSM families build from ``models/transformer.py``, the hybrid (zamba2)
from ``models/hybrid.py``.  The enc-dec and VLM families are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.state import resolve_device
from repro_torch.models import hybrid as HY
from repro_torch.models import transformer as T

Ctx = T.Ctx


class Model(NamedTuple):
    cfg: ModelConfig
    ctx: T.Ctx
    device: torch.device
    init: Callable[..., Any]          # (generator) -> params
    loss: Callable[..., Any]          # (params, batch) -> scalar
    prefill: Callable[..., Any]       # (params, batch, max_len) -> (logits, cache)
    decode: Callable[..., Any]        # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable[..., Any]    # (batch, max_len) -> cache


def build_model(cfg: ModelConfig, ctx: T.Ctx | None = None,
                device="cuda") -> Model:
    """The dense, MoE, SSM or hybrid LM on ``device`` (the card unless
    ``device="cpu"``).

    ``init`` takes a ``torch.Generator`` on that device; its draws cannot
    match JAX's threefry, only the distributions do.  Tokens and targets
    given to ``loss``/``prefill``/``decode`` are moved to the device.
    """

    ctx = ctx or T.Ctx()
    device = resolve_device(device)
    if cfg.family == "hybrid":
        init, loss, prefill, decode, init_cache = (
            HY.init_hybrid, HY.hybrid_loss, HY.hybrid_prefill,
            HY.hybrid_decode_step, HY.hybrid_init_cache)
    elif cfg.family in T.PORTED_FAMILIES:
        init, loss, prefill, decode, init_cache = (
            T.init_lm, T.lm_loss, T.lm_prefill, T.lm_decode_step,
            T.lm_init_cache)
    else:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            "yet (ROADMAP.md queue 1, item 6)")

    def tokens(x):
        return torch.as_tensor(x, device=device).long()

    return Model(
        cfg, ctx, device,
        init=lambda gen: init(gen, cfg, ctx, device),
        loss=lambda p, b: loss(p, tokens(b["tokens"]), tokens(b["targets"]),
                               cfg, ctx),
        prefill=lambda p, b, ml: prefill(p, tokens(b["tokens"]), ml, cfg,
                                         ctx),
        decode=lambda p, c, tok, pos: decode(p, c, tokens(tok), int(pos),
                                             cfg, ctx),
        init_cache=lambda bs, ml: init_cache(cfg, ctx, bs, ml, device),
    )
