"""Model API of the port (``repro.models.api``):
``build_model(cfg, ctx, device) -> Model`` for every family.

A ``Model`` packages init / loss / prefill / decode / init_cache behind
one signature, as in the JAX package.  Batches are dicts::

    LM:     {"tokens": (B, L) int, "targets": (B, L) int}
    VLM:    + {"patches": (B, P, 1024) float}
    encdec: {"frames": (B, T_frames, d) float} + tokens/targets

``"targets"`` only for ``loss``.  The dense, MoE and SSM families build
from ``models/transformer.py``, the hybrid (zamba2) from
``models/hybrid.py``, the encoder-decoder (whisper) from
``models/encdec.py`` and the VLM (internvl2) from ``models/vlm.py``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.state import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V

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


_LM = (T.init_lm, T.lm_loss, T.lm_prefill, T.lm_decode_step,
       T.lm_init_cache, ())
# family -> (init, loss, prefill, decode, init_cache, the batch's float
# inputs before the tokens)
_FAMILIES = {
    "dense": _LM, "moe": _LM, "ssm": _LM,
    "hybrid": (HY.init_hybrid, HY.hybrid_loss, HY.hybrid_prefill,
               HY.hybrid_decode_step, HY.hybrid_init_cache, ()),
    "encdec": (ED.init_encdec, ED.encdec_loss, ED.encdec_prefill,
               ED.encdec_decode_step, ED.encdec_init_cache, ("frames",)),
    "vlm": (V.init_vlm, V.vlm_loss, V.vlm_prefill, V.vlm_decode_step,
            T.lm_init_cache, ("patches",)),
}


def build_model(cfg: ModelConfig, ctx: T.Ctx | None = None,
                device="cuda") -> Model:
    """The model of ``cfg.family`` on ``device`` (the card unless
    ``device="cpu"``).

    ``init`` takes a ``torch.Generator`` on that device; its draws cannot
    match JAX's threefry, only the distributions do.  The batch's tensors
    given to ``loss``/``prefill``/``decode`` are moved to the device:
    tokens and targets as ``long``, frames and patches in their own float
    dtype.
    """

    fam = cfg.family
    if fam not in _FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    init, loss, prefill, decode, init_cache, extra = _FAMILIES[fam]
    ctx = ctx or T.Ctx()
    device = resolve_device(device)

    def tokens(x):
        return torch.as_tensor(x, device=device).long()

    def floats(x):
        return torch.as_tensor(x, device=device)

    def inputs(b):
        return [floats(b[name]) for name in extra] + [tokens(b["tokens"])]

    return Model(
        cfg, ctx, device,
        init=lambda gen: init(gen, cfg, ctx, device),
        loss=lambda p, b: loss(p, *inputs(b), tokens(b["targets"]), cfg,
                               ctx),
        prefill=lambda p, b, ml: prefill(p, *inputs(b), ml, cfg, ctx),
        decode=lambda p, c, tok, pos: decode(p, c, tokens(tok), int(pos),
                                             cfg, ctx),
        init_cache=lambda bs, ml: init_cache(cfg, ctx, bs, ml, device),
    )
