"""InternVL2-style VLM: the dense LM backbone over image patches and
tokens (port of ``repro.models.vlm``).

The vision tower (InternViT) is a stub, as in the JAX package: callers
hand in patch embeddings (B, P, 1024).  A two-layer MLP projector
(InternVL's glue, the tanh GELU between its layers) maps them to d_model,
and they go before the token embeddings: the sequence is [patch tokens]
[text tokens], causal over the whole of it, its positions absolute in
that fused sequence.  The loss covers the text positions only.  Under
tensor parallelism the projector's ``w1`` is replicated and its ``w2``
row-parallel: each rank multiplies its slice of the GELU's output by its
rows of ``w2``, and the ranks all-reduce before the first layer; under
FSDP a rank gathers both leaves whole over its FSDP group first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_VISION_DIM = 1024   # the stub InternViT's output width


def init_vlm(gen, cfg: ModelConfig, ctx: T.Ctx, device) -> dict:
    params = T.init_lm(gen, cfg, ctx, device)
    dtype = T._dtype(cfg)
    params["projector"] = {
        "w1": L._normal(gen, (_VISION_DIM, cfg.d_model), _VISION_DIM ** -0.5,
                        dtype, device),
        "w2": L._normal(gen, (cfg.d_model, cfg.d_model),
                        cfg.d_model ** -0.5, dtype, device),
    }
    return params


def _fuse(params, patches, tokens, cfg: ModelConfig, tp=None, fsdp=None):
    """(B, P + L, d): the projected patches, then the token embeddings.
    Under ``fsdp`` the projector's leaves are gathered whole first."""

    proj = L.fsdp_gather(params["projector"], fsdp, "projector")
    pe = F.gelu(patches @ proj["w1"], approximate="tanh")
    w2, w2_tp = proj["w2"], L.sharded(tp, "projector.w2")
    if w2_tp is not None:              # row-parallel: this rank's rows
        n = w2.shape[0]
        pe = pe[..., w2_tp.rank * n:(w2_tp.rank + 1) * n]
    pe = L.all_reduce(pe @ w2, w2_tp)
    te = T.embed_tokens(params, tokens, cfg, tp)
    return torch.cat([pe.to(te.dtype), te], dim=1)


def vlm_loss(params, patches, tokens, targets, cfg: ModelConfig,
             ctx: T.Ctx):
    """patches: (B, P, 1024); tokens/targets: (B, L).  Loss on the text
    positions only, plus the backbone's aux."""

    x = _fuse(params, patches, tokens, cfg)
    h, aux = T.lm_hidden_train(params, x, cfg, ctx)
    logits = T._unembed(params, h[:, patches.shape[1]:], cfg)
    return L.cross_entropy(logits, targets) + aux


def vlm_prefill(params, patches, tokens, max_len, cfg: ModelConfig,
                ctx: T.Ctx):
    """(last-position logits (B, V), ``lm_init_cache``-shaped cache over
    [patches][prompt]); ``max_len`` must hold P + L."""

    return T.prefill_embedded(
        params, _fuse(params, patches, tokens, cfg, ctx.tp, ctx.fsdp),
        max_len, cfg, ctx)


def vlm_decode_step(params, cache, token, pos, cfg: ModelConfig,
                    ctx: T.Ctx):
    """``pos`` is absolute: the patch count plus the text position."""

    return T.lm_decode_step(params, cache, token, pos, cfg, ctx)
