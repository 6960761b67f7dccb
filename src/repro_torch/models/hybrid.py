"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
(port of ``repro.models.hybrid``).

One transformer block (attention + SwiGLU MLP) is re-invoked before every
k Mamba2 layers.  As in the JAX package:

* the shared block's parameters are stored once (``params["shared"]``);
  invocations differ through per-invocation LoRA deltas on q/k/v;
* the shared block sees ``concat(hidden, embedding)`` projected back to
  d_model by a per-invocation ``w_cat`` (Zamba's concat re-injection);
* each invocation keeps its own KV cache.

The unit parameters are stacked with a leading (n_units,) axis and the
Mamba layers inside a unit with a second (k,) axis, the JAX layout, so a
JAX tree carries over leaf for leaf; ``lax.scan`` over those axes becomes
Python loops.  The embedding is not scaled and the logits are ``h @
lm_head`` with no softcap.  Zamba2 alternates two shared blocks; the JAX
model, and so the port, has one (ROADMAP.md §3).

The cache is ``{"ssm": SSMState (n_units, k, ...), "kv": KVCache
(n_units, ...)}``.  A prefill fills the KV caches in place (through the
flash kernel with ``Ctx(attn_impl="kernel")``, once per unit) and returns
the Mamba layers' own states; decode writes both in place.

Tensor parallelism (``ctx.tp``; the leaves the rules split are named in
``TP.split``): the vocab-parallel embedding and ``lm_head``; the Mamba
layers on the rank's heads (``models/ssm.py``); the shared attention and
SwiGLU MLP by head and by column with one all-reduce after each, each
invocation's KV cache holding the rank's heads.  The rules split
``w_cat`` on its output ``d_model``: the concat projection is
column-parallel, then all-gathered on its last dim, once an invocation.
They split ``lora_b`` on its width, which lines up with the rank's q/k/v
columns only where the query and KV head counts are equal
(``models/api.py::tp_refusal`` refuses the others), and the Mamba layers'
pre-norm weights (``mamba.norm``) on ``d_model``: a unit's are
all-gathered once, since every rank normalises the whole hidden state.

FSDP and a batch that does not split (``ctx.fsdp``, ``ctx.kv_seq``; a
rank of a ``pod x data x model`` grid, ``launch/lm_engine.py``): a step
gathers the shared block's leaves the rules split on ``"data"`` (its
attention and MLP) over the rank's FSDP group once, and keeps them for
the step's invocations; each unit's own leaves (``w_cat``, ``lora_a``
and its Mamba layers' projections) in one all-gather a unit, just before
the unit runs.  Where the batch does not split, every rank runs it whole,
its Mamba states are its heads' (whole over ``"data"``: each data rank
updates its own identical copy) and each invocation's KV cache holds the
rank's heads over its data group's slice of the positions, decoded by the
masked partial softmax (``models/attention.py``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.transformer import (Ctx, _dtype, _index,
                                           _kv_shard, _unit, _whole)

_LORA_RANK = 8


def _n_units(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.shared_attn_every


def _shared_block_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    def norm():
        return torch.zeros((cfg.d_model,), dtype=dtype, device=device)

    return {
        "norm1": norm(),
        "attn": A.init_attention(gen, cfg.d_model, cfg.num_heads,
                                 cfg.num_kv_heads, cfg.resolved_head_dim,
                                 False, dtype, device),
        "norm2": norm(),
        "mlp": L.init_mlp_swiglu(gen, cfg.d_model,
                                 cfg.d_ff or 4 * cfg.d_model, dtype, device),
    }


def _units_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Every unit's k Mamba layers and shared-block adapters, stacked."""

    n, k, d = _n_units(cfg), cfg.shared_attn_every, cfg.d_model
    width = max(cfg.num_heads, cfg.num_kv_heads) * cfg.resolved_head_dim
    return {
        "mamba": {
            "norm": torch.zeros((n, k, d), dtype=dtype, device=device),
            "ssm": SSM.init_ssm(gen, d, cfg.ssm, dtype, device, (n, k)),
        },
        "w_cat": L._normal(gen, (2 * d, d), (2 * d) ** -0.5, dtype, device,
                           (n,)),
        "lora_a": L._normal(gen, (3, d, _LORA_RANK), 0.01, dtype, device,
                            (n,)),
        # zero at init, as in Zamba2: the deltas start at 0
        "lora_b": torch.zeros((n, 3, _LORA_RANK, width), dtype=dtype,
                              device=device),
    }


def init_hybrid(gen, cfg: ModelConfig, ctx: Ctx, device) -> dict:
    dtype = _dtype(cfg)
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device),
        "shared": _shared_block_init(gen, cfg, dtype, device),
        "units": _units_init(gen, cfg, dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
        "lm_head": L._normal(gen, (cfg.d_model, cfg.vocab_size),
                             cfg.d_model ** -0.5, dtype, device),
    }


def _lora_attn_params(shared_attn, unit):
    """Shared attention weights + this invocation's LoRA deltas.  Each
    delta takes the first columns of ``lora_b``, as many as its weight has
    (on a rank, its heads' columns: H = Hkv there)."""

    p = dict(shared_attn)
    for i, name in enumerate(("wq", "wk", "wv")):
        width = p[name].shape[-1]
        p[name] = p[name] + unit["lora_a"][i] @ unit["lora_b"][i][:, :width]
    return p


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


def _shared_in(shared, unit, x, x0, cfg: ModelConfig, tp=None):
    """(the block's input h, the normed attention input, the invocation's
    attention weights).  A rank's ``w_cat`` columns give its slice of h,
    all-gathered into the whole."""

    h = L.all_gather(torch.cat([x, x0], dim=-1) @ unit["w_cat"],
                     L.sharded(tp, "units.w_cat"), -1)
    attn_p = _lora_attn_params(shared["attn"], unit)
    return h, L.rms_norm(h, shared["norm1"], cfg.norm_eps), attn_p


def _shared_out(shared, x, h, h1, cfg: ModelConfig, tp=None):
    """x + the block's output, after its attention output h1 (a rank's
    partial sum, all-reduced here, as the MLP's)."""

    h = h + L.all_reduce(h1, L.sharded(tp, "attn.wo"))
    h = h + L.all_reduce(
        L.mlp_swiglu(shared["mlp"], L.rms_norm(h, shared["norm2"],
                                               cfg.norm_eps)),
        L.sharded(tp, "mlp.wo"))
    return x + h


def _mamba_norms(unit, tp=None):
    """The unit's k Mamba pre-norm weights (k, d_model), whole: one
    all-gather where the rules split them."""

    return L.all_gather(unit["mamba"]["norm"], L.sharded(tp, "mamba.norm"),
                        -1)


def _mamba(lp, x, cfg: ModelConfig):
    return x + SSM.ssm_block(lp["ssm"], L.rms_norm(x, lp["norm"],
                                                   cfg.norm_eps),
                             cfg.ssm, cfg.d_model)


def _unit_train(shared, unit, x, x0, cfg: ModelConfig, ctx: Ctx):
    """The shared block, then the unit's k Mamba layers."""

    h, h_in, attn_p = _shared_in(shared, unit, x, x0, cfg)
    h1 = A.attention(attn_p, h_in, causal=True, impl=ctx.attn_impl,
                     **_attn_kw(cfg))
    x = _shared_out(shared, x, h, h1, cfg)
    for j in range(cfg.shared_attn_every):
        x = _mamba(_index(unit["mamba"], j), x, cfg)
    return x


def hybrid_loss(params, tokens, targets, cfg: ModelConfig, ctx: Ctx):
    """Mean next-token cross-entropy; with ``ctx.remat`` each unit keeps
    only its inputs for the backward, as ``jax.checkpoint`` wraps it."""

    x = L.embed(params["embed"], tokens)
    x0 = x
    for n in range(_n_units(cfg)):
        unit = _index(params["units"], n)
        if ctx.remat:
            x = checkpoint(_unit_train, params["shared"], unit, x, x0, cfg,
                           ctx, use_reentrant=False)
        else:
            x = _unit_train(params["shared"], unit, x, x0, cfg, ctx)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.cross_entropy(h @ params["lm_head"], targets)


def _kv_heads(cfg: ModelConfig, ctx: Ctx) -> int:
    """The shared block's KV heads of this rank."""

    tp = L.sharded(ctx.tp, "attn.wk")
    return cfg.num_kv_heads // (tp.size if tp else 1)


def _embed(params, tokens, tp=None):
    return L.embed(params["embed"], tokens, L.sharded(tp, "embed"))


def _logits(params, h, tp=None):
    """``h @ lm_head`` (no softcap), all-gathered where vocab-parallel."""

    return L.unembed(h, params["lm_head"], False, 0.0,
                     L.sharded(tp, "lm_head"))


def hybrid_init_cache(cfg: ModelConfig, ctx: Ctx, batch: int, max_len: int,
                      device) -> dict:
    n = _n_units(cfg)
    return {
        "ssm": SSM.init_ssm_state(batch, cfg.d_model, cfg.ssm,
                                  ctx.cache_dtype, device,
                                  (n, cfg.shared_attn_every), ctx.tp),
        "kv": A.init_cache(batch, _kv_heads(cfg, ctx),
                           A.seq_len_of_rank(max_len, _kv_shard(cfg, ctx)),
                           cfg.resolved_head_dim, ctx.cache_dtype, device,
                           (n,)),
    }


def hybrid_decode_step(params, cache, token, pos, cfg: ModelConfig,
                       ctx: Ctx):
    """token: (B,) int; pos: int.  Writes position ``pos`` of the KV caches
    and the SSM states in place; returns (logits (B, V), cache)."""

    tp, kv = ctx.tp, _kv_shard(cfg, ctx)
    shared = _whole(params, "shared", ctx)   # gathered once a step
    x = _embed(params, token[:, None], tp)
    x0 = x
    for n in range(_n_units(cfg)):
        unit = _unit(params, n, ctx)   # its FSDP leaves whole
        h, h_in, attn_p = _shared_in(shared, unit, x, x0, cfg, tp)
        h1, _ = A.decode_attention(attn_p, h_in, _index(cache["kv"], n), pos,
                                   kv=kv, **_attn_kw(cfg))
        x = _shared_out(shared, x, h, h1, cfg, tp)
        states = _index(cache["ssm"], n)
        norms = _mamba_norms(unit, tp)
        for j in range(cfg.shared_attn_every):
            lp = _index(unit["mamba"], j)
            h, _ = SSM.ssm_decode(
                lp["ssm"], L.rms_norm(x, norms[j], cfg.norm_eps),
                _index(states, j), cfg.ssm, cfg.d_model, tp)
            x = x + h
        del unit
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, h[:, 0], tp), cache


def hybrid_prefill(params, tokens, max_len, cfg: ModelConfig, ctx: Ctx):
    """tokens (B, L) -> (last-position logits (B, V), cache for decode)."""

    tp, kv_shard = ctx.tp, _kv_shard(cfg, ctx)
    shared = _whole(params, "shared", ctx)   # gathered once a step
    x = _embed(params, tokens, tp)
    x0 = x
    n_units = _n_units(cfg)
    kv = A.init_cache(tokens.shape[0], _kv_heads(cfg, ctx),
                      A.seq_len_of_rank(max_len, kv_shard),
                      cfg.resolved_head_dim, ctx.cache_dtype, x.device,
                      (n_units,))
    states = []
    for n in range(n_units):
        unit = _unit(params, n, ctx)   # its FSDP leaves whole
        h, h_in, attn_p = _shared_in(shared, unit, x, x0, cfg, tp)
        h1, _ = A.attention_prefill(
            attn_p, h_in, max_len, impl=ctx.attn_impl,
            cache_dtype=ctx.cache_dtype, cache=_index(kv, n), kv=kv_shard,
            **_attn_kw(cfg))
        del h_in
        x = _shared_out(shared, x, h, h1, cfg, tp)
        del h, h1
        unit_states = []
        norms = _mamba_norms(unit, tp)
        for j in range(cfg.shared_attn_every):
            lp = _index(unit["mamba"], j)
            hm, st = SSM.ssm_prefill(
                lp["ssm"], L.rms_norm(x, norms[j], cfg.norm_eps), cfg.ssm,
                cfg.d_model, tp)
            x = x + hm
            unit_states.append(st)
        states.append(SSM.stack_states(unit_states))
        del unit
    h = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(params, h, tp), {"ssm": SSM.stack_states(states),
                                    "kv": kv}
