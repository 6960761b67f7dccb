"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The audio conv front end is a stub, as in the JAX package: callers hand
in frame embeddings (B, T_frames, d_model), what whisper's two conv
layers would produce.  After that the structure is whisper's: sinusoidal
encoder positions, learned decoder positions, pre-LayerNorm blocks, tanh
GELU MLPs, bidirectional encoder self-attention, causal decoder
self-attention and cross-attention, the unembedding tied to the token
embedding.

The layer parameters are stacked with a leading (layers,) axis under
``enc_layers`` and ``dec_layers``, the JAX layout, so a JAX tree carries
over leaf for leaf; ``lax.scan`` over that axis becomes a Python loop.
Training and prefill attend through the flash kernel
(``Ctx(attn_impl="kernel")``) or the plain reference; ``Ctx(remat=True)``
recomputes each encoder and decoder layer in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the scanned
body).

The decode cache is a ``DecCache`` per decoder layer, stacked: the
self-attention ``KVCache``, written in place at each decode position,
and the cross-attention K/V, computed once from the encoder output at
prefill.  Decode is plain tensor code with the reference's rounding: the
scaled query is cast to the cache dtype before both products (the LM's
decode keeps it in float32), the logits and P.V accumulate in float32.

Tensor parallelism (``ctx.tp``): the encoder's self-attention, the
decoder's self- and cross-attention and both MLPs run on the rank's heads
and hidden columns (``bq``/``bk``/``bv``/``bi`` split with them), one
all-reduce after each row-parallel product, the whole ``bo`` added once
after it; the LayerNorms and ``dec_pos`` are whole.  Every rank holds
the whole encoder output and projects the cross K/V of its heads from
it; the ``DecCache`` holds its heads.  ``tok_embed`` is vocab-parallel
where its rows split over the ranks (51,866 = 2 x 25,933: at 2 ranks,
not at 4, where the rules keep it whole), and the tied logits follow it:
all-gathered where it is split, computed whole where it is not.  Head
counts are read from the weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import Ctx, _dtype, _index

# learned decoder positions, sized as the JAX package sizes them for its
# 32k decode cells (the real model stops at 448)
_MAX_POS = 49152


class DecCache(NamedTuple):
    self_kv: A.KVCache
    cross_k: torch.Tensor   # (..., B, H, T_frames, hd)
    cross_v: torch.Tensor


def _sinusoid(length: int, d: int, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _init_ln(d, dtype, device, lead=()):
    lead = tuple(lead)
    return {"w": torch.ones(lead + (d,), dtype=dtype, device=device),
            "b": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def _init_attn(gen, d, h, dtype, device, lead):
    # q, k and v all with biases, as the reference has them
    return A.init_attention(gen, d, h, h, d // h, True, dtype, device, lead)


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device, lead):
    return {
        "ln1": _init_ln(cfg.d_model, dtype, device, lead),
        "attn": _init_attn(gen, cfg.d_model, cfg.num_heads, dtype, device,
                           lead),
        "ln2": _init_ln(cfg.d_model, dtype, device, lead),
        "mlp": L.init_mlp_gelu(gen, cfg.d_model, cfg.d_ff, dtype, device,
                               lead),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dtype, device, lead):
    return {
        "ln1": _init_ln(cfg.d_model, dtype, device, lead),
        "self_attn": _init_attn(gen, cfg.d_model, cfg.num_heads, dtype,
                                device, lead),
        "ln_x": _init_ln(cfg.d_model, dtype, device, lead),
        "cross_attn": _init_attn(gen, cfg.d_model, cfg.num_heads, dtype,
                                 device, lead),
        "ln2": _init_ln(cfg.d_model, dtype, device, lead),
        "mlp": L.init_mlp_gelu(gen, cfg.d_model, cfg.d_ff, dtype, device,
                               lead),
    }


def init_encdec(gen, cfg: ModelConfig, ctx: Ctx, device) -> dict:
    dtype = _dtype(cfg)
    return {
        "enc_layers": _init_enc_layer(gen, cfg, dtype, device,
                                      (cfg.encoder_layers,)),
        "enc_ln": _init_ln(cfg.d_model, dtype, device),
        "dec_layers": _init_dec_layer(gen, cfg, dtype, device,
                                      (cfg.num_layers,)),
        "dec_ln": _init_ln(cfg.d_model, dtype, device),
        "tok_embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      dtype, device),
        "dec_pos": L._normal(gen, (_MAX_POS, cfg.d_model), 0.01, dtype,
                             device),
    }


def _embed(params, tokens, tp=None):
    # the JAX package's one-hot lookup (ctx.embed_impl) computes the same
    # rows; a vocab-parallel table is looked up by L.embed's masked sum
    return L.embed(params["tok_embed"], tokens, L.sharded(tp, "tok_embed"))


def _ln(x, p):
    return L.layer_norm(x, p["w"], p["b"])


def _heads(t, heads):
    """(B, L, heads * hd) -> contiguous (B, heads, L, hd)."""

    B, n, d = t.shape
    return t.reshape(B, n, heads, d // heads).transpose(1, 2).contiguous()


def _merge(o):
    B, H, n, hd = o.shape
    return o.transpose(1, 2).reshape(B, n, H * hd)


def _head_dim(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.num_heads


def _n_heads(w, cfg: ModelConfig) -> int:
    """The heads a projection's weight holds (a rank's, under tp)."""

    return w.shape[-1] // _head_dim(cfg)


def _mha(params, x, kv_x, cfg: ModelConfig, *, causal, impl, tp=None):
    """LayerNorm-external multi-head attention (no rope) on the heads the
    weights hold; ``tp`` all-reduces the row-parallel ``wo`` product."""

    heads = _n_heads(params["wq"], cfg)
    q = _heads(L.linear(x, params["wq"], params.get("bq")), heads)
    k = _heads(L.linear(kv_x, params["wk"], params.get("bk")), heads)
    v = _heads(L.linear(kv_x, params["wv"], params.get("bv")), heads)
    o = A._attend(q, k, v, impl, causal=causal)
    return L.all_reduce(L.linear(_merge(o), params["wo"]), tp)


def _mlp(lp, x, ctx: Ctx):
    return L.mlp_gelu(lp["mlp"], _ln(x, lp["ln2"]),
                      L.sharded(ctx.tp, "mlp.wo"))


def _enc_layer(lp, x, cfg: ModelConfig, ctx: Ctx):
    h = _ln(x, lp["ln1"])
    x = x + _mha(lp["attn"], h, h, cfg, causal=False, impl=ctx.attn_impl,
                 tp=L.sharded(ctx.tp, "attn.wo"))
    return x + _mlp(lp, x, ctx)


def encode(params, frames, cfg: ModelConfig, ctx: Ctx):
    """frames: (B, T, d) stub embeddings -> encoder memory (B, T, d)."""

    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    for n in range(cfg.encoder_layers):
        lp = _index(params["enc_layers"], n)
        if ctx.remat:
            x = checkpoint(_enc_layer, lp, x, cfg, ctx, use_reentrant=False)
        else:
            x = _enc_layer(lp, x, cfg, ctx)
    return _ln(x, params["enc_ln"])


def _dec_layer_train(lp, x, memory, cfg: ModelConfig, ctx: Ctx):
    h = _ln(x, lp["ln1"])
    x = x + _mha(lp["self_attn"], h, h, cfg, causal=True,
                 impl=ctx.attn_impl)
    x = x + _mha(lp["cross_attn"], _ln(x, lp["ln_x"]), memory, cfg,
                 causal=False, impl=ctx.attn_impl)
    return x + _mlp(lp, x, ctx)


def _decoder_in(params, tokens, start: int, tp=None):
    x = _embed(params, tokens, tp)
    return x + params["dec_pos"][start:start + tokens.shape[1]].to(x.dtype)


def _unembed(params, x, tp=None):
    # whisper ties embeddings; the logits all-gathered where vocab-parallel
    return L.unembed(x, params["tok_embed"], True, 0.0,
                     L.sharded(tp, "tok_embed"))


def encdec_loss(params, frames, tokens, targets, cfg: ModelConfig,
                ctx: Ctx):
    """Mean next-token cross-entropy of the decoder on ``tokens`` (B, L)
    against ``targets`` (B, L; -1 is padding), given ``frames``."""

    memory = encode(params, frames, cfg, ctx)
    x = _decoder_in(params, tokens, 0)
    for n in range(cfg.num_layers):
        lp = _index(params["dec_layers"], n)
        if ctx.remat:
            x = checkpoint(_dec_layer_train, lp, x, memory, cfg, ctx,
                           use_reentrant=False)
        else:
            x = _dec_layer_train(lp, x, memory, cfg, ctx)
    x = _ln(x, params["dec_ln"])
    return L.cross_entropy(_unembed(params, x), targets)


def _cache_heads(cfg: ModelConfig, ctx: Ctx, attn: str) -> int:
    """``attn``'s heads (``"self_attn"``, ``"cross_attn"``) of this rank."""

    tp = L.sharded(ctx.tp, f"{attn}.wk")
    return cfg.num_heads // (tp.size if tp else 1)


def _new_cache(cfg: ModelConfig, ctx: Ctx, batch: int, max_len: int,
               frames: int, device) -> DecCache:
    hd = _head_dim(cfg)
    lead = (cfg.num_layers,)
    shape = lead + (batch, _cache_heads(cfg, ctx, "cross_attn"), frames, hd)
    return DecCache(
        A.init_cache(batch, _cache_heads(cfg, ctx, "self_attn"), max_len, hd,
                     ctx.cache_dtype, device, lead),
        torch.zeros(shape, dtype=ctx.cache_dtype, device=device),
        torch.zeros(shape, dtype=ctx.cache_dtype, device=device))


def encdec_init_cache(cfg: ModelConfig, ctx: Ctx, batch: int, max_len: int,
                      device) -> DecCache:
    return _new_cache(cfg, ctx, batch, max_len, cfg.encoder_seq_len, device)


def _layer_cache(cache: DecCache, n: int) -> DecCache:
    return DecCache(A.KVCache(cache.self_kv.k[n], cache.self_kv.v[n]),
                    cache.cross_k[n], cache.cross_v[n])


def encdec_prefill(params, frames, tokens, max_len, cfg: ModelConfig,
                   ctx: Ctx):
    """Encode, then the causal decoder over ``tokens`` (B, L); returns
    (last-position logits (B, V), DecCache).  The cache's self (k, v) is
    allocated at ``max_len`` and filled in place; each layer's cross K/V
    are projected once, attended to in float32 and stored in the cache
    dtype (the reference projects them twice, with the same values)."""

    memory = encode(params, frames, cfg, ctx)
    B, Lx = tokens.shape
    tp_self = L.sharded(ctx.tp, "self_attn.wo")
    tp_cross = L.sharded(ctx.tp, "cross_attn.wo")
    cache = _new_cache(cfg, ctx, B, max_len, memory.shape[1], memory.device)
    x = _decoder_in(params, tokens, 0, ctx.tp)
    for n in range(cfg.num_layers):
        lp = _index(params["dec_layers"], n)
        sa, ca = lp["self_attn"], lp["cross_attn"]
        h_in = _ln(x, lp["ln1"])
        q, k, v = A._project_qkv(sa, h_in, _head_dim(cfg))
        del h_in
        o = A._attend(q, k, v, ctx.attn_impl, causal=True)
        x = x + L.all_reduce(L.linear(_merge(o), sa["wo"]), tp_self)
        cache.self_kv.k[n, :, :, :Lx] = k
        cache.self_kv.v[n, :, :, :Lx] = v
        del q, k, v, o
        H = _n_heads(ca["wq"], cfg)
        ck = _heads(L.linear(memory, ca["wk"], ca.get("bk")), H)
        cv = _heads(L.linear(memory, ca["wv"], ca.get("bv")), H)
        q = _heads(L.linear(_ln(x, lp["ln_x"]), ca["wq"], ca.get("bq")), H)
        o = A._attend(q, ck, cv, ctx.attn_impl, causal=False)
        x = x + L.all_reduce(L.linear(_merge(o), ca["wo"]), tp_cross)
        cache.cross_k[n] = ck
        cache.cross_v[n] = cv
        del q, ck, cv, o
        x = x + _mlp(lp, x, ctx)
    h = _ln(x[:, -1], params["dec_ln"])
    return _unembed(params, h, ctx.tp), cache


def _cached_attention(q, k, v, mask=None):
    """One query position against a cache (B, H, T, hd) in its dtype: q
    (B, H, 1, hd), already scaled and cast to the cache dtype; logits and
    P.V in float32 (float64 in a float64 evaluation), p rounded to the
    cache dtype, as the reference's ``preferred_element_type`` products
    do."""

    logits = L.upcast(q) @ L.upcast(k).transpose(-1, -2)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return L.upcast(p.to(v.dtype)) @ L.upcast(v)


def encdec_decode_step(params, cache: DecCache, token, pos,
                       cfg: ModelConfig, ctx: Ctx):
    """token: (B,) int; pos: int.  Writes position ``pos`` of the self
    caches in place; returns (logits (B, V), cache)."""

    hd = _head_dim(cfg)
    tp_self = L.sharded(ctx.tp, "self_attn.wo")
    tp_cross = L.sharded(ctx.tp, "cross_attn.wo")
    x = _decoder_in(params, token[:, None], pos, ctx.tp)
    scale = math.sqrt(hd)
    kpos = torch.arange(cache.self_kv.k.shape[3], device=x.device)
    mask = kpos <= pos
    for n in range(cfg.num_layers):
        lp = _index(params["dec_layers"], n)
        c = _layer_cache(cache, n)
        sa, ca = lp["self_attn"], lp["cross_attn"]
        ck, cv = c.self_kv
        q, k, v = A._project_qkv(sa, _ln(x, lp["ln1"]), hd)
        ck[:, :, pos:pos + 1] = k
        cv[:, :, pos:pos + 1] = v
        q = (q / q.new_tensor(scale)).to(ck.dtype)
        o = _cached_attention(q, ck, cv, mask).to(x.dtype)
        x = x + L.all_reduce(L.linear(_merge(o), sa["wo"]), tp_self)
        # cross attention against the prefill's encoder K/V
        q = _heads(L.linear(_ln(x, lp["ln_x"]), ca["wq"], ca.get("bq")),
                   _n_heads(ca["wq"], cfg))
        q = (q / q.new_tensor(scale)).to(c.cross_k.dtype)
        o = _cached_attention(q, c.cross_k, c.cross_v).to(x.dtype)
        x = x + L.all_reduce(L.linear(_merge(o), ca["wo"]), tp_cross)
        x = x + _mlp(lp, x, ctx)
    h = _ln(x[:, 0], params["dec_ln"])
    return _unembed(params, h, ctx.tp), cache
