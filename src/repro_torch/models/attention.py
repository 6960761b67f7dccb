"""GQA attention of the dense LM (port of ``repro.models.attention``): the
training and prefill paths (flash kernel or plain reference) and the
cached decode path.  Training runs the plain reference under autograd: the
flash kernel, like the JAX one, has no backward.

The decode path keeps a static-shape KV cache (B, Hkv, Lmax, D) and masks
positions > pos; as in the JAX package it is plain tensor code (a
memory-bound gather), not a kernel.  Unlike JAX's functional
``dynamic_update_slice``, the port writes the new position into the cache
in place and returns the same tensors, so a decode step allocates no
second cache.

Head counts are read from the weights: ``wq``'s width over ``head_dim``
query heads and ``wk``'s over ``head_dim`` KV heads.  Under tensor
parallelism a rank holds whole heads of each (``train/sharding.py``), so
the same code runs its local heads, the GQA group unchanged, and returns
its partial sum of the row-parallel ``wo`` product, which the caller
all-reduces.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.models import layers as L

ATTN_IMPLS = ("kernel", "ref")


class KVCache(NamedTuple):
    k: torch.Tensor    # (..., B, Hkv, Lmax, D)
    v: torch.Tensor


def _attend(q, k, v, impl, *, causal, window=0, softcap=0.0, q_offset=0):
    """Dispatch: the flash kernel (its plain version on CPU tensors) or the
    plain reference.  The JAX package's ``"flashref"`` (its XLA flash scan,
    for HLO cost probes and backends without Mosaic) has no twin here."""

    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    raise ValueError(f"attn impl {impl!r} is not ported; expected one of "
                     f"{ATTN_IMPLS}")


def init_attention(gen, d_model, num_heads, num_kv_heads, head_dim,
                   qkv_bias, dtype, device, lead=()) -> dict:
    s = d_model ** -0.5
    hq, hkv = num_heads * head_dim, num_kv_heads * head_dim
    p = {
        "wq": L._normal(gen, (d_model, hq), s, dtype, device, lead),
        "wk": L._normal(gen, (d_model, hkv), s, dtype, device, lead),
        "wv": L._normal(gen, (d_model, hkv), s, dtype, device, lead),
        "wo": L._normal(gen, (hq, d_model), hq ** -0.5, dtype, device, lead),
    }
    if qkv_bias:
        lead = tuple(lead)
        p["bq"] = torch.zeros(lead + (hq,), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (hkv,), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (hkv,), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, head_dim):
    """(B, H, Lx, D) q, k, v, each contiguous (the kernel's layout), at
    the head counts of the weights ``params`` holds."""

    B, Lx, _ = x.shape
    num_heads = params["wq"].shape[-1] // head_dim
    num_kv_heads = params["wk"].shape[-1] // head_dim
    q = L.linear(x, params["wq"], params.get("bq"))
    k = L.linear(x, params["wk"], params.get("bk"))
    v = L.linear(x, params["wv"], params.get("bv"))
    q = q.reshape(B, Lx, num_heads, head_dim).transpose(1, 2).contiguous()
    k = k.reshape(B, Lx, num_kv_heads, head_dim).transpose(1, 2).contiguous()
    v = v.reshape(B, Lx, num_kv_heads, head_dim).transpose(1, 2).contiguous()
    return q, k, v


def _self_attention(params, x, *, head_dim, causal, window, attn_softcap,
                    rope_theta, impl):
    """(output (B, L, d), roped k, v) of self-attention over x (B, L, d)
    at positions 0..L-1."""

    B, Lx, _ = x.shape
    q, k, v = _project_qkv(params, x, head_dim)
    positions = torch.arange(Lx, device=x.device)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    o = _attend(q, k, v, impl, causal=causal, window=window,
                softcap=attn_softcap)
    o = o.transpose(1, 2).reshape(B, Lx, q.shape[1] * head_dim)
    return L.linear(o, params["wo"]), k, v


def attention(params, x, *, head_dim, causal=True, window=0,
              attn_softcap=0.0, rope_theta=10000.0, impl="ref"):
    """Training self-attention.  x: (B, L, d)."""

    out, _, _ = _self_attention(
        params, x, head_dim=head_dim, causal=causal, window=window,
        attn_softcap=attn_softcap, rope_theta=rope_theta, impl=impl)
    return out


def attention_prefill(params, x, max_len, *, head_dim, window=0,
                      attn_softcap=0.0,
                      rope_theta=10000.0, impl="ref",
                      cache_dtype=torch.bfloat16, cache=None):
    """Causal forward over L prompt tokens + the KV cache (padded to
    ``max_len``) needed to continue decoding at position L.  ``cache``, if
    given, is a ``KVCache`` of (B, Hkv, max_len, D) tensors to fill in
    place (the model's stacked cache); otherwise a new one is made."""

    B, Lx, _ = x.shape
    out, k, v = _self_attention(
        params, x, head_dim=head_dim, causal=True, window=window,
        attn_softcap=attn_softcap, rope_theta=rope_theta, impl=impl)
    if cache is None:
        cache = init_cache(B, k.shape[1], max_len, head_dim, cache_dtype,
                           x.device)
    cache.k[..., :Lx, :] = k
    cache.v[..., :Lx, :] = v
    return out, cache


def init_cache(batch, num_kv_heads, max_len, head_dim, dtype=torch.bfloat16,
               device=None, lead=()) -> KVCache:
    shape = tuple(lead) + (batch, num_kv_heads, max_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(params, x, cache: KVCache, pos, *, head_dim, window=0,
                     attn_softcap=0.0, rope_theta=10000.0):
    """One-token cached decode.  x: (B, 1, d); pos: int (aligned batch
    decoding).  Writes position ``pos`` of ``cache`` in place; returns
    (out (B, 1, d), cache)."""

    B = x.shape[0]
    q, k, v = _project_qkv(params, x, head_dim)
    num_heads, num_kv_heads = q.shape[1], k.shape[1]
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posv, rope_theta)
    k = L.apply_rope(k, posv, rope_theta)
    ck, cv = cache
    ck[:, :, pos:pos + 1] = k
    cv[:, :, pos:pos + 1] = v
    Lmax = ck.shape[2]
    group = num_heads // num_kv_heads
    # the JAX reference's rounding: logits in f32 from q and the cache in
    # its dtype, p rounded to the cache dtype, P.V accumulated in f32
    qg = q.reshape(B, num_kv_heads, group, head_dim)
    qg = qg / qg.new_tensor(math.sqrt(head_dim))
    logits = L.upcast(qg) @ L.upcast(ck).transpose(-1, -2)  # (B, Hkv, g, Lmax)
    logits = L.softcap(logits, attn_softcap)
    kpos = torch.arange(Lmax, device=x.device)
    mask = kpos <= pos
    if window:
        mask &= kpos > pos - window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = L.upcast(p.to(cv.dtype)) @ L.upcast(cv)            # (B, Hkv, g, D)
    o = o.to(x.dtype).reshape(B, 1, num_heads * head_dim)
    return L.linear(o, params["wo"]), cache
