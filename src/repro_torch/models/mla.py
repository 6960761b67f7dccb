"""DeepSeek-V2 multi-head latent attention (port of ``repro.models.mla``).

K and V are compressed into a latent ``c_kv`` (kv_lora_rank wide) plus one
shared rope key head; the decode cache keeps only (c_kv, k_rope).  Prefill
expands the latent and runs standard attention over [nope | rope] per head
(the shared rope key broadcast to every head), with V keeping its own head
dim, so it goes through ``attention._attend``: the flash kernel at D =
nope + rope and Dv = v_head_dim.  Decode is the absorbed form: the K
up-projection is folded into the query and the V up-projection into the
output, so it attends straight against the latent cache.

The JAX decode's products take the cache in its storage dtype with
``preferred_element_type=float32``.  Upcasting bf16 to f32 is exact and
so is the product of two bf16 values in f32, so f32 products of the
upcast operands compute the same sums (TF32 stays off, PyTorch's default).
As the dense attention does, the port writes the new position into the
cache in place and returns the same tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import MLAConfig
from repro_torch.models import layers as L


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (..., B, Lmax, kv_lora)
    k_rope: torch.Tensor   # (..., B, Lmax, rope_dim)


def init_mla(gen, d_model: int, num_heads: int, cfg: MLAConfig, dtype,
             device, lead=()) -> dict:
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    hv = num_heads * cfg.v_head_dim
    s = d_model ** -0.5
    return {
        # v2-lite: full-rank queries (q_lora_rank == 0)
        "wq": L._normal(gen, (d_model, num_heads * qk_dim), s, dtype, device,
                        lead),
        "wkv_a": L._normal(
            gen, (d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim), s,
            dtype, device, lead),
        "kv_norm": torch.zeros(tuple(lead) + (cfg.kv_lora_rank,),
                               dtype=dtype, device=device),
        "wkv_b": L._normal(
            gen, (cfg.kv_lora_rank,
                  num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            cfg.kv_lora_rank ** -0.5, dtype, device, lead),
        "wo": L._normal(gen, (hv, d_model), hv ** -0.5, dtype, device, lead),
    }


def _compress(params, x, cfg: MLAConfig, positions, rope_theta):
    """x -> (c_kv normalised (B, L, r), k_rope roped (B, L, dr))."""

    c_kv, k_rope = L.linear(x, params["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = L.rms_norm(c_kv, params["kv_norm"])
    k_rope = L.apply_rope(k_rope[:, None], positions, rope_theta)[:, 0]
    return c_kv, k_rope


def _queries(params, x, num_heads, cfg: MLAConfig, positions, rope_theta):
    B, Lx, _ = x.shape
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q = L.linear(x, params["wq"]).reshape(B, Lx, num_heads, qk_dim)
    q_nope, q_rope = q.transpose(1, 2).split(
        [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, L.apply_rope(q_rope, positions, rope_theta)


def _forward(params, x, num_heads, cfg: MLAConfig, rope_theta, positions,
             impl):
    """(output (B, L, d), c_kv, k_rope) of causal MLA over x (B, L, d)."""

    from repro_torch.models.attention import _attend

    B, Lx, _ = x.shape
    if positions is None:
        positions = torch.arange(Lx, device=x.device)
    q_nope, q_rope = _queries(params, x, num_heads, cfg, positions,
                              rope_theta)
    c_kv, k_rope = _compress(params, x, cfg, positions, rope_theta)
    kv = L.linear(c_kv, params["wkv_b"]).reshape(
        B, Lx, num_heads, cfg.qk_nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv.transpose(1, 2).split(
        [cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    # the kernel's layout: contiguous (B, H, L, D) tensors, D = nope + rope
    q = torch.cat([q_nope, q_rope], dim=-1)
    k_rope_b = k_rope[:, None].expand(B, num_heads, Lx,
                                      cfg.qk_rope_head_dim)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    o = _attend(q, k, v.contiguous(), impl, causal=True)
    o = o.to(x.dtype).transpose(1, 2).reshape(
        B, Lx, num_heads * cfg.v_head_dim)
    return L.linear(o, params["wo"]), c_kv, k_rope


def mla_attention(params, x, *, num_heads, cfg: MLAConfig,
                  rope_theta=10000.0, positions=None, impl="ref"):
    """Training / prefill attention.  x: (B, L, d)."""

    out, _, _ = _forward(params, x, num_heads, cfg, rope_theta, positions,
                         impl)
    return out


def init_mla_cache(batch, max_len, cfg: MLAConfig, dtype=torch.bfloat16,
                   device=None, lead=()) -> MLACache:
    shape = tuple(lead) + (batch, max_len)
    return MLACache(
        torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dtype, device=device),
        torch.zeros(shape + (cfg.qk_rope_head_dim,), dtype=dtype,
                    device=device))


def mla_prefill(params, x, max_len, *, num_heads, cfg: MLAConfig,
                rope_theta=10000.0, cache_dtype=torch.bfloat16, impl="ref",
                cache=None):
    """Causal forward + the latent cache padded to ``max_len``; ``cache``,
    if given, is an ``MLACache`` to fill in place."""

    B, Lx, _ = x.shape
    out, c_kv, k_rope = _forward(params, x, num_heads, cfg, rope_theta,
                                 None, impl)
    if cache is None:
        cache = init_mla_cache(B, max_len, cfg, cache_dtype, x.device)
    cache.c_kv[..., :Lx, :] = c_kv
    cache.k_rope[..., :Lx, :] = k_rope
    return out, cache


def mla_decode(params, x, cache: MLACache, pos, *, num_heads,
               cfg: MLAConfig, rope_theta=10000.0):
    """Absorbed one-token decode against the latent cache.  x: (B, 1, d).
    Writes position ``pos`` of ``cache`` in place."""

    B = x.shape[0]
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(params, x, num_heads, cfg, posv, rope_theta)
    c_new, kr_new = _compress(params, x, cfg, posv, rope_theta)
    c_kv, k_rope = cache
    c_kv[:, pos:pos + 1] = c_new
    k_rope[:, pos:pos + 1] = kr_new

    wkv_b = params["wkv_b"].reshape(r, num_heads, dn + cfg.v_head_dim)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]           # (r, H, dn|dv)
    # the K up-projection absorbed into the query: (B, H, r)
    q_eff = torch.einsum("bhd,rhd->bhr", L.upcast(q_nope[:, :, 0]),
                         L.upcast(w_k))
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    c32 = c_kv.float()                                     # (B, Lmax, r)
    logits = (q_eff.to(c_kv.dtype).float() @ c32.transpose(1, 2)
              + q_rope[:, :, 0].to(k_rope.dtype).float()
              @ k_rope.float().transpose(1, 2)) * scale   # (B, H, Lmax)
    mask = torch.arange(c_kv.shape[1], device=x.device) <= pos
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    ctx = p.to(c_kv.dtype).float() @ c32                   # (B, H, r)
    o = torch.einsum("bhr,rhd->bhd", L.upcast(ctx.to(w_v.dtype)),
                     L.upcast(w_v))
    o = o.to(x.dtype).reshape(B, 1, num_heads * cfg.v_head_dim)
    return L.linear(o, params["wo"]), cache
