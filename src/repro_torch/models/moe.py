"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k router,
sort-based dropless dispatch, a grouped product over the experts, shared
experts, and the router's aux losses.

Dispatch is the JAX package's, with no capacity and no drops: the T·k
token slots are sorted by expert with a stable sort (``jnp.argsort`` is
stable), x is gathered into that order, and each expert's SwiGLU runs on
its contiguous run of slots.  ``jax.lax.ragged_dot`` is an XLA op, not a
Pallas kernel; here the grouped product is one ``torch.matmul`` per
non-empty expert and projection, over that expert's run.  The run lengths
come to the host once per layer (one ``tolist`` of a ``bincount``: a sync
that a CUDA graph of the decode step cannot hold; ROADMAP.md queue 1,
item 7.4).

The weighted slot outputs are put back into slot order and summed over
the k slots of each token: a fixed order, the same sum on either device,
where the JAX package scatter-adds (``.at[slot_token].add``).

Parameters keep the JAX tree: ``Ep = wi_gate.shape[0]`` may exceed the
router's E outputs (experts padded for an EP axis); padded experts are
never picked.  The expert-parallel forms (``ep_axis``/``mesh``, the psum
and all-to-all ``shard_map`` bodies) wait for the mesh item and raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.models import layers as L

EP_REASON = (
    "expert parallelism (ep_axis/mesh, or a MoE model on tensor-parallel "
    "ranks: the JAX package's shard_map psum and all-to-all forms) is not "
    "ported; it is the first of what stays of mesh-sharded LM serving "
    "(ROADMAP.md queue 1, item 6.8)")


def padded_experts(cfg: MoEConfig, pad_to: int) -> int:
    """Expert count padded to a multiple of ``pad_to`` (an EP axis)."""

    E = cfg.num_experts
    if pad_to and E % pad_to:
        return (E // pad_to + 1) * pad_to
    return E


def init_moe(gen, d_model: int, cfg: MoEConfig, dtype, device,
             pad_to: int = 0, lead=()) -> dict:
    E, ff = cfg.num_experts, cfg.expert_d_ff
    Ep = padded_experts(cfg, pad_to)
    s_in, s_ff = d_model ** -0.5, ff ** -0.5
    p = {
        "router": L._normal(gen, (d_model, E), s_in, torch.float32, device,
                            lead),
        "wi_gate": L._normal(gen, (Ep, d_model, ff), s_in, dtype, device,
                             lead),
        "wi_up": L._normal(gen, (Ep, d_model, ff), s_in, dtype, device,
                           lead),
        "wo": L._normal(gen, (Ep, ff, d_model), s_ff, dtype, device, lead),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp_swiglu(
            gen, d_model, cfg.num_shared_experts * ff, dtype, device, lead)
    return p


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, in
    ``jax.lax.top_k``'s order: descending, ties to the lower index (a
    stable descending sort keeps equal entries in index order)."""

    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, xt, cfg: MoEConfig):
    """Router: (top_idx (T, k), renormalised top_w (T, k), aux): the
    switch-style load-balance loss plus a 1e-4 router z-loss."""

    logits = L.upcast(xt) @ params["router"]               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = top_k(probs, cfg.num_experts_per_tok)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    E = cfg.num_experts
    me = probs.mean(dim=0)
    fe = torch.bincount(top_idx.reshape(-1), minlength=E).to(
        probs.dtype) / xt.shape[0]
    aux = E * (me * fe).sum() * cfg.router_aux_loss_coef
    aux = aux + 1e-4 * torch.logsumexp(logits, dim=-1).square().mean()
    return top_idx, top_w, aux


def _grouped_swiglu(params, xs, sizes):
    """Expert e's SwiGLU on its run of ``sizes[e]`` sorted slots."""

    out, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            x = xs[start:start + n]
            h = F.silu(x @ params["wi_gate"][e]) * (x @ params["wi_up"][e])
            out.append(h @ params["wo"][e])
            start += n
    return torch.cat(out) if out else xs.new_zeros(
        (0, params["wo"].shape[-1]))


def _routed(params, xt, top_idx, top_w):
    """(T, d) combined output of the routed experts."""

    T, d = xt.shape
    k = top_idx.shape[1]
    Ep = params["wi_gate"].shape[0]
    slot_expert = top_idx.reshape(-1)                      # (T*k,)
    order = torch.argsort(slot_expert, stable=True)
    xs = xt[order // k]                                    # slot s: token s//k
    sizes = torch.bincount(slot_expert, minlength=Ep).tolist()   # host read
    ys = _grouped_swiglu(params, xs, sizes)
    ys = ys * top_w.reshape(-1)[order][:, None].to(ys.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return ys[inv].reshape(T, k, -1).sum(dim=1)


def moe_ffn(params, x, cfg: MoEConfig, *, ep_axis=None, mesh=None,
            impl: str = "psum"):
    """MoE FFN, single program.  x: (B, L, d) -> (y, aux_loss).  With
    ``ep_axis`` or ``mesh`` (the JAX package's expert-parallel forms, whose
    combine ``impl`` picks) it raises."""

    if ep_axis is not None or mesh is not None:
        raise NotImplementedError(EP_REASON)
    B, Lx, d = x.shape
    xt = x.reshape(-1, d)
    top_idx, top_w, aux = route(params, xt, cfg)
    y = _routed(params, xt, top_idx, top_w)
    if "shared" in params:
        y = y + L.mlp_swiglu(params["shared"], xt)
    return y.reshape(B, Lx, d).to(x.dtype), aux


def moe_ffn_reference(params, x, cfg: MoEConfig):
    """Dense all-experts oracle (tests only): every expert for every token,
    combined with the routing weights."""

    B, Lx, d = x.shape
    xt = x.reshape(-1, d)
    top_idx, top_w, aux = route(params, xt, cfg)
    gate = torch.einsum("td,edf->tef", xt, params["wi_gate"])
    up = torch.einsum("td,edf->tef", xt, params["wi_up"])
    per_expert = torch.einsum("tef,efd->ted", F.silu(gate) * up,
                              params["wo"])
    T, Ep = xt.shape[0], params["wi_gate"].shape[0]
    rows = torch.arange(T, device=x.device).repeat_interleave(
        cfg.num_experts_per_tok)
    combine = torch.zeros((T, Ep), dtype=per_expert.dtype, device=x.device)
    combine = combine.index_put(
        (rows, top_idx.reshape(-1)), top_w.reshape(-1).to(per_expert.dtype),
        accumulate=True)
    y = torch.einsum("ted,te->td", per_expert, combine)
    if "shared" in params:
        y = y + L.mlp_swiglu(params["shared"], xt)
    return y.reshape(B, Lx, d).to(x.dtype), aux
