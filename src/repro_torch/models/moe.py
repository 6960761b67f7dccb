"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k router,
sort-based dropless dispatch, a grouped product over the experts, shared
experts, the router's aux losses, and the two expert-parallel forms.

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
never picked.

Expert parallelism (EP) runs on the ranks of a ``models.layers.TP``, the
``model`` axis (the JAX launcher's ``ep_axis="model"``), whose expert
leaves the sharding rules split on the expert dim (``"moe.wi_gate"`` in
``tp.split``): a rank holds ``Ep / n`` consecutive experts.  On a ``pod x
data x model`` grid the EP ranks are those of one data row, and the
forms below run on that row's tokens, the rank's batch slice.

* ``impl="psum"`` (``_moe_local`` with an axis): activations whole on
  every rank; the rank sorts its slots by ``(e - e0) mod Ep`` so that its
  own experts come first, runs its experts only, and one all-reduce sums
  the ranks' partial outputs.  The shared experts, split by width like a
  dense MLP, add their partial sum before that one all-reduce.  aux is
  every rank's own, the global aux, as the ranks route the same tokens.
* ``impl="a2a"`` (``_moe_a2a``): the rank takes its ``L / n`` positions
  of the sequence, puts its slots into capacity buckets by owner rank
  (JAX's rule: a stable sort by owner, a slot kept while its place in
  its bucket is below ``C = max(1, int(t·k/n · capacity_factor))``), two
  all-to-alls carry the rows and expert ids, the owner runs its experts,
  and a third carries the outputs back; the rank weights and sums its
  slots, and the ranks' sequence parts are all-gathered so that the
  output is whole, as the port's model holds its activations.  aux is
  the mean of the ranks'.  The JAX body also writes every dropped slot
  into bucket (0, 0) and, where XLA applies duplicate scatter writes in
  order (the CPU), so drops the slot kept there; the port keeps it
  (ROADMAP.md §3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.models import layers as L

EP_REASON = (
    "expert parallelism on the 'model' ranks is ported (tp=, the psum and "
    "a2a forms); experts that neither divide the model axis nor are padded "
    "to it (Ctx.ep_pad_to) are not: the rules split them on their width "
    "(ROADMAP.md queue 1, item 6.8.2d)")
DP_REASON = (
    "moe_ffn takes a rank's own tokens: the port's steps cut the batch "
    "over the pod x data ranks before the model runs "
    "(launch/lm_engine.py), so the expert-parallel forms run inside a data "
    "row on its tokens and take no data-parallel axes (ROADMAP.md queue 1, "
    "item 6.8.2)")
MOE_IMPLS = ("psum", "a2a")


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
    # the slots each expert took: exact in f32, and a fixed shape, which
    # the meta device counts (bincount's size is read from its data)
    slots = top_idx.reshape(-1)
    fe = probs.new_zeros(E).index_add_(
        0, slots, probs.new_ones(slots.shape)) / xt.shape[0]
    aux = E * (me * fe).sum() * cfg.router_aux_loss_coef
    aux = aux + 1e-4 * torch.logsumexp(logits, dim=-1).square().mean()
    return top_idx, top_w, aux


def _run_lengths(keys, first: int, minlength: int, expected: float):
    """The counts of keys ``0 .. first - 1`` among ``keys``: the lengths
    of the first ``first`` runs of the sorted keys, read on the host.  On
    ``meta`` tensors, which hold no keys (``launch/roofline_bench.py``
    counts a step on them), ``expected`` slots split evenly."""

    if keys.device.type == "meta":
        n = int(round(expected))
        return [n // first + (i < n % first) for i in range(first)]
    return torch.bincount(keys, minlength=minlength)[:first].tolist()


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


def _routed(params, xt, top_idx, top_w, e0: int = 0, n_total: int = 0):
    """(T, d) combined output of the ``Ep_local = wi_gate.shape[0]``
    experts from ``e0`` (all of them by default) out of ``n_total``; the
    slots of other experts contribute 0, as ``ragged_dot`` zero-fills the
    rows past its groups."""

    T, d = xt.shape
    k = top_idx.shape[1]
    n_local = params["wi_gate"].shape[0]
    n_total = n_total or n_local
    key = (top_idx.reshape(-1) - e0) % n_total             # local first
    order = torch.argsort(key, stable=True)
    E = params["router"].shape[-1]                          # unpadded
    sizes = _run_lengths(key, n_local, n_total,              # host read
                         T * k * max(0, min(n_local, E - e0)) / E)
    mine = order[:sum(sizes)]
    ys = _grouped_swiglu(params, xt[mine // k], sizes)  # slot s: token s//k
    ys = ys * top_w.reshape(-1)[mine][:, None].to(ys.dtype)
    out = ys.new_zeros((T * k, ys.shape[-1]))
    out[mine] = ys
    return out.reshape(T, k, -1).sum(dim=1)


def _shared(params, xt):
    """The shared experts' output, or ``None``; a partial sum where the
    rules split their width (``"shared.wo"``)."""

    return L.mlp_swiglu(params["shared"], xt) if "shared" in params else None


def _moe_psum(params, xt, cfg: MoEConfig, tp):
    top_idx, top_w, aux = route(params, xt, cfg)
    n_local = params["wi_gate"].shape[0]
    y = _routed(params, xt, top_idx, top_w, tp.rank * n_local,
                n_local * tp.size)
    sh = _shared(params, xt)
    split = L.sharded(tp, "shared.wo") is not None
    if sh is not None and split:
        y = y + sh                          # partial: joins the one sum
    y = L.all_reduce(y, tp)
    if sh is not None and not split:
        y = y + sh
    return y, aux


def a2a_capacity(t: int, k: int, n: int, capacity_factor: float) -> int:
    """Slots a rank sends each rank: JAX's ``max(1, int(t·k/n · cf))``."""

    return max(1, int(t * k / n * capacity_factor))


def a2a_buckets(top_idx, n_local: int, n: int, C: int):
    """JAX's buckets of a rank's slots: (``order``, the stable sort of the
    slots by owner rank ``e // n_local``; ``place``, each sorted slot's
    row of the flat (n·C) send buffer, ``n·C`` where it is dropped (its
    place in its bucket is C or more))."""

    dst = top_idx.reshape(-1) // n_local
    order = torch.argsort(dst, stable=True)
    dst_s = dst[order]
    pos = (torch.arange(dst_s.numel(), device=dst_s.device)
           - torch.searchsorted(dst_s, dst_s, side="left"))
    return order, torch.where(pos < C, dst_s * C + pos, n * C)


def _moe_a2a(params, xt, cfg: MoEConfig, tp, capacity_factor: float):
    """(y (t, d), aux, place) of a rank's t tokens: see the module
    docstring.  ``place`` is ``a2a_buckets``'s (``n·C`` marks a drop)."""

    t, d = xt.shape
    k = cfg.num_experts_per_tok
    n = tp.size
    n_local = params["wi_gate"].shape[0]
    C = a2a_capacity(t, k, n, capacity_factor)
    top_idx, top_w, aux = route(params, xt, cfg)
    aux = L.all_reduce(aux, tp) / n
    order, place = a2a_buckets(top_idx, n_local, n, C)
    # a spare last row takes the dropped slots' writes
    send_x = xt.new_zeros((n * C + 1, d))
    send_x[place] = xt[order // k]
    send_e = torch.full((n * C + 1,), n_local, dtype=torch.int32,
                        device=xt.device)               # n_local: empty
    send_e[place] = (top_idx.reshape(-1)[order] % n_local).to(torch.int32)
    recv_x = L.all_to_all(send_x[:-1].view(n, C, d), tp).reshape(n * C, d)
    recv_e = L.all_to_all(send_e[:-1].view(n, C), tp).reshape(n * C)
    o2 = torch.argsort(recv_e, stable=True)             # empty rows last
    sizes = _run_lengths(recv_e, n_local, n_local + 1,   # host read
                         min(n * C, n * t * k * n_local / cfg.num_experts))
    mine = o2[:sum(sizes)]
    ys = _grouped_swiglu(params, recv_x[mine], sizes)
    back = recv_x.new_zeros((n * C + 1, ys.shape[-1]))
    back[mine] = ys.to(back.dtype)
    ret = L.all_to_all(back[:-1].view(n, C, -1), tp).reshape(n * C, -1)
    ret = torch.cat([ret, ret.new_zeros((1, ret.shape[-1]))])
    contrib = ret[place] * top_w.reshape(-1)[order][:, None].to(ret.dtype)
    out = contrib.new_empty((t * k, contrib.shape[-1]))
    out[order] = contrib
    return out.reshape(t, k, -1).sum(dim=1), aux, place


def moe_ffn(params, x, cfg: MoEConfig, *, tp: L.TP | None = None,
            impl: str = "psum", capacity_factor: float = 2.0, dp=None):
    """MoE FFN.  x: (B, L, d) -> (y, aux_loss).

    Single program without ``tp`` (or on one rank).  On the ranks of
    ``tp``, whose expert leaves are the rank's slice of the experts, the
    expert-parallel form ``impl`` picks (module docstring); x and y are
    whole on every rank in both.  The a2a form splits the sequence over
    the ranks and raises ``ValueError`` where L does not split (decode's
    L = 1), as the JAX package's ``shard_map`` fails there.  ``dp`` (the
    JAX package's data-parallel axes) raises: on a ``pod x data x model``
    grid x is already the rank's batch slice, and its ``tp`` the model
    ranks of its data row (``DP_REASON``)."""

    if impl not in MOE_IMPLS:
        raise ValueError(f"impl {impl!r}: one of {MOE_IMPLS}")
    if dp is not None:
        raise NotImplementedError(DP_REASON)
    B, Lx, d = x.shape
    if tp is None or tp.size == 1:
        xt = x.reshape(-1, d)
        top_idx, top_w, aux = route(params, xt, cfg)
        y = _routed(params, xt, top_idx, top_w)
        sh = _shared(params, xt)
        y = y if sh is None else y + sh
        return y.reshape(B, Lx, d).to(x.dtype), aux
    if L.sharded(tp, "moe.wi_gate") is None:
        raise NotImplementedError(EP_REASON)
    if impl == "psum":
        y, aux = _moe_psum(params, x.reshape(-1, d), cfg, tp)
        return y.reshape(B, Lx, d).to(x.dtype), aux
    n = tp.size
    if Lx % n:
        raise ValueError(
            f"the a2a form splits the sequence over the {n} ranks: L = {Lx} "
            "does not split (the JAX package's shard_map fails there too)")
    part = x[:, tp.rank * (Lx // n):(tp.rank + 1) * (Lx // n)]
    xt = part.reshape(-1, d)
    y, aux, _ = _moe_a2a(params, xt, cfg, tp, capacity_factor)
    sh = _shared(params, x.reshape(-1, d))
    y = L.all_gather(y.reshape(B, Lx // n, d), tp, 1)
    if sh is not None:
        y = y + L.all_reduce(sh, L.sharded(tp, "shared.wo")).reshape(
            B, Lx, d)
    return y.to(x.dtype), aux


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
