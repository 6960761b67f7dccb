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
  Under autograd (training) the sum's backward is the identity (its
  upstream is whole on every rank), and two conjugates
  (``layers.all_reduce_grad``) sum what each rank's experts give only
  their own share of: the input's gradient of the routed and split
  shared experts, and the combine weights' gradient, nonzero on a rank
  for its own experts' slots only.  The router's gradient, and its share
  of the input's, is then whole and the same on every rank; its aux path
  is every rank's whole one already and gets no sum.
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
  (ROADMAP.md §3).  It does not train (``A2A_TRAIN_REASON``).

The aux of a training rank (``aux_reckoning``) is the reference's on its
mesh: at one model rank its statistics are summed over the batch group
before the aux is formed (the JAX step's aux over the part's tokens), on
model ranks it is the rank's data row's own (JAX's mean of the data rows'
auxes); either way the rank adds ``aux / n`` of a batch group of n, so
that the ranks' losses sum to the reference's.  ``run_length_reads``
counts the host reads of the run lengths (one a layer a forward, remat's
recompute included).
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
A2A_TRAIN_REASON = (
    "training in the a2a form (Ctx.moe_impl='a2a') on model ranks is not "
    "ported: its sequence split, capacity drops and the all-gather of its "
    "output need backward rules of their own; the reference's launcher "
    "trains in the psum form (ROADMAP.md queue 1, item 6.2c-i-b)")
MOE_IMPLS = ("psum", "a2a")
# the host reads of the run lengths (``_run_lengths``) since the last reset
run_length_reads = [0]


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


def aux_reckoning(tp, batch):
    """(group, n): how a training rank reckons the router's aux, as the
    reference reckons it on its mesh.  ``batch`` is the rank's batch group
    (``Ctx.dp_group``: every ``pod x data`` rank at its model coordinate,
    ``None`` in one process), ``tp`` its model group.

    * At one model rank the reference runs ``_moe_local(..., None)``
      under GSPMD (``src/repro/models/moe.py:215–216``), whose ``route``
      (:92–106) takes ``me``, ``fe`` and the z-loss over the whole part's
      tokens: the rank's sums are summed over ``group = batch`` before the
      aux is formed (``route``).
    * On model ranks (the psum form) its ``shard_map`` body takes each
      data shard's own aux and ``pmean``s it over the data axes and
      ``"model"`` (:126, :230): the mean of the data rows' auxes.  The
      model ranks of a row route the same tokens, so their mean is the
      row's aux: ``group = None``.

    Each rank adds ``aux / n`` (n the batch group's size), so that the
    batch group's losses, summed, count the aux once: the global aux, or
    the mean of the rows'.  The gradient follows: the train step sums the
    replicated router's gradients over the batch group, and ``route``'s
    sum of the statistics (``layers.psum``) sums the ranks' ``1/n``
    shares back to the whole gradient."""

    n = 1 if batch is None else batch.size
    if (tp is not None and tp.size > 1) or n == 1:
        return None, n
    return batch, n


def route(params, xt, cfg: MoEConfig, group=None):
    """Router: (top_idx (T, k), renormalised top_w (T, k), aux): the
    switch-style load-balance loss plus a 1e-4 router z-loss.  Under
    ``group`` (``aux_reckoning``'s) the rank's sums over its tokens (of
    ``probs``, of the slots each expert took, of the squared
    logsumexp) and its token count are summed over the group in one
    ``layers.psum`` before ``me``, ``fe`` and the z-loss are formed: the
    aux over the group's tokens, whose gradient is the sum of the ranks'.
    The slot counts carry no gradient (``top_idx`` has none in JAX
    either)."""

    logits = L.upcast(xt) @ params["router"]               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = top_k(probs, cfg.num_experts_per_tok)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    E = cfg.num_experts
    # the slots each expert took: exact in f32, and a fixed shape, which
    # the meta device counts (bincount's size is read from its data)
    slots = top_idx.reshape(-1)
    taken = probs.new_zeros(E).index_add_(0, slots,
                                          probs.new_ones(slots.shape))
    lse2 = torch.logsumexp(logits, dim=-1).square().sum()
    stats = L.psum(torch.cat([probs.sum(dim=0), taken, lse2[None],
                              probs.new_full((1,), xt.shape[0])]), group)
    tokens = stats[-1]
    me, fe = stats[:E] / tokens, stats[E:2 * E] / tokens
    aux = E * (me * fe).sum() * cfg.router_aux_loss_coef
    aux = aux + 1e-4 * stats[2 * E] / tokens
    return top_idx, top_w, aux


def _route(params, xt, cfg: MoEConfig, group):
    """``route`` as the module holds it at the call, with ``group`` only
    where one sums the statistics: a stand-in that records or forces the
    routing (the LM parity tests, ``chip_smoke.py``'s ``RouteLog``)
    takes the one-process signature."""

    if group is None:
        return route(params, xt, cfg)
    return route(params, xt, cfg, group)


def _run_lengths(keys, first: int, minlength: int, expected: float):
    """The counts of keys ``0 .. first - 1`` among ``keys``: the lengths
    of the first ``first`` runs of the sorted keys, read on the host.  On
    ``meta`` tensors, which hold no keys (``launch/roofline_bench.py``
    counts a step on them), ``expected`` slots split evenly."""

    if keys.device.type == "meta":
        n = int(round(expected))
        return [n // first + (i < n % first) for i in range(first)]
    run_length_reads[0] += 1
    return torch.bincount(keys, minlength=minlength)[:first].tolist()


def _grouped_swiglu(params, xs, sizes):
    """Expert e's SwiGLU on its run of ``sizes[e]`` sorted slots.  Where
    no slot is the experts' (xs has no rows), xs itself, its width
    d_model: the output stays a function of xs, so that under autograd
    the gradient reaches xs's collective on every rank (a rank whose
    experts took no slot, the padded ones' rank, would otherwise skip the
    conjugate's all-reduce that its peers wait in)."""

    out, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            x = xs[start:start + n]
            h = F.silu(x @ params["wi_gate"][e]) * (x @ params["wi_up"][e])
            out.append(h @ params["wo"][e])
            start += n
    return torch.cat(out) if out else xs


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


def _moe_psum(params, xt, cfg: MoEConfig, tp, group):
    top_idx, top_w, aux = _route(params, xt, cfg, group)
    n_local = params["wi_gate"].shape[0]
    # the backward rules (module docstring): the experts' input and the
    # combine weights through the conjugate, the router's input not (its
    # aux path is whole on every rank: summed, it would count n times)
    xe = L.all_reduce_grad(xt, tp)
    y = _routed(params, xe, top_idx, L.all_reduce_grad(top_w, tp),
                tp.rank * n_local, n_local * tp.size)
    split = L.sharded(tp, "shared.wo") is not None
    sh = _shared(params, xe if split else xt)
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
            impl: str = "psum", capacity_factor: float = 2.0, dp=None,
            batch: L.TP | None = None):
    """MoE FFN.  x: (B, L, d) -> (y, aux_loss).

    Single program without ``tp`` (or on one rank).  On the ranks of
    ``tp``, whose expert leaves are the rank's slice of the experts, the
    expert-parallel form ``impl`` picks (module docstring); x and y are
    whole on every rank in both.  The a2a form splits the sequence over
    the ranks and raises ``ValueError`` where L does not split (decode's
    L = 1), as the JAX package's ``shard_map`` fails there.  ``dp`` (the
    JAX package's data-parallel axes) raises: on a ``pod x data x model``
    grid x is already the rank's batch slice, and its ``tp`` the model
    ranks of its data row (``DP_REASON``).  ``batch``, a training rank's
    batch group (``Ctx.dp_group``), makes aux the rank's share of the
    reference's aux on its mesh (``aux_reckoning``); the a2a form does
    not train under it (``A2A_TRAIN_REASON``)."""

    if impl not in MOE_IMPLS:
        raise ValueError(f"impl {impl!r}: one of {MOE_IMPLS}")
    if dp is not None:
        raise NotImplementedError(DP_REASON)
    group, n_batch = aux_reckoning(tp, batch)
    B, Lx, d = x.shape
    if tp is None or tp.size == 1:
        xt = x.reshape(-1, d)
        top_idx, top_w, aux = _route(params, xt, cfg, group)
        y = _routed(params, xt, top_idx, top_w)
        sh = _shared(params, xt)
        y = y if sh is None else y + sh
        return y.reshape(B, Lx, d).to(x.dtype), aux / n_batch
    if L.sharded(tp, "moe.wi_gate") is None:
        raise NotImplementedError(EP_REASON)
    if impl == "psum":
        y, aux = _moe_psum(params, x.reshape(-1, d), cfg, tp, group)
        return y.reshape(B, Lx, d).to(x.dtype), aux / n_batch
    if batch is not None:
        raise NotImplementedError(A2A_TRAIN_REASON)
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
