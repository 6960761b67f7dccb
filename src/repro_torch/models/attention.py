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
parallelism a rank holds whole query heads (``train/sharding.py``) and
returns its partial sum of the row-parallel ``wo`` product, which the
caller all-reduces.  Where its KV heads are its own too (the rules cut
the cache on its heads), the same code runs its local heads, the GQA
group unchanged.  Where they are not (MQA/GQA whose KV heads do not
divide the ranks), or where the rules cut the cache's positions, the
caller passes a ``KVShard`` (training too, with no positions' group: the
gather's backward reduce-scatters):

* a rank whose ``wk``/``wv`` hold a part of the k/v columns (the rules cut
  them in parts of a head) all-gathers k and v whole before the rotation,
  which pairs column i with column i + D/2; a rank with ``wk`` whole
  computes them whole;
* a rank whose KV heads are not its own runs its query heads against the
  KV heads they read (``_rank_kv``);
* where the rules cut the cache on its sequence, over the model group
  (the KV heads do not divide it) or over the rank's data group (a batch
  that does not split, ``long_500k``), the group's rank ``s`` of ``n``
  holds positions ``[s·Lr, (s+1)·Lr)`` (``Lr = Lmax / n``): the prefill
  computes the whole prompt and writes the prompt's positions among them;
* a decode step over a sequence-cut cache is a masked partial softmax:
  only the rank that owns ``pos`` writes it; where the positions' group
  is the model group, q is all-gathered (every head against the rank's
  keys), and where it is the data group the rank's own heads are all it
  needs; the logits' maxima are all-reduced over the positions' group,
  then the sums of ``exp(l - m)``; ``p = exp(l - m) / s`` is rounded to
  the cache dtype as the reference rounds its normalised softmax, and the
  partial P·V products are summed over the group (``softmax_pv``).  A
  slice wholly masked gives ``exp(-1e30 - m) = 0``: the rank that owns
  ``pos`` always holds a live key, so ``m`` is a real logit.
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


class KVShard(NamedTuple):
    """A rank's view of K/V where its KV heads are not its own (the rules'
    ``"model"`` layout ``"sequence"`` or ``"whole"``,
    ``train/shard.py::kv_cache_layout``) or its cache holds a slice of
    the positions: ``tp``, its model group where its KV heads are not its
    own (``None`` where they are); ``gather``, whether its ``wk``/``wv``
    hold a part of the k/v columns (then k and v are all-gathered over
    ``tp``); ``seq``, the group whose ranks hold the slices of the
    positions (``tp`` itself, the rank's data group, or ``None``: every
    position).  The rank's query heads are its own."""

    tp: L.TP | None
    gather: bool
    seq: L.TP | None

    @property
    def gather_q(self) -> bool:
        """Whether a decode step gathers every rank's query heads: the
        positions are cut over the group that also cuts the heads."""

        return self.seq is not None and self.seq is self.tp


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


def _gather_columns(parts, tp: L.TP):
    """Each of ``parts`` (B, Lx, w) whole: the ranks' column slices
    concatenated in rank order, all of them in one all-gather (under
    autograd one whose backward reduce-scatters)."""

    widths = [p.shape[-1] for p in parts]
    got = L.all_gather(torch.cat(parts, dim=-1)[None], tp, 0)  # (n, B, Lx, W)
    n, B, Lx, _ = got.shape
    return [g.permute(1, 2, 0, 3).reshape(B, Lx, n * w)
            for g, w in zip(got.split(widths, dim=-1), widths)]


def _project_qkv(params, x, head_dim, kv: KVShard | None = None,
                 gather_q: bool = False):
    """(B, H, Lx, D) q, k, v, each contiguous (the kernel's layout), at
    the head counts of the weights ``params`` holds; under ``kv`` k and v
    whole (gathered where ``kv.gather``), and with ``gather_q`` every
    rank's query heads."""

    B, Lx, _ = x.shape
    q = L.linear(x, params["wq"], params.get("bq"))
    k = L.linear(x, params["wk"], params.get("bk"))
    v = L.linear(x, params["wv"], params.get("bv"))
    if kv is not None and (kv.gather or gather_q):
        whole = _gather_columns(([q] if gather_q else [])
                                + ([k, v] if kv.gather else []), kv.tp)
        q = whole.pop(0) if gather_q else q
        k, v = whole if kv.gather else (k, v)
    if q.shape[-1] % head_dim or k.shape[-1] % head_dim:
        raise ValueError(
            f"q width {q.shape[-1]} / k width {k.shape[-1]} hold a part of "
            f"a head of {head_dim}: a rank whose k/v projection is cut in "
            "parts of a head gathers them (KVShard)")
    num_heads = q.shape[-1] // head_dim
    num_kv_heads = k.shape[-1] // head_dim
    q = q.reshape(B, Lx, num_heads, head_dim).transpose(1, 2).contiguous()
    k = k.reshape(B, Lx, num_kv_heads, head_dim).transpose(1, 2).contiguous()
    v = v.reshape(B, Lx, num_kv_heads, head_dim).transpose(1, 2).contiguous()
    return q, k, v


def _rank_kv(k, v, kv: KVShard, heads: int):
    """The KV heads that the rank's ``heads`` query heads read, out of all
    of k and v (B, Hkv, ..., D), laid out so that query head i reads KV
    head ``i // (heads / Hsel)``: a run of whole GQA groups, the one KV
    head of a part of a group, or (where the rank's heads straddle a
    group's edge) a KV head for each query head."""

    hkv = k.shape[1]
    group = heads * kv.tp.size // hkv
    lo = kv.tp.rank * heads
    if heads % group == 0 or group % heads == 0:
        n = max(heads // group, 1)
        return k.narrow(1, lo // group, n), v.narrow(1, lo // group, n)
    idx = torch.arange(lo, lo + heads, device=k.device) // group
    return k.index_select(1, idx), v.index_select(1, idx)


def _self_attention(params, x, *, head_dim, causal, window, attn_softcap,
                    rope_theta, impl, kv: KVShard | None = None):
    """(output (B, L, d), roped k, v) of self-attention over x (B, L, d)
    at positions 0..L-1; under ``kv`` k and v whole, the rank's query
    heads against the KV heads they read."""

    B, Lx, _ = x.shape
    q, k, v = _project_qkv(params, x, head_dim, kv)
    positions = torch.arange(Lx, device=x.device)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    kr, vr = (k, v) if kv is None or kv.tp is None else (
        t.contiguous() for t in _rank_kv(k, v, kv, q.shape[1]))
    o = _attend(q, kr, vr, impl, causal=causal, window=window,
                softcap=attn_softcap)
    del kr, vr
    o = o.transpose(1, 2).reshape(B, Lx, q.shape[1] * head_dim)
    return L.linear(o, params["wo"]), k, v


def attention(params, x, *, head_dim, causal=True, window=0,
              attn_softcap=0.0, rope_theta=10000.0, impl="ref",
              kv: KVShard | None = None):
    """Training self-attention.  x: (B, L, d).  Under ``kv`` (a model
    rank whose KV heads are not its own; no positions' group: training
    holds no cache) the rank's query heads run against the KV heads they
    read, k and v gathered whole where its ``wk``/``wv`` hold a part of
    their columns.  Under autograd the gather's backward reduce-scatters
    (``layers.all_gather``), and the KV heads the rank picks pass their
    gradients back (a head two of its query heads read gets their sum)."""

    out, _, _ = _self_attention(
        params, x, head_dim=head_dim, causal=causal, window=window,
        attn_softcap=attn_softcap, rope_theta=rope_theta, impl=impl, kv=kv)
    return out


def attention_prefill(params, x, max_len, *, head_dim, window=0,
                      attn_softcap=0.0,
                      rope_theta=10000.0, impl="ref",
                      cache_dtype=torch.bfloat16, cache=None,
                      kv: KVShard | None = None):
    """Causal forward over L prompt tokens + the KV cache (padded to
    ``max_len``) needed to continue decoding at position L.  ``cache``, if
    given, is a ``KVCache`` of (B, Hkv, max_len, D) tensors to fill in
    place (the model's stacked cache); otherwise a new one is made.  Under
    a sequence-cut ``kv`` the cache holds the rank's ``max_len / n``
    positions, and the rank writes the prompt's positions among them (a
    prompt may end before them: it writes none)."""

    B, Lx, _ = x.shape
    out, k, v = _self_attention(
        params, x, head_dim=head_dim, causal=True, window=window,
        attn_softcap=attn_softcap, rope_theta=rope_theta, impl=impl, kv=kv)
    seq = None if kv is None else kv.seq
    if cache is None:
        cache = init_cache(B, k.shape[1], seq_len_of_rank(max_len, kv),
                           head_dim, cache_dtype, x.device)
    if seq is None:
        cache.k[..., :Lx, :] = k
        cache.v[..., :Lx, :] = v
        return out, cache
    n = cache.k.shape[-2]
    if Lx > n * seq.size:
        raise ValueError(f"a prompt of {Lx} does not fit {seq.size} "
                         f"slices of {n} positions")
    lo = seq.rank * n
    hi = min(Lx, lo + n)
    if hi > lo:
        cache.k[..., :hi - lo, :] = k[:, :, lo:hi]
        cache.v[..., :hi - lo, :] = v[:, :, lo:hi]
    return out, cache


def seq_len_of_rank(max_len: int, kv: KVShard | None) -> int:
    """The positions a rank's KV cache holds: ``max_len``, or its slice of
    them where the cache is cut on its sequence."""

    if kv is None or kv.seq is None:
        return max_len
    if max_len % kv.seq.size:
        raise ValueError(f"the rules cut the KV cache on its sequence, but "
                         f"max_len {max_len} does not split over "
                         f"{kv.seq.size} ranks")
    return max_len // kv.seq.size


def init_cache(batch, num_kv_heads, max_len, head_dim, dtype=torch.bfloat16,
               device=None, lead=()) -> KVCache:
    shape = tuple(lead) + (batch, num_kv_heads, max_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_logits(q, ck, kpos, pos: int, *, head_dim, window=0,
                  attn_softcap=0.0):
    """The float32 logits (..., B, Hkv, g, Lk) of one decode step's q (B,
    H, 1, D) against the keys ck (..., B, Hkv, Lk, D) at the global
    positions ``kpos`` (Lk, or broadcast against the logits), softcapped,
    then those past ``pos`` or before the ``window`` filled with -1e30:
    the JAX reference's rounding (logits in f32 from q and the cache in
    its dtype)."""

    B, H = q.shape[:2]
    hkv = ck.shape[-3]
    qg = q.reshape(B, hkv, H // hkv, head_dim)
    qg = qg / qg.new_tensor(math.sqrt(head_dim))
    logits = L.upcast(qg) @ L.upcast(ck).transpose(-1, -2)
    logits = L.softcap(logits, attn_softcap)
    mask = kpos <= pos
    if window:
        mask = mask & (kpos > pos - window)
    return logits.masked_fill(~mask, -1e30)


def softmax_pv(logits, cv, reduce=None):
    """The softmax of ``logits`` over keys times the values cv (..., B,
    Hkv, Lk, D), in float32: p rounded to the cache dtype, P·V accumulated
    in f32 (the reference's rounding).  With ``reduce(x, op)`` (``op`` in
    ``"max"``, ``"sum"``) the keys are one slice of the positions and
    ``reduce`` combines over the slices: the maxima, then the sums of
    ``exp(l - m)``, then the partial P·V products, so that p is the
    normalised softmax over all the positions, rounded as the reference
    rounds it."""

    if reduce is None:
        p = torch.softmax(logits, dim=-1)
        return L.upcast(p.to(cv.dtype)) @ L.upcast(cv)
    m = reduce(logits.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(logits - m)
    s = reduce(e.sum(dim=-1, keepdim=True), "sum")
    p = (e / s).to(cv.dtype)
    del e
    return reduce(L.upcast(p) @ L.upcast(cv), "sum")


def tp_reduce(tp: L.TP):
    """``softmax_pv``'s ``reduce`` over the ranks of ``tp``."""

    return lambda x, op: L.all_reduce(x, tp, op)


def decode_attention(params, x, cache: KVCache, pos, *, head_dim, window=0,
                     attn_softcap=0.0, rope_theta=10000.0,
                     kv: KVShard | None = None):
    """One-token cached decode.  x: (B, 1, d); pos: int (aligned batch
    decoding).  Writes position ``pos`` of ``cache`` in place (under a
    sequence-cut ``kv``, only on the rank whose slice holds it); returns
    (out (B, 1, d), cache)."""

    B = x.shape[0]
    seq = None if kv is None else kv.seq
    gather_q = kv is not None and kv.gather_q
    q, k, v = _project_qkv(params, x, head_dim, kv, gather_q=gather_q)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posv, rope_theta)
    k = L.apply_rope(k, posv, rope_theta)
    ck, cv = cache
    n = ck.shape[2]
    lo = 0 if seq is None else seq.rank * n
    if lo <= pos < lo + n:
        ck[:, :, pos - lo:pos - lo + 1] = k
        cv[:, :, pos - lo:pos - lo + 1] = v
    heads = q.shape[1] // (kv.tp.size if gather_q else 1)
    if kv is not None and kv.tp is not None and not gather_q:
        ck, cv = _rank_kv(ck, cv, kv, heads)
    logits = decode_logits(q, ck, lo + torch.arange(n, device=x.device), pos,
                           head_dim=head_dim, window=window,
                           attn_softcap=attn_softcap)
    o = softmax_pv(logits, cv, None if seq is None else tp_reduce(seq))
    o = o.to(x.dtype).reshape(B, q.shape[1], head_dim)
    if gather_q:
        # the rank's own heads, for its rows of the row-parallel wo
        o = o[:, kv.tp.rank * heads:(kv.tp.rank + 1) * heads]
    return L.linear(o.reshape(B, 1, heads * head_dim), params["wo"]), cache
