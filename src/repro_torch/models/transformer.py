"""Decoder-only LM of the dense, MoE and SSM families and the VLM's
backbone (port of ``repro.models.transformer``).

A model is ``embed -> head sublayers -> n_scan x unit -> final_norm ->
unembed``.  A *unit* is a tuple of sublayers (gemma2's local/global
alternation is a 2-sublayer unit repeated 13 times; deepseek's is one
MLA + MoE sublayer repeated 26 times after one MLA + dense head
sublayer; mamba2's is one SSM sublayer with no FFN, repeated 48 times).
As in the JAX package the unit params are stacked with a
leading (n_scan,) axis under ``units.s{i}.*`` and the head sublayers are
not stacked (``head{i}.*``), so a JAX parameter tree carries over leaf
for leaf; JAX's ``lax.scan`` over that axis becomes a Python loop, and its
sharding constraints (``wsc``) are dropped.  The caches are stacked the
same way (a ``KVCache``, an ``MLACache`` or an ``SSMState`` per sublayer)
and written in place by decode.  A prefill fills its attention caches in
place and returns its SSM sublayers' own states, stacked, in the dtypes
the reference gives them (its conv registers in the activations' dtype,
where ``lm_init_cache`` makes them the cache dtype).

Ported: attention, MLA and SSM mixers, SwiGLU MLPs and MoE FFNs.
``init_sublayer`` builds SwiGLU for every dense config, gemma2's included,
exactly as the reference does (its ``mlp_act`` is not read).  Training
(``lm_loss``) runs under autograd through the plain attention and adds the
MoE aux losses; ``Ctx(remat=True)`` recomputes each unit in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the scanned
unit).  The hybrid family (zamba2) lives in ``models/hybrid.py``, the
encoder-decoder (whisper) in ``models/encdec.py``; the VLM (internvl2) is
this dense LM over patch embeddings put before the tokens
(``models/vlm.py``).

Tensor-parallel serving: ``Ctx(tp=TP.of(group, device))`` runs a rank's
shards (``train/sharding.py``, ``train/shard.py``) of the dense, VLM,
MoE and SSM families' prefill and decode: the vocab-parallel embedding and
logits, attention on the rank's whole query heads (its KV cache holds its
KV heads where they divide the ranks; where they do not, every KV head,
k and v gathered whole, the cache cut on its sequence or whole as the
rules' cache specs say, ``TP.kv_cache``, and decode a masked partial
softmax: ``models/attention.py``; MLA's latent cache is whole on every
rank, computed redundantly from the whole ``wkv_a``), Mamba2 on the
rank's whole heads (``models/ssm.py``: its state holds its heads), one
all-reduce after each row-parallel product (attention's, the MLP's, the
shared experts' and Mamba2's ``out_proj``), and the expert-parallel MoE
(``Ctx.ep_pad_to``, ``Ctx.moe_impl``; the EP axis is the ``model`` axis,
as the JAX launcher's ``ep_axis="model"``).  Training on model ranks
runs the dense family's attention the same way, with no cache: where the
KV heads do not divide the ranks k and v are gathered under autograd
(``_kv_train``).

Data parallelism and FSDP (``Ctx.dp``, ``Ctx.fsdp``): a rank of a ``pod x
data x model`` grid runs its batch slice (``launch/lm_engine.py`` cuts
it), or the whole batch where it does not split, its KV caches then cut
on their positions over its data group (``Ctx.kv_seq``, decoded by the
masked partial softmax), and where the rules split weights on
``"data"`` it gathers them whole over its FSDP group just before the
unit, head sublayer or VLM projector that reads them (``_unit``,
``_whole``) and drops them after: one all-gather a unit.  Training
(``lm_hidden_train``) gathers each unit inside its ``checkpoint``-ed
function, so that remat gathers it again in the backward and only one
unit is whole at a time; the gather's backward reduce-scatters the
unit's gradients to the shards (``layers.FSDP``).  A data-parallel
rank's loss (``Ctx.dp_group``) divides its rows' token losses by the
valid targets of the whole batch, all-reduced over its batch group, so
that the ranks' losses sum to the one process's mean
(``train/step.py::make_sharded_train_step``).  The JAX package's one-hot
embedding has no twin: ``models/api.py`` refuses the families and specs
this does not cover.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str = "attn"        # attn | mla | ssm
    ffn: str = "dense"         # dense | moe | none
    window: int = 0            # sliding window (0 = global)
    post_norm: bool = False    # gemma2 sandwich norms


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Build-time execution context: the attention implementation
    (``"kernel"``: the flash kernel, serving only, since it has no
    backward; ``"ref"``: the plain reference), whether training recomputes
    each unit in the backward (``remat``), the KV cache's dtype and the
    rank's tensor-parallel group (``tp``; ``None``: one process holds the
    whole model); the JAX package's expert-parallel fields: the
    expert count padded to a multiple of ``ep_pad_to`` (the EP ranks) and
    the EP combine ``moe_impl`` (``models/moe.py``); and its
    data-parallel ones: ``dp``, the mesh axes a rank's batch is cut on
    (the steps of ``launch/lm_engine.py`` take the rank's slice before
    the model runs, so its layers see that slice and need no collective
    for it), and the rank's FSDP group (``fsdp``, ``layers.FSDP``), over
    which it gathers each unit's weights just before running it; and
    ``kv_seq``, the group of the data ranks of its pod at its model
    coordinate where the rules cut the KV caches' positions on
    ``"data"`` (a batch that does not split: every rank holds it whole,
    and its KV cache a slice of the positions); and ``dp_group``, the
    ``TP`` of a training rank's batch group (every ``pod x data`` rank at
    its model coordinate), over which its loss counts the whole batch's
    valid targets."""

    attn_impl: str = "ref"
    remat: bool = False
    cache_dtype: torch.dtype = torch.bfloat16
    tp: Optional[L.TP] = dataclasses.field(default=None, compare=False)
    ep_pad_to: int = 0                 # pad experts to a multiple (EP ranks)
    moe_impl: str = "psum"             # psum | a2a (EP combine strategy)
    dp: Optional[tuple] = None         # activation batch axes, e.g. ("pod","data")
    fsdp: Optional[L.FSDP] = dataclasses.field(default=None, compare=False)
    kv_seq: Optional[L.TP] = dataclasses.field(default=None, compare=False)
    dp_group: Optional[L.TP] = dataclasses.field(default=None,
                                                 compare=False)

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else self.tp.size

    def __post_init__(self) -> None:
        if self.attn_impl not in A.ATTN_IMPLS:
            raise ValueError(
                f"attn_impl {self.attn_impl!r} is not ported; expected one "
                f"of {A.ATTN_IMPLS} (the JAX package's 'flashref' XLA scan "
                "serves HLO cost probes and has no twin here)")
        if self.moe_impl not in MOE.MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r}: one of "
                             f"{MOE.MOE_IMPLS}")


def unit_spec(cfg: ModelConfig
              ) -> tuple[tuple[SubLayer, ...], int, list[SubLayer]]:
    """(scanned unit sublayers, n_scan, head sublayers); the dense unit for
    the dense and VLM families."""

    if cfg.family == "ssm":
        return (SubLayer(mixer="ssm", ffn="none"),), cfg.num_layers, []
    if cfg.family == "moe" and cfg.mla is not None:
        # deepseek: layer 0 dense, the rest MoE
        head = [SubLayer(mixer="mla", ffn="dense")]
        return (SubLayer(mixer="mla", ffn="moe"),), cfg.num_layers - 1, head
    if cfg.family == "moe":
        return (SubLayer(ffn="moe"),), cfg.num_layers, []
    if cfg.local_global_pattern:
        k = cfg.local_global_pattern
        unit = tuple(
            SubLayer(window=cfg.sliding_window if (i % k) != k - 1 else 0,
                     post_norm=True)
            for i in range(k))
        return unit, cfg.num_layers // k, []
    return (SubLayer(),), cfg.num_layers, []


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _index(tree, i):
    """Leaf ``[i]`` of every tensor in a nested dict / KVCache /
    MLACache / SSMState."""

    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    if isinstance(tree, (A.KVCache, MLA.MLACache, SSM.SSMState)):
        return type(tree)(*(x[i] for x in tree))
    return tree[i]


def _whole(params, key: str, ctx: Ctx) -> dict:
    """``params[key]`` (a head sublayer, the VLM's projector) with its
    FSDP leaves gathered whole over ``ctx.fsdp``, for the one use."""

    return L.fsdp_gather(params[key], ctx.fsdp, key)


def _unit(params, n: int, ctx: Ctx) -> dict:
    """Unit ``n`` of ``params["units"]``, its FSDP leaves gathered whole
    over ``ctx.fsdp`` (one collective a unit and dtype), for the one
    use: the caller drops them after the unit runs."""

    return L.fsdp_gather(_index(params["units"], n), ctx.fsdp, "units")


# ---------------------------------------------------------------------------
# Sublayer init / apply
# ---------------------------------------------------------------------------


def init_sublayer(gen, cfg: ModelConfig, sl: SubLayer, device,
                  lead=(), ep_pad_to: int = 0) -> dict:
    if (sl.mixer not in ("attn", "mla", "ssm")
            or sl.ffn not in ("dense", "moe", "none")):
        raise NotImplementedError(f"sublayer {sl} is not ported yet")
    dtype = _dtype(cfg)

    def norm():
        return torch.zeros(tuple(lead) + (cfg.d_model,), dtype=dtype,
                           device=device)

    p: dict = {"norm1": norm()}
    if sl.mixer == "attn":
        p["attn"] = A.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias, dtype, device, lead)
    elif sl.mixer == "mla":
        p["attn"] = MLA.init_mla(gen, cfg.d_model, cfg.num_heads, cfg.mla,
                                 dtype, device, lead)
    else:
        p["ssm"] = SSM.init_ssm(gen, cfg.d_model, cfg.ssm, dtype, device,
                                lead)
    if sl.ffn != "none":
        p["norm2"] = norm()
    if sl.ffn == "moe":
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.moe, dtype, device,
                                pad_to=ep_pad_to, lead=lead)
    elif sl.ffn == "dense":
        p["mlp"] = L.init_mlp_swiglu(gen, cfg.d_model, cfg.d_ff, dtype,
                                     device, lead)
    if sl.post_norm:
        p["post_norm1"] = norm()
        if sl.ffn != "none":
            p["post_norm2"] = norm()
    return p


def _residual(p, x, h, cfg: ModelConfig, sl: SubLayer, ctx: Ctx):
    """The sublayer after its mixer: x + h (h post-normed in gemma2's
    sandwich), then the pre-norm FFN half (SwiGLU or MoE; none in an SSM
    sublayer).  Returns (x, aux), aux the MoE's aux loss or None: on a
    training rank (``ctx.dp_group``) its share of the reference's aux on
    its mesh (``moe.aux_reckoning``).  Under ``ctx.tp`` a SwiGLU split
    on its hidden width is all-reduced (its input's gradient too, in
    training: ``layers.all_reduce_grad``), and a MoE whose experts are
    split runs the expert-parallel ``ctx.moe_impl`` form."""

    # the post-normed h is a temporary of the sum: the caller still holds
    # the raw h, and one more (B, L, d) tensor would be alive in the MLP
    x = x + (L.rms_norm(h, p["post_norm1"], cfg.norm_eps) if sl.post_norm
             else h)
    if sl.ffn == "none":
        return x, None
    hin = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if sl.ffn == "moe":
        h, aux = MOE.moe_ffn(p["moe"], hin, cfg.moe, tp=ctx.tp,
                             impl=ctx.moe_impl, batch=ctx.dp_group)
    else:
        h = L.mlp_swiglu(p["mlp"], L.all_reduce_grad(
            hin, L.sharded(ctx.tp, "mlp.wi_gate")))
        h, aux = L.all_reduce(h, L.sharded(ctx.tp, "mlp.wo")), None
    del hin
    if sl.post_norm:
        h = L.rms_norm(h, p["post_norm2"], cfg.norm_eps)
    return x + h, aux


def _kv_shard(cfg: ModelConfig, ctx: Ctx) -> A.KVShard | None:
    """The attention's view of K/V on this rank where its KV heads are not
    its own (``ctx.tp.kv_cache`` ``"sequence"`` or ``"whole"``) or its
    cache holds a slice of the positions (``"sequence"``, or
    ``ctx.kv_seq``), else ``None``.  A rank told its KV heads are its own
    whose KV heads do not divide the ranks is refused: its cache layout
    must come from the specs (``launch/lm_engine.py``), never be
    guessed."""

    tp = ctx.tp if ctx.tp is not None and ctx.tp.size > 1 else None
    seq = ctx.kv_seq if ctx.kv_seq is not None and ctx.kv_seq.size > 1 \
        else None
    if tp is None or tp.kv_cache == "heads":
        if tp is not None and cfg.num_kv_heads % tp.size:
            raise ValueError(
                f"{cfg.num_kv_heads} KV heads do not split over {tp.size} "
                "ranks, but the rank's TP holds its KV cache by heads: "
                "build it with the layout of the rules' cache specs "
                "(train/shard.py::kv_cache_layout)")
        return None if seq is None else A.KVShard(None, False, seq)
    if tp.kv_cache == "sequence":
        if seq is not None:
            raise ValueError("the KV positions are cut over the model "
                             "group and over the data group at once; the "
                             "rules cut them on one axis")
        seq = tp
    return A.KVShard(tp, "attn.wk" in tp.split, seq)


def _heads(cfg: ModelConfig, ctx: Ctx) -> int:
    """Query heads of this rank: ``H / n`` where the rules split the
    query projection by whole heads (``tp_refusal`` holds that they
    split), else all ``H``."""

    tp = L.sharded(ctx.tp, "attn.wq")
    return cfg.num_heads // (tp.size if tp else 1)


def _kv_train(cfg: ModelConfig, ctx: Ctx) -> A.KVShard | None:
    """The training attention's view of K/V on a model rank whose KV
    heads do not divide the ranks: its model group, k and v gathered
    where the rules split ``wk`` (in parts of a head), computed whole
    from whole leaves where they keep it whole, and no positions' group
    (training holds no cache: ``TP.kv_cache`` is not read).  ``None``
    where the KV heads are the rank's own."""

    tp = ctx.tp
    if tp is None or tp.size == 1 or cfg.num_kv_heads % tp.size == 0:
        return None
    return A.KVShard(tp, "attn.wk" in tp.split, None)


def _mixer_train(p, x, cfg: ModelConfig, sl: SubLayer, ctx: Ctx):
    """The mixer under autograd.  Attention reads its head counts from the
    weights: on a model rank (``ctx.tp``) rank r's query heads ``[r·H/n,
    (r+1)·H/n)`` run against its own KV heads ``[r·Hkv/n, (r+1)·Hkv/n)``
    where the KV heads divide the ranks, the GQA grouping of the one
    process, and against the KV heads they read where they do not
    (``_kv_train``), as ``apply_sublayer_prefill`` runs them; the caller
    all-reduces the row-parallel ``wo`` product."""

    if sl.mixer == "ssm":
        return SSM.ssm_block(p["ssm"], x, cfg.ssm, cfg.d_model)
    if sl.mixer == "mla":
        return MLA.mla_attention(p["attn"], x, num_heads=_heads(cfg, ctx),
                                 cfg=cfg.mla, rope_theta=cfg.rope_theta,
                                 impl=ctx.attn_impl)
    return A.attention(
        p["attn"], x, head_dim=cfg.resolved_head_dim, causal=True,
        window=sl.window, attn_softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, impl=ctx.attn_impl,
        kv=_kv_train(cfg, ctx))


def apply_sublayer_train(p, x, cfg: ModelConfig, sl: SubLayer, ctx: Ctx):
    """Pre-norm residual block; returns (x, aux): the MoE's
    load-balancing and z losses, 0 for a dense sublayer.  On a model rank
    the normed input enters the split q/k/v products through
    ``layers.all_reduce_grad`` and the ``wo`` product's partial sums are
    all-reduced, as in ``apply_sublayer_prefill``."""

    h_in = L.all_reduce_grad(L.rms_norm(x, p["norm1"], cfg.norm_eps),
                             L.sharded(ctx.tp, "attn.wq"))
    h = _mixer_train(p, h_in, cfg, sl, ctx)
    del h_in
    if sl.mixer != "ssm":
        h = L.all_reduce(h, L.sharded(ctx.tp, "attn.wo"))
    x, aux = _residual(p, x, h, cfg, sl, ctx)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def apply_sublayer_prefill(p, x, max_len, cfg: ModelConfig, sl: SubLayer,
                           ctx: Ctx, cache=None):
    """Causal forward + cache for decode continuation; returns (x, cache).
    An attention or MLA cache is filled in place when given; an SSM
    sublayer returns its own state.  The MoE aux is dropped, as in the
    JAX package."""

    h_in = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if sl.mixer == "ssm":
        h, cache = SSM.ssm_prefill(p["ssm"], h_in, cfg.ssm, cfg.d_model,
                                   tp=ctx.tp)
    elif sl.mixer == "mla":
        h, cache = MLA.mla_prefill(
            p["attn"], h_in, max_len, num_heads=_heads(cfg, ctx),
            cfg=cfg.mla, rope_theta=cfg.rope_theta,
            cache_dtype=ctx.cache_dtype, impl=ctx.attn_impl, cache=cache)
    else:
        h, cache = A.attention_prefill(
            p["attn"], h_in, max_len, head_dim=cfg.resolved_head_dim,
            window=sl.window, attn_softcap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta, impl=ctx.attn_impl,
            cache_dtype=ctx.cache_dtype, cache=cache,
            kv=_kv_shard(cfg, ctx))
    if sl.mixer != "ssm":
        h = L.all_reduce(h, L.sharded(ctx.tp, "attn.wo"))
    del h_in
    return _residual(p, x, h, cfg, sl, ctx)[0], cache


def apply_sublayer_decode(p, cache, x, pos, cfg: ModelConfig, sl: SubLayer,
                          ctx: Ctx):
    h_in = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if sl.mixer == "ssm":
        h, cache = SSM.ssm_decode(p["ssm"], h_in, cache, cfg.ssm,
                                  cfg.d_model, tp=ctx.tp)
    elif sl.mixer == "mla":
        h, cache = MLA.mla_decode(p["attn"], h_in, cache, pos,
                                  num_heads=_heads(cfg, ctx), cfg=cfg.mla,
                                  rope_theta=cfg.rope_theta)
    else:
        h, cache = A.decode_attention(
            p["attn"], h_in, cache, pos, head_dim=cfg.resolved_head_dim,
            window=sl.window, attn_softcap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta, kv=_kv_shard(cfg, ctx))
    if sl.mixer != "ssm":
        h = L.all_reduce(h, L.sharded(ctx.tp, "attn.wo"))
    return _residual(p, x, h, cfg, sl, ctx)[0], cache


# ---------------------------------------------------------------------------
# Unit = tuple of sublayers
# ---------------------------------------------------------------------------


def apply_unit_train(params, x, cfg, unit, ctx):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, sl in enumerate(unit):
        x, a = apply_sublayer_train(params[f"s{i}"], x, cfg, sl, ctx)
        aux = aux + a
    return x, aux


def apply_unit_prefill(params, x, max_len, cfg, unit, ctx, cache=None):
    out = {}
    for i, sl in enumerate(unit):
        x, out[f"s{i}"] = apply_sublayer_prefill(
            params[f"s{i}"], x, max_len, cfg, sl, ctx,
            None if cache is None else cache.get(f"s{i}"))
    return x, out


def apply_unit_decode(params, cache, x, pos, cfg, unit, ctx):
    out = {}
    for i, sl in enumerate(unit):
        x, out[f"s{i}"] = apply_sublayer_decode(
            params[f"s{i}"], cache[f"s{i}"], x, pos, cfg, sl, ctx)
    return x, out


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def init_lm(gen, cfg: ModelConfig, ctx: Ctx, device) -> dict:
    unit, n_scan, head = unit_spec(cfg)
    dtype = _dtype(cfg)
    params: dict = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
        "units": {f"s{i}": init_sublayer(gen, cfg, sl, device, (n_scan,),
                                         ctx.ep_pad_to)
                  for i, sl in enumerate(unit)},
    }
    for i, sl in enumerate(head):
        params[f"head{i}"] = init_sublayer(gen, cfg, sl, device,
                                           ep_pad_to=ctx.ep_pad_to)
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size),
                                      cfg.d_model ** -0.5, dtype, device)
    return params


def _embed_scale(cfg: ModelConfig) -> float:
    # gemma-style sqrt(d) embedding scale for softcapped models
    return cfg.d_model ** 0.5 if cfg.logit_softcap else 1.0


def embed_tokens(params, tokens, cfg: ModelConfig, tp=None,
                 sparse_grad: bool = False):
    return (L.embed(params["embed"], tokens, L.sharded(tp, "embed"),
                    sparse_grad) * _embed_scale(cfg))


def _unembed(params, x, cfg: ModelConfig, tp=None):
    leaf = "embed" if cfg.tie_embeddings else "lm_head"
    return L.unembed(x, params[leaf], cfg.tie_embeddings, cfg.logit_softcap,
                     L.sharded(tp, leaf))


def _unit_train(params, n: int, x, cfg: ModelConfig, unit, ctx: Ctx):
    """Unit ``n`` on x, its FSDP leaves gathered whole for it."""

    return apply_unit_train(_unit(params, n, ctx), x, cfg, unit, ctx)


def lm_hidden_train(params, x, cfg: ModelConfig, ctx: Ctx):
    """Embedded input -> final hidden states (+ MoE aux).  x: (B, L, d).

    With ``ctx.remat`` each unit keeps only its input for the backward and
    recomputes the rest there (non-reentrant ``checkpoint``), its FSDP
    gather included: the gather runs inside the checkpointed function, so
    only the unit being run or recomputed is whole."""

    unit, n_scan, head = unit_spec(cfg)
    # the head sublayers' aux is dropped, as in the JAX package (their FFN
    # is dense in every config)
    for i, sl in enumerate(head):
        x, _ = apply_sublayer_train(_whole(params, f"head{i}", ctx), x, cfg,
                                    sl, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for n in range(n_scan):
        if ctx.remat:
            x, a = checkpoint(_unit_train, params, n, x, cfg, unit, ctx,
                              use_reentrant=False)
        else:
            x, a = _unit_train(params, n, x, cfg, unit, ctx)
        aux = aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def global_valid(targets, ctx: Ctx):
    """``None`` in one process; under ``ctx.dp_group`` the valid targets
    (not -1) of the whole batch, all-reduced over the batch group, at
    least 1 (the denominator ``cross_entropy`` would take)."""

    if ctx.dp_group is None:
        return None
    return L.all_reduce((targets >= 0).sum(), ctx.dp_group).clamp(min=1)


def lm_loss(params, tokens, targets, cfg: ModelConfig, ctx: Ctx):
    """Mean next-token cross-entropy of ``tokens`` (B, L) against
    ``targets`` (B, L; -1 is padding), as a 0-d f32 tensor; on a
    data-parallel rank its rows' share of the whole batch's mean.  On a
    model rank whose table (or head) the rules split on the vocab, the
    lookup is vocab-parallel, the rank's logits are its vocab range alone
    (``h`` entering the product through ``layers.all_reduce_grad``) and
    the loss is ``layers.vocab_parallel_cross_entropy``: the logits are
    never gathered."""

    # a tied table's lookup gradient is sparse and adds its rows into the
    # unembedding's dense gradient: the backward holds one dense gradient
    # of the table, not two (2.2 GiB more at gemma2-2b's f32 table); the
    # vocab-parallel lookup's is dense over the rank's range
    x = embed_tokens(params, tokens, cfg, ctx.tp,
                     sparse_grad=cfg.tie_embeddings)
    h, aux = lm_hidden_train(params, x, cfg, ctx)
    n_valid = global_valid(targets, ctx)
    leaf = "embed" if cfg.tie_embeddings else "lm_head"
    vocab = L.sharded(ctx.tp, leaf)
    if vocab is None:
        logits = _unembed(params, h, cfg)
        return L.cross_entropy(logits, targets, n_valid) + aux
    table = params[leaf]
    logits = L.softcap(L.all_reduce_grad(h, vocab) @ (
        table.T if cfg.tie_embeddings else table), cfg.logit_softcap)
    return L.vocab_parallel_cross_entropy(logits, targets, vocab,
                                          n_valid) + aux


def _sublayer_cache(cfg: ModelConfig, sl: SubLayer, ctx: Ctx, batch: int,
                    max_len: int, device, lead=()):
    if sl.mixer == "ssm":
        return SSM.init_ssm_state(batch, cfg.d_model, cfg.ssm,
                                  ctx.cache_dtype, device, lead, ctx.tp)
    if sl.mixer == "mla":
        return MLA.init_mla_cache(batch, max_len, cfg.mla, ctx.cache_dtype,
                                  device, lead)
    # a rank's KV heads where they are its own (``"heads"``); else every
    # KV head, over its slice of the positions where the rules cut them
    kv = _kv_shard(cfg, ctx)
    kv_tp = L.sharded(ctx.tp, "attn.wk") if kv is None or kv.tp is None \
        else None
    kv_heads = cfg.num_kv_heads // (kv_tp.size if kv_tp else 1)
    return A.init_cache(batch, kv_heads, A.seq_len_of_rank(max_len, kv),
                        cfg.resolved_head_dim, ctx.cache_dtype, device, lead)


def lm_init_cache(cfg: ModelConfig, ctx: Ctx, batch: int, max_len: int,
                  device) -> dict:
    unit, n_scan, head = unit_spec(cfg)
    cache = {f"head{i}": _sublayer_cache(cfg, sl, ctx, batch, max_len,
                                         device)
             for i, sl in enumerate(head)}
    cache["units"] = {
        f"s{i}": _sublayer_cache(cfg, sl, ctx, batch, max_len, device,
                                 (n_scan,))
        for i, sl in enumerate(unit)}
    return cache


def lm_prefill(params, tokens, max_len, cfg: ModelConfig, ctx: Ctx):
    """tokens (B, L) -> (last-position logits (B, V), cache for decode).
    The attention caches are allocated at ``max_len`` and filled in place;
    the SSM sublayers' caches are the prefill's own states."""

    return prefill_embedded(params, embed_tokens(params, tokens, cfg, ctx.tp),
                            max_len, cfg, ctx)


def prefill_embedded(params, x, max_len, cfg: ModelConfig, ctx: Ctx):
    """``lm_prefill`` from the embedded input x (B, L, d): the tokens'
    embeddings, or the VLM's patches and tokens fused."""

    unit, n_scan, head = unit_spec(cfg)
    B = x.shape[0]
    cache = {f"head{i}": _sublayer_cache(cfg, sl, ctx, B, max_len, x.device)
             for i, sl in enumerate(head)}
    for i, sl in enumerate(head):
        x, _ = apply_sublayer_prefill(_whole(params, f"head{i}", ctx), x,
                                      max_len, cfg, sl, ctx,
                                      cache[f"head{i}"])
    filled = {f"s{i}": _sublayer_cache(cfg, sl, ctx, B, max_len, x.device,
                                       (n_scan,))
              for i, sl in enumerate(unit) if sl.mixer != "ssm"}
    states = {f"s{i}": [] for i, sl in enumerate(unit) if sl.mixer == "ssm"}
    for n in range(n_scan):
        x, out = apply_unit_prefill(_unit(params, n, ctx), x, max_len, cfg,
                                    unit, ctx, _index(filled, n))
        for key, st in states.items():
            st.append(out[key])
    cache["units"] = {**filled, **{key: SSM.stack_states(st)
                                   for key, st in states.items()}}
    h = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _unembed(params, h, cfg, ctx.tp), cache


def lm_decode_step(params, cache, token, pos, cfg: ModelConfig, ctx: Ctx):
    """token: (B,) int; pos: int.  Writes position ``pos`` of ``cache`` in
    place; returns (logits (B, V), cache)."""

    unit, n_scan, head = unit_spec(cfg)
    x = embed_tokens(params, token[:, None], cfg, ctx.tp)
    for i, sl in enumerate(head):
        x, _ = apply_sublayer_decode(_whole(params, f"head{i}", ctx),
                                     cache[f"head{i}"], x, pos, cfg, sl, ctx)
    for n in range(n_scan):
        x, _ = apply_unit_decode(_unit(params, n, ctx),
                                 _index(cache["units"], n), x, pos, cfg,
                                 unit, ctx)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, h[:, 0], cfg, ctx.tp), cache
