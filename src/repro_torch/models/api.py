"""Model API of the port (``repro.models.api``):
``build_model(cfg, ctx, device) -> Model`` for every family.

A ``Model`` packages init / loss / prefill / decode / init_cache behind
one signature, as in the JAX package.  Batches are dicts::

    LM:     {"tokens": (B, L) int, "targets": (B, L) int}
    VLM:    + {"patches": (B, P, 1024) float}
    encdec: {"frames": (B, T_frames, d) float} + tokens/targets

``"targets"`` only for ``loss``.  The dense, MoE and SSM families build
from ``models/transformer.py``, the hybrid (zamba2) from
``models/hybrid.py``, the encoder-decoder (whisper) from
``models/encdec.py`` and the VLM (internvl2) from ``models/vlm.py``.

Shapes without allocation, as the JAX package takes them from
``jax.eval_shape``: ``param_specs``, ``cache_specs`` and ``input_specs``
give trees of tensors on the ``meta`` device, and the parameter counts
(``param_count``, ``matmul_param_count``, ``active_param_count``) count
them.  Leaf paths are spelled as ``jax.tree_util.keystr`` spells them.

A ``Ctx`` with a tensor-parallel group (``ctx.tp``, more than one rank)
builds the rank's serving model over its shards, for every family; KV
heads that do not divide the ranks (MQA/GQA) are served with k and v
gathered whole and the KV cache cut on its sequence where the rules cut
it (``TP.kv_cache``).  The shapes it does not cover (query or Mamba2
heads that do not split into whole heads a rank, the hybrid's unequal
query and KV heads) raise ``NotImplementedError`` here, naming their
ROADMAP item: there is no replicated fallback.  The same ``Ctx`` trains
the dense and MoE families wherever their query heads split
(``loss_refusal``): ``models/transformer.py::lm_loss`` on the rank's
shards, the collectives' backward rules in ``models/layers.py``.  KV
heads that do not divide the ranks train too: k and v gathered whole
where the rules cut ``wk``/``wv`` in parts of a head (the gather's
backward a reduce-scatter), computed whole where they keep them whole
(their gradients then summed over the model group, ``train/step.py``,
as MLA's whole latent leaves are).  The MoE family trains in the psum
form, its router's aux reckoned as the reference reckons it on the mesh
(``models/moe.py::aux_reckoning``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.state import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.optim.optimizers import tree_flatten_with_path

Ctx = T.Ctx

TP_ITEM = "ROADMAP.md queue 1, item 6.8"
TRAIN_ITEM = "ROADMAP.md queue 1, item 6.2"
# the families that train on more than one rank
TRAIN_FAMILIES = ("dense", "moe")
FAMILY_TRAIN_REASON = (
    "training the {family} family on more than one rank is not ported: the "
    "port trains the dense and MoE families on data and model ranks (the "
    "SSM and hybrid families' collectives have no backward rules; the VLM "
    "and encoder-decoder losses gather nothing; "
    f"{TRAIN_ITEM}c)")


class Model(NamedTuple):
    cfg: ModelConfig
    ctx: T.Ctx
    device: torch.device
    init: Callable[..., Any]          # (generator) -> params
    loss: Callable[..., Any]          # (params, batch) -> scalar
    prefill: Callable[..., Any]       # (params, batch, max_len) -> (logits, cache)
    decode: Callable[..., Any]        # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable[..., Any]    # (batch, max_len) -> cache


_LM = (T.init_lm, T.lm_loss, T.lm_prefill, T.lm_decode_step,
       T.lm_init_cache, ())
# family -> (init, loss, prefill, decode, init_cache, the batch's float
# inputs before the tokens)
_FAMILIES = {
    "dense": _LM, "moe": _LM, "ssm": _LM,
    "hybrid": (HY.init_hybrid, HY.hybrid_loss, HY.hybrid_prefill,
               HY.hybrid_decode_step, HY.hybrid_init_cache, ()),
    "encdec": (ED.init_encdec, ED.encdec_loss, ED.encdec_prefill,
               ED.encdec_decode_step, ED.encdec_init_cache, ("frames",)),
    "vlm": (V.init_vlm, V.vlm_loss, V.vlm_prefill, V.vlm_decode_step,
            T.lm_init_cache, ("patches",)),
}


def tp_refusal(cfg: ModelConfig, size: int) -> str | None:
    """Why ``cfg`` cannot be served on ``size`` tensor-parallel ranks by
    the port's explicit collectives, or ``None`` where it can: every
    family whose query heads split into whole heads a rank.  That is the
    query heads of the dense, VLM, MoE (MLA's included, its latent cache
    whole on every rank), hybrid and encoder-decoder families, and the
    Mamba2 heads of the SSM and hybrid families (their state by head,
    ``conv_B``/``conv_C`` whole on every rank).  KV heads need not split:
    where they do not divide the ranks, each rank gathers k and v whole
    and holds every KV head, its cache cut on its sequence where the rules
    cut it (a masked partial softmax decodes it) and whole where they keep
    it whole (``models/attention.py``).  The hybrid's ``lora_b``
    is split on its width, which lines up with a rank's q/k/v columns only
    where the query and KV head counts are equal.  The MoE family's
    experts are split by expert (``Ctx.ep_pad_to`` pads them to the axis;
    ``train/shard.py::model_split`` refuses them split otherwise)."""

    if size <= 1:
        return None
    if cfg.family in ("ssm", "hybrid"):
        nheads = cfg.ssm.n_heads(cfg.d_model)
        if nheads % size:
            return (f"{nheads} Mamba2 heads do not split over {size} ranks: "
                    "the rules cut d_inner into parts of a head, or keep "
                    "the heads whole, and the port's SSD runs whole heads a "
                    f"rank ({TP_ITEM})")
        if cfg.family == "ssm":
            return None
    if cfg.family == "hybrid" and cfg.num_heads != cfg.num_kv_heads:
        return (f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV "
                "heads: the rules split the shared block's lora_b on its "
                "max(H, Hkv) * head_dim width, whose rank slice is not the "
                "rank's k/v columns where H != Hkv; the port adds each "
                f"rank's lora_b columns to its heads' ({TP_ITEM})")
    if cfg.num_heads % size:
        return (f"{cfg.num_heads} query heads do not split over {size} "
                "ranks: the sharding rules cut the flat q width into parts "
                "of a head, or replicate it, and the port's collectives need "
                f"whole heads a rank ({TP_ITEM})")
    return None


def tp_train_refusal(cfg: ModelConfig, size: int,
                     moe_impl: str = "psum") -> str | None:
    """Why ``cfg`` cannot train on ``size`` model ranks, or ``None``: the
    dense and MoE families alone (item 6.2c), the MoE family in the psum
    form (``moe_impl``; the a2a form is item 6.2c-i-b), their query heads
    split into whole heads a rank (``tp_refusal``, item 6.8).  The KV
    heads need not divide the ranks (``models/transformer.py::
    _kv_train``); the experts are split by expert, padded to the axis
    where they do not divide it (``Ctx.ep_pad_to``; otherwise
    ``train/shard.py::model_split`` and ``moe.EP_REASON`` refuse them)."""

    if size <= 1:
        return None
    if cfg.family not in TRAIN_FAMILIES:
        return FAMILY_TRAIN_REASON.format(family=cfg.family)
    if cfg.family == "moe" and moe_impl == "a2a":
        return MOE.A2A_TRAIN_REASON
    return tp_refusal(cfg, size)


def loss_refusal(cfg: ModelConfig, ctx: T.Ctx) -> str | None:
    """Why a rank's model under ``ctx`` cannot train, or ``None`` where it
    can: in one process; for the dense and MoE families on model ranks
    (``ctx.tp``) whose query heads divide them (``tp_train_refusal``; the
    MoE family in the psum form), whatever the KV heads and the
    ``TP.kv_cache`` (training holds no cache); and on data ranks, its
    batch cut over ``pod x data`` (``ctx.dp``) and its batch group given
    (``ctx.dp_group``, over which the loss counts the whole batch's
    targets and the MoE router its aux), as ``train/step.py::
    make_sharded_train_step`` builds it.  The other families on more than
    one rank wait for their own losses (item 6.2c)."""

    data = (ctx.fsdp is not None or bool(ctx.dp) or ctx.kv_seq is not None
            or ctx.dp_group is not None)
    if ctx.tp_size == 1 and not data:
        return None
    if cfg.family not in TRAIN_FAMILIES:
        return FAMILY_TRAIN_REASON.format(family=cfg.family)
    reason = tp_train_refusal(cfg, ctx.tp_size, ctx.moe_impl)
    if reason:
        return reason
    if data and (ctx.kv_seq is not None or not ctx.dp
                 or ctx.dp_group is None):
        return ("training on data ranks needs the batch cut over pod x "
                "data and the batch group (Ctx.dp, Ctx.dp_group), so that "
                "each rank's loss is its rows' share of the whole batch's "
                "mean: train/step.py::make_sharded_train_step builds such "
                f"a rank ({TRAIN_ITEM}a)")
    return None


def build_model(cfg: ModelConfig, ctx: T.Ctx | None = None,
                device="cuda") -> Model:
    """The model of ``cfg.family`` on ``device`` (the card unless
    ``device="cpu"``).

    ``init`` takes a ``torch.Generator`` on that device; its draws cannot
    match JAX's threefry, only the distributions do.  The batch's tensors
    given to ``loss``/``prefill``/``decode`` are moved to the device:
    tokens and targets as ``long``, frames and patches in their own float
    dtype.  Under ``ctx.tp`` the model serves a rank's shards (any family;
    ``tp_refusal`` names the head counts it refuses), under ``ctx.fsdp``,
    ``ctx.dp`` and ``ctx.kv_seq`` a data-parallel rank's.  Its ``loss``
    raises where ``loss_refusal`` says why the rank cannot train.
    """

    fam = cfg.family
    if fam not in _FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    init, loss, prefill, decode, init_cache, extra = _FAMILIES[fam]
    ctx = ctx or T.Ctx()
    device = resolve_device(device)
    reason = tp_refusal(cfg, ctx.tp_size)
    if reason:
        raise NotImplementedError(reason)
    refusal = loss_refusal(cfg, ctx)
    if refusal:
        def loss(*_):
            raise NotImplementedError(refusal)

    def tokens(x):
        return torch.as_tensor(x, device=device).long()

    def floats(x):
        return torch.as_tensor(x, device=device)

    def inputs(b):
        return [floats(b[name]) for name in extra] + [tokens(b["tokens"])]

    return Model(
        cfg, ctx, device,
        init=lambda gen: init(gen, cfg, ctx, device),
        loss=lambda p, b: loss(p, *inputs(b), tokens(b["targets"]), cfg,
                               ctx),
        prefill=lambda p, b, ml: prefill(p, *inputs(b), ml, cfg, ctx),
        decode=lambda p, c, tok, pos: decode(p, c, tokens(tok), int(pos),
                                             cfg, ctx),
        init_cache=lambda bs, ml: init_cache(cfg, ctx, bs, ml, device),
    )


# ---------------------------------------------------------------------------
# Shapes without allocation (the ``meta`` device) and parameter counts
# ---------------------------------------------------------------------------


def _on_meta(model: Model) -> Model:
    """``model`` built on the ``meta`` device without its TP group and its
    KV positions' group, so its trees have their global shapes and
    allocate nothing."""

    return build_model(model.cfg, dataclasses.replace(model.ctx, tp=None,
                                                      kv_seq=None),
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of ``loss`` (train) or ``prefill`` as ``meta`` tensors
    of its shapes and dtypes (the JAX package's ShapeDtypeStructs)."""

    B, Lx = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    batch: dict = {}
    if cfg.family == "encdec":
        batch["frames"] = sds((B, cfg.encoder_seq_len, cfg.d_model),
                              torch.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = sds((B, cfg.num_patch_tokens, V._VISION_DIM),
                               torch.bfloat16)
    batch["tokens"] = sds((B, Lx), torch.int32)
    if shape.kind == "train":
        batch["targets"] = sds((B, Lx), torch.int32)
    return batch


def cache_specs(model: Model, batch_size: int, max_len: int):
    """The global cache tree of ``model.init_cache`` on ``meta``."""

    return _on_meta(model).init_cache(batch_size, max_len)


def param_specs(model: Model, seed: int = 0):
    """The global parameter tree of ``model.init`` on ``meta``."""

    return _on_meta(model).init(torch.Generator().manual_seed(seed))


def _count(tree, skip_embed: bool) -> int:
    total = 0
    for name, leaf in tree_flatten_with_path(tree):
        if skip_embed and ("embed" in name or "dec_pos" in name):
            continue
        total += math.prod(leaf.shape)
    return total


def param_count(cfg: ModelConfig) -> int:
    shapes = param_specs(build_model(cfg, device="meta"))
    return _count(shapes, skip_embed=False)


def matmul_param_count(cfg: ModelConfig) -> int:
    """Params that participate in matmuls per token (6·N·D convention):
    excludes embedding lookups, *includes* the unembedding projection
    (for tied embeddings the matmul still happens)."""

    shapes = param_specs(build_model(cfg, device="meta"))
    n = _count(shapes, skip_embed=True)
    n += cfg.vocab_size * cfg.d_model          # unembed matmul
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """matmul params with routed experts rescaled by k/E."""

    shapes = param_specs(build_model(cfg, device="meta"))
    if cfg.moe is None:
        return matmul_param_count(cfg)
    total = 0
    frac = cfg.moe.num_experts_per_tok / cfg.moe.num_experts
    for name, leaf in tree_flatten_with_path(shapes):
        if "embed" in name or "dec_pos" in name:
            continue
        size = math.prod(leaf.shape)
        if "moe" in name and name.split("'")[-2] in ("wi_gate", "wi_up", "wo"):
            size = int(size * frac)
        total += size
    return total + cfg.vocab_size * cfg.d_model
