"""LM serving steps (port of ``repro.launch.lm_engine``): tensor-parallel
prefill and single-token decode on a rank, and a batched greedy loop.

``make_serve_step``/``make_prefill_step`` return ``(step, info)`` as the
JAX package's do, with its ``info`` keys (``pspecs``, ``cspecs``,
``cache_shapes``, ``bspecs``, ``max_len``; the specs from
``train/sharding.py``, the shapes global).  Where the JAX step is one
program over the mesh, the port's runs on one rank of a ``torch.distributed``
group of ``mesh_cfg.model`` ranks: it takes that rank's parameter shards
(``train/shard.py``) and cache shard and returns the full (B, V) logits,
which every rank holds (the JAX step replicates them), and its cache
shard.  A MoE model's experts are padded to the model axis
(``with_ep``) and split by expert over its ranks; MLA's latent cache is
whole on every rank, and so are Mamba2's ``conv_B``/``conv_C``
registers, which the rules split on ``d_state`` (``info["cspecs"]`` is
the layout the rank holds: ``train/shard.py::rank_cache_pspecs``).  Where
the KV heads do not divide the ranks the rules cut the attention caches
on their sequence, or keep them whole: the rank's model takes that
layout from the specs (``train/shard.py::kv_cache_layout``, its
``TP.kv_cache``).
Decode writes the cache shard in place: the port's form of
``donate_argnums=(1,)``.  Without a group
(``mesh_cfg.model == 1``) the step is the model's own.

``ServeLoop`` runs one prefill, then one cached decode step per generated
token, every slot of the batch at the same position.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.config import MeshConfig, ShapeConfig
from repro_torch.models.api import (Model, build_model, cache_specs,
                                    input_specs, param_specs, tp_refusal)
from repro_torch.models.layers import TP
from repro_torch.optim.optimizers import tree_map_with_path
from repro_torch.train import sharding as S
from repro_torch.train.shard import (check_mesh, kv_cache_layout,
                                     local_shape, model_split,
                                     rank_cache_pspecs)


def with_ep(model: Model, mesh_cfg: MeshConfig) -> Model:
    """``model`` with its experts padded to a multiple of the model axis
    where it is a MoE model on more than one rank and pads nothing yet, as
    the JAX launcher builds it (``ep_pad_to=mesh_cfg.model``); else
    itself."""

    if (model.cfg.moe is None or mesh_cfg.model == 1
            or model.ctx.ep_pad_to):
        return model
    return build_model(model.cfg, dataclasses.replace(
        model.ctx, ep_pad_to=mesh_cfg.model), device=model.device)


def _rank_model(model: Model, group, mesh_cfg: MeshConfig, shapes,
                pspecs, cshapes, cspecs) -> Model:
    """``model`` on this rank's shards: rebuilt with the group's ``TP``,
    the leaves ``pspecs`` split (``model_split``) and the KV cache layout
    of ``cspecs`` (``kv_cache_layout``), refusing what the port does not
    shard; or itself on one rank."""

    check_mesh(mesh_cfg)
    if mesh_cfg.model == 1:
        return model
    reason = tp_refusal(model.cfg, mesh_cfg.model)
    if reason:
        raise NotImplementedError(reason)
    if group is None:
        raise ValueError(f"a {mesh_cfg.model}-rank model axis needs its "
                         "process group")
    tp = TP.of(group, model.device, model_split(shapes, pspecs),
               kv_cache_layout(cshapes, cspecs))
    if tp.size != mesh_cfg.model:
        raise ValueError(f"the group has {tp.size} ranks, the model axis "
                         f"{mesh_cfg.model}")
    return build_model(model.cfg, dataclasses.replace(model.ctx, tp=tp),
                       device=model.device)


def _check_cache(rank_model: Model, cshapes, cspecs, mesh_cfg: MeshConfig,
                 batch: int, max_len: int) -> None:
    """Refuse a cache whose specs (``rank_cache_pspecs``) do not cut it as
    the rank's model holds it (its KV heads or its slice of the positions,
    its Mamba heads).  The rules find
    the batch dim as the first dim
    equal to the batch size, so a stacking dim of that size takes the
    batch's place and the heads' ``"model"`` lands on the batch: GSPMD
    reshards such a layout, the port's ranks do not."""

    if mesh_cfg.model == 1:
        return
    mine = build_model(rank_model.cfg, rank_model.ctx,
                       device="meta").init_cache(batch, max_len)

    def check(path, x, spec, local):
        if local_shape(x.shape, spec, mesh_cfg) != tuple(local.shape):
            raise NotImplementedError(
                f"the sharding rules cut the cache leaf {path} "
                f"{tuple(x.shape)} as {spec}, not as a rank holds it "
                f"({tuple(local.shape)}): the batch size equals a "
                "stacking dim's, which the rules take for the batch; GSPMD "
                "reshards this layout, the port does not (ROADMAP.md queue "
                "1, item 6.8)")

    tree_map_with_path(check, cshapes, cspecs, mine)


def _max_len(model: Model, shape_cfg: ShapeConfig) -> int:
    cfg = model.cfg
    return shape_cfg.seq_len + (
        cfg.num_patch_tokens if cfg.family == "vlm" else 0)


def make_serve_step(model: Model, group, mesh_cfg: MeshConfig,
                    shape_cfg: ShapeConfig):
    """One-token decode with a ``seq_len``-deep cache (a VLM's also holds
    its patch tokens): ``step(params, cache, token, pos) -> (logits,
    cache)`` on this rank's shards."""

    model = with_ep(model, mesh_cfg)
    cfg = model.cfg
    B = shape_cfg.global_batch
    max_len = _max_len(model, shape_cfg)
    shapes = param_specs(model)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    cshapes = cache_specs(model, B, max_len)
    cspecs = rank_cache_pspecs(
        cshapes, S.cache_pspecs_tree(cfg, shape_cfg, mesh_cfg, cshapes))
    rank_model = _rank_model(model, group, mesh_cfg, shapes, pspecs,
                             cshapes, cspecs)
    _check_cache(rank_model, cshapes, cspecs, mesh_cfg, B, max_len)

    def serve_step(params, cache, token, pos):
        with torch.inference_mode():
            return rank_model.decode(params, cache, token, pos)

    return serve_step, {"pspecs": pspecs, "cspecs": cspecs,
                        "cache_shapes": cshapes, "max_len": max_len,
                        "model": rank_model}


def make_prefill_step(model: Model, group, mesh_cfg: MeshConfig,
                      shape_cfg: ShapeConfig, max_len: int | None = None):
    """``step(params, batch) -> (last-position logits (B, V), cache
    shard)`` on this rank's shards, the cache ``max_len`` deep."""

    model = with_ep(model, mesh_cfg)
    cfg = model.cfg
    B = shape_cfg.global_batch
    max_len = max_len or _max_len(model, shape_cfg)
    shapes = param_specs(model)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    batch_tree = input_specs(cfg, shape_cfg)
    bspecs = S.batch_pspecs(cfg, shape_cfg, mesh_cfg, batch_tree)
    cshapes = cache_specs(model, B, max_len)
    cspecs = rank_cache_pspecs(
        cshapes, S.cache_pspecs_tree(cfg, shape_cfg, mesh_cfg, cshapes))
    rank_model = _rank_model(model, group, mesh_cfg, shapes, pspecs,
                             cshapes, cspecs)
    _check_cache(rank_model, cshapes, cspecs, mesh_cfg, B, max_len)

    def prefill_step(params, batch):
        with torch.inference_mode():
            return rank_model.prefill(params, batch, max_len)

    return prefill_step, {"pspecs": pspecs, "bspecs": bspecs,
                          "cspecs": cspecs, "cache_shapes": cshapes,
                          "max_len": max_len, "model": rank_model}


class ServeLoop:
    """Minimal batched greedy-decode loop."""

    def __init__(self, model: Model, params, batch_size: int, max_len: int):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch_size = batch_size

    def generate(self, batch: dict[str, Any], num_tokens: int):
        """(B, num_tokens) int32 greedy tokens after the prompt
        ``batch["tokens"]`` (B, L).  A VLM's decode positions are absolute
        in its fused sequence: they start after its patch tokens."""

        prompt_len = batch["tokens"].shape[1]
        cfg = self.model.cfg
        extra = cfg.num_patch_tokens if cfg.family == "vlm" else 0
        if extra + prompt_len + num_tokens - 1 > self.max_len:
            raise ValueError(
                f"{extra + prompt_len} prompt positions + {num_tokens} "
                f"tokens do not fit max_len={self.max_len}")
        with torch.inference_mode():
            logits, cache = self.model.prefill(self.params, batch,
                                               self.max_len)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out = [tok]
            start = extra + prompt_len - 1
            for i in range(1, num_tokens):
                logits, cache = self.model.decode(self.params, cache, tok,
                                                  start + i)
                tok = torch.argmax(logits, -1).to(torch.int32)
                out.append(tok)
        return torch.stack(out, dim=1)
