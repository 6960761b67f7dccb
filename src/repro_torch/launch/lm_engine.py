"""LM serving steps (port of ``repro.launch.lm_engine``): prefill and
single-token decode on a rank of a ``pod x data x model`` grid, and a
batched greedy loop.

``make_serve_step``/``make_prefill_step`` return ``(step, info)`` as the
JAX package's do, with its ``info`` keys (``pspecs``, ``cspecs``,
``cache_shapes``, ``bspecs``, ``max_len``; the specs from
``train/sharding.py``, the shapes global).  Where the JAX step is one
program over the mesh, the port's runs on one rank of a
``torch.distributed`` group of ``pod x data x model`` ranks (the whole
default group; rank = (pod·D + data)·M + model, ``train/shard.py::
grid_coords``).  Each rank makes its subgroups once
(``grid_groups``): its model group (the ``TP`` of its data row), its
FSDP group (the ``data`` ranks of its pod at its model coordinate), its
batch group (every ``pod x data`` rank at its model coordinate) and its
cross-pod group (the ranks of its data and model coordinates in every
pod, over which a training step sums the FSDP shards' gradients).  The
step takes the rank's parameter shards (``train/shard.py``) and cache
shard; it cuts the global batch (prefill) or tokens (decode) it is given
to the rank's slice by ``bspecs`` and the token spec, runs the rank's
model, and returns the full (B, V) logits, all-gathered over the batch
group so that every rank holds them (the JAX step replicates them), and
its cache shard.  Under FSDP the rank's model gathers each unit's weights
over its FSDP group just before the unit (``models/layers.py::FSDP``).
A MoE model's experts are padded to the model axis (``with_ep``) and
split by expert over the ranks of a data row, which run the psum or a2a
form on that row's tokens; MLA's latent cache is whole on every model
rank, and so are Mamba2's ``conv_B``/``conv_C`` registers, which the
rules split on ``d_state`` (``info["cspecs"]`` is the layout the rank
holds: ``train/shard.py::rank_cache_pspecs``).  Where the KV heads do
not divide the model ranks the rules cut the attention caches on their
sequence, or keep them whole: the rank's model takes that layout from
the specs (``train/shard.py::kv_cache_layout``, its ``TP.kv_cache``).
Decode writes the cache shard in place: the port's form of
``donate_argnums=(1,)``.  On one rank (no group) the step is the
model's own.  A batch that does not split over ``pod x data`` (the
``long_500k`` cell's B = 1) is not cut: every rank runs it whole and
returns its own logits, and where the rules then cut the KV caches'
positions on ``"data"`` the rank's model holds its data group's slice of
them (``Ctx.kv_seq``, the FSDP group's ranks).  ``train/shard.py::
check_mesh`` refuses the grids this does not cover (the encoder-decoder
family on more than one ``pod x data`` rank, MLA's latent cache at a
batch that does not split).

``ServeLoop`` runs one prefill, then one cached decode step per generated
token, every slot of the batch at the same position.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig, ShapeConfig
from repro_torch.models.api import (Model, build_model, cache_specs,
                                    input_specs, param_specs, tp_refusal)
from repro_torch.models.layers import FSDP, TP, all_gather
from repro_torch.optim.optimizers import tree_map_with_path
from repro_torch.train import sharding as S
from repro_torch.train.shard import (batch_splits, check_mesh, dp_size,
                                     fsdp_split, grid_coords,
                                     kv_cache_layout, local_shape,
                                     model_split, rank_cache_pspecs,
                                     shard_leaf)

# (id of the world group, pod, data, model) -> the groups every rank made
_GROUPS: dict = {}


def grid_groups(group, mesh_cfg: MeshConfig) -> tuple:
    """(model group, FSDP group, batch group, cross-pod group) of this
    rank of ``group``, a ``pod x data x model`` grid that must be the
    whole default group; ``None`` for a group of one rank.  The cross-pod
    group is the ranks of the rank's (data, model) coordinates in every
    pod, which hold the same FSDP shards.  Every rank makes every subgroup
    once, in one fixed order (``dist.new_group`` asks it of all ranks):
    the model groups by (pod, data), the FSDP groups by (pod, model), the
    batch groups by model, the cross-pod groups by (data, model); a group
    of the same ranks as one made before is that one.  Without a ``pod x
    data`` axis the model group is ``group`` itself and no subgroup is
    made."""

    P, D, M = mesh_cfg.pod, mesh_cfg.data, mesh_cfg.model
    n = P * D * M
    if dist.get_world_size(group) != n:
        raise ValueError(f"the group has {dist.get_world_size(group)} "
                         f"ranks, the grid {P} x {D} x {M}")
    if P * D == 1:
        return group, None, None, None
    if dist.get_process_group_ranks(group) != list(range(
            dist.get_world_size())):
        raise ValueError("a pod x data x model grid of ranks is the whole "
                         "default process group")
    key = (id(group), P, D, M)
    if key not in _GROUPS:
        made: dict = {}

        def make(ranks):
            ranks = tuple(ranks)
            if len(ranks) > 1 and ranks not in made:
                made[ranks] = dist.new_group(list(ranks))
            return made.get(ranks)

        models = {(p, d): make((p * D + d) * M + m for m in range(M))
                  for p in range(P) for d in range(D)}
        fsdps = {(p, m): make((p * D + d) * M + m for d in range(D))
                 for p in range(P) for m in range(M)}
        batches = {m: make(r for r in range(n) if r % M == m)
                   for m in range(M)}
        pods = {(d, m): make((p * D + d) * M + m for p in range(P))
                for d in range(D) for m in range(M)}
        _GROUPS[key] = (group, models, fsdps, batches, pods)
    _, models, fsdps, batches, pods = _GROUPS[key]
    c = grid_coords(mesh_cfg, dist.get_rank(group))
    return (models[c["pod"], c["data"]], fsdps[c["pod"], c["model"]],
            batches[c["model"]], pods[c["data"], c["model"]])


@dataclasses.dataclass
class Grid:
    """A rank's place on the grid, as its steps use it: the mesh, its
    rank, and the ``TP`` of its batch group, over which the steps cut the
    batch and all-gather the logits (``None`` without a ``pod x data``
    axis, or where the batch does not split over it: every rank then runs
    the whole batch)."""

    mesh_cfg: MeshConfig
    rank: int
    batch: TP | None = None

    def local(self, x, spec):
        """The rank's slice of ``x`` (the global batch's leaf or tokens)
        under ``spec``; ``x`` itself without a batch group."""

        if self.batch is None:
            return x
        return shard_leaf(x, spec, self.mesh_cfg, self.rank)

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        """The batch group's logits in rank order: the full (B, V); the
        rank's own without a batch group."""

        return all_gather(logits, self.batch, 0)

    def rows(self, batch: int) -> int:
        """The rows of a global batch of ``batch`` that the rank runs."""

        return batch if self.batch is None else batch // self.batch.size


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
                pspecs, cshapes, cspecs, batch: int) -> tuple[Model, Grid]:
    """``model`` on this rank's shards and its ``Grid``: rebuilt with its
    model group's ``TP`` (the leaves ``pspecs`` split on ``"model"``,
    ``model_split``, and the KV cache layout of ``cspecs`` on that axis,
    ``kv_cache_layout``), its FSDP group's ``FSDP`` (the leaves they
    split on ``"data"``, ``fsdp_split``), the batch axes where the batch
    splits over them, and, where ``cspecs`` cut the KV positions on
    ``"data"``, a ``TP`` of the FSDP group's ranks as ``Ctx.kv_seq``;
    refusing what the port does not shard; or itself on one rank."""

    check_mesh(mesh_cfg, model.cfg, batch)
    if mesh_cfg.num_devices == 1:
        return model, Grid(mesh_cfg, 0)
    if mesh_cfg.model > 1:
        reason = tp_refusal(model.cfg, mesh_cfg.model)
        if reason:
            raise NotImplementedError(reason)
    if group is None:
        raise ValueError(f"a {mesh_cfg.pod} x {mesh_cfg.data} x "
                         f"{mesh_cfg.model} grid of ranks needs its process "
                         "group")
    model_group, fsdp_group, batch_group, _ = grid_groups(group, mesh_cfg)
    device = model.device
    tp = fsdp = kv_seq = None
    if mesh_cfg.model > 1:
        tp = TP.of(model_group, device, model_split(shapes, pspecs),
                   kv_cache_layout(cshapes, cspecs))
    split = fsdp_split(shapes, pspecs) if mesh_cfg.data > 1 else {}
    if split:
        fsdp = FSDP.of(fsdp_group, device, split)
    if mesh_cfg.data > 1 and kv_cache_layout(cshapes, cspecs,
                                             "data") == "sequence":
        kv_seq = TP.of(fsdp_group, device)
    data_parallel = dp_size(mesh_cfg) > 1 and batch_splits(mesh_cfg, batch)
    ctx = dataclasses.replace(
        model.ctx, tp=tp, fsdp=fsdp, kv_seq=kv_seq,
        dp=S.dp_axes(mesh_cfg) if data_parallel else None)
    grid = Grid(mesh_cfg, dist.get_rank(group),
                TP.of(batch_group, device) if data_parallel else None)
    return build_model(model.cfg, ctx, device=device), grid


def _check_cache(rank_model: Model, cshapes, cspecs, mesh_cfg: MeshConfig,
                 batch: int, max_len: int) -> None:
    """Refuse a cache whose specs (``rank_cache_pspecs``) do not cut it as
    the rank's model holds it at its ``batch`` rows (its KV heads or its
    slice of the positions, its Mamba heads).  The rules find the batch
    dim as the first dim equal to the global batch size, so a stacking dim
    of that size takes the batch's place and the heads' ``"model"`` lands
    on the batch: GSPMD reshards such a layout, the port's ranks do
    not."""

    if mesh_cfg.num_devices == 1:
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


def _dp_or_none(mesh_cfg: MeshConfig, batch: int):
    return S.dp_axes(mesh_cfg) if batch_splits(mesh_cfg, batch) else None


def _setup(model: Model, group, mesh_cfg: MeshConfig,
           shape_cfg: ShapeConfig, max_len: int):
    """Both steps' common part: the rank's model and grid, the specs, the
    cache's global shapes and the rank's cache specs."""

    cfg = model.cfg
    B = shape_cfg.global_batch
    shapes = param_specs(model)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    cshapes = cache_specs(model, B, max_len)
    cspecs = rank_cache_pspecs(
        cshapes, S.cache_pspecs_tree(cfg, shape_cfg, mesh_cfg, cshapes))
    rank_model, grid = _rank_model(model, group, mesh_cfg, shapes, pspecs,
                                   cshapes, cspecs, B)
    _check_cache(rank_model, cshapes, cspecs, mesh_cfg, grid.rows(B),
                 max_len)
    return rank_model, grid, pspecs, cshapes, cspecs


def make_serve_step(model: Model, group, mesh_cfg: MeshConfig,
                    shape_cfg: ShapeConfig):
    """One-token decode with a ``seq_len``-deep cache (a VLM's also holds
    its patch tokens): ``step(params, cache, token, pos) -> (logits,
    cache)`` on this rank's shards, ``token`` the global (B,) tokens and
    ``logits`` the full (B, V)."""

    model = with_ep(model, mesh_cfg)
    max_len = _max_len(model, shape_cfg)
    rank_model, grid, pspecs, cshapes, cspecs = _setup(
        model, group, mesh_cfg, shape_cfg, max_len)
    tok_spec = S.P(_dp_or_none(mesh_cfg, shape_cfg.global_batch))

    def serve_step(params, cache, token, pos):
        with torch.inference_mode():
            logits, cache = rank_model.decode(
                params, cache, grid.local(token, tok_spec), pos)
            return grid.gather(logits), cache

    return serve_step, {"pspecs": pspecs, "cspecs": cspecs,
                        "cache_shapes": cshapes, "max_len": max_len,
                        "model": rank_model, "grid": grid}


def make_prefill_step(model: Model, group, mesh_cfg: MeshConfig,
                      shape_cfg: ShapeConfig, max_len: int | None = None):
    """``step(params, batch) -> (last-position logits (B, V), cache
    shard)`` on this rank's shards, ``batch`` the global batch, the cache
    ``max_len`` deep."""

    model = with_ep(model, mesh_cfg)
    max_len = max_len or _max_len(model, shape_cfg)
    rank_model, grid, pspecs, cshapes, cspecs = _setup(
        model, group, mesh_cfg, shape_cfg, max_len)
    bspecs = S.batch_pspecs(model.cfg, shape_cfg, mesh_cfg,
                            input_specs(model.cfg, shape_cfg))

    def prefill_step(params, batch):
        with torch.inference_mode():
            local = {k: grid.local(v, bspecs[k]) if k in bspecs else v
                     for k, v in batch.items()}
            logits, cache = rank_model.prefill(params, local, max_len)
            return grid.gather(logits), cache

    return prefill_step, {"pspecs": pspecs, "bspecs": bspecs,
                          "cspecs": cspecs, "cache_shapes": cshapes,
                          "max_len": max_len, "model": rank_model,
                          "grid": grid}


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
