"""A rank's shards of the parameter and cache trees, by the specs of
``train/sharding.py``, on a ``pod x data x model`` grid of ranks, and
sharded initialisation.

A rank's coordinates (pod, data, model) follow the reference mesh's
device order: rank = (pod·D + data)·M + model (``grid_coords``).  A dim
that a spec puts on an axis is cut into that axis's equal contiguous
slices and the rank holds the slice of its coordinate; a dim on several
axes (the batch on ``("pod", "data")``) is cut by their coordinates in
order, the first the slowest, as a JAX ``PartitionSpec`` cuts it.  The
rules put ``"model"`` on the tensor-parallel dim of a weight, ``"data"``
on its other matrix dim where FSDP is on (``MeshConfig.fsdp``), and
``("pod", "data")`` on the batch of the inputs and caches; ``"pod"``
never carries weights.  A batch that does not split over ``pod x data``
(the ``long_500k`` cell's B = 1) stays whole on every rank, and the rules
then cut the attention KV caches' sequence on ``"data"``.  ``check_mesh``
refuses what the serving ranks do not cover, naming its ROADMAP item: the
encoder-decoder family on more than one ``pod x data`` rank (item
6.8.2c) and MLA's latent cache at a batch that does not split, which the
rules cut on ``"data"`` (item 6.8.2e).  ``check_train_mesh`` refuses
what the training ranks do not cover: a family other than the dense and
MoE ones on more than one rank (item 6.2c), the MoE family's a2a form on
model ranks (item 6.2c-i-b), query heads that do not split over the
model ranks (item 6.8), and microbatch parts whose rows do not split
over ``pod x data``; KV heads that do not divide the model ranks train
(``whole_kv`` names the k/v leaves a rank then holds whole, and MLA's
latent leaves, which a rank always holds whole).

``fsdp_split`` names the leaves the specs split on ``"data"``, and the
dim, by the top-level key whose subtree a rank gathers at once (the
stacked ``"units"``, a head sublayer ``"head0"``, the VLM's
``"projector"``): a rank's model gathers them over its FSDP group just
before it runs that unit (``models/layers.py::FSDP``).  ``shard_params``
and ``init_shard`` lay a rank's FSDP shards of one such key and dtype
out in one buffer, unit after unit, so that a unit's shards are one
contiguous run of memory and its gather one collective.

``init_shard(seed, cfg, ctx, mesh_cfg, rank, device)`` draws a rank's
slices of any family's parameter tree without the whole tree ever
existing: each leaf is drawn one stacked layer at a time (an expert leaf
one expert at a time, the rank's experts only) from a generator keyed by
(seed, leaf path, layer[, expert]), cut to the rank's slice, and
dropped, so at most one full layer of one leaf is on the device at a
time (internvl2-76b's ``embed``, 4.2 GB, is the largest).  The draws
follow ``init``'s distributions but not its values: normal with std
1/sqrt(fan-in) (the embeddings 1/sqrt(d_model); zamba2's ``lora_a`` and
whisper's ``dec_pos`` 0.01), RMSNorm offsets, biases and ``lora_b``
zero, LayerNorm scales one; Mamba2's ``A_log`` is log(linspace(1, 16,
heads)), its ``D`` one, its ``dt_bias`` the inverse softplus of a
log-uniform dt in [1e-3, 1e-1], one draw a head.  The shards at any
grid are, rank by rank, the slices of the tree at ``1 x 1 x 1``, bit for
bit; experts padded for the axis (``Ctx.ep_pad_to``) are drawn like the
others, after them.

A rank's cache is cut by the rules' cache specs, except for the leaves of
``WHOLE_CACHE`` (``rank_cache_pspecs``).  Where the KV heads do not
divide the model axis the rules cut the attention caches on their
sequence (or keep them whole where the length does not divide either),
and at a batch that does not split they cut the sequence on ``"data"``
where ``"model"`` left it whole: ``kv_cache_layout`` reads both from the
specs, axis by axis, the one place the port decides them.  The rank's
model takes the ``"model"`` layout as ``TP.kv_cache`` and a ``"data"``
cut as ``Ctx.kv_seq``, the group of the data ranks of its pod at its
model coordinate; the pods hold the same positions.
"""

from __future__ import annotations

import hashlib
import itertools
import math
import re

import torch

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.models import api
from repro_torch.models.layers import leaf_at
from repro_torch.models.transformer import Ctx
from repro_torch.optim.optimizers import tree_leaves, tree_map_with_path
from repro_torch.train import sharding as S

GRID_ITEM = "ROADMAP.md queue 1, item 6.8.2"
FAMILY_REASON = (
    "the {family} family on {dp} pod x data ranks: the port serves the "
    "dense, VLM, MoE, SSM and hybrid families data parallel; the "
    "encoder-decoder serves on the model axis only "
    f"({GRID_ITEM}c)")
MLA_REASON = (
    "MLA's latent cache at a batch of {batch}, which does not split over "
    "the {dp} pod x data ranks: the sharding rules then cut c_kv and "
    "k_rope on their sequence over 'data', and the port's MLA decode "
    f"holds its latent cache whole ({GRID_ITEM}e)")
DATA_PARALLEL_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")

# cache leaves a rank holds whole over "model" where the rules split them
# there: Mamba2's B and C conv registers, which the rules split on
# d_state.  A rank's w_B/w_C and B/C convs are whole (the rules keep them
# so), so it computes the whole B and C and needs their whole windows: the
# port holds the registers whole on every model rank and updates them
# redundantly
WHOLE_CACHE = ("conv_B", "conv_C")


def dp_size(mesh_cfg: MeshConfig) -> int:
    """Ranks on the batch axes, ``("pod", "data")`` or ``("data",)``."""

    return mesh_cfg.pod * mesh_cfg.data


def check_mesh(mesh_cfg: MeshConfig, cfg: ModelConfig | None = None,
               batch: int | None = None) -> None:
    """Refuse a grid the serving ranks do not cover: a ``pod`` axis off a
    multi-pod mesh (``ValueError``: the reference's mesh has none), and,
    on more than one ``pod x data`` rank, a family other than
    ``DATA_PARALLEL_FAMILIES`` (item 6.8.2c) or an MLA model at a
    ``batch`` that does not split over those ranks (item 6.8.2e).  Any
    other batch that does not split is served whole on every rank."""

    sizes = (mesh_cfg.pod, mesh_cfg.data, mesh_cfg.model)
    if min(sizes) < 1:
        raise ValueError(f"axis sizes (pod, data, model) {sizes} must be "
                         "at least 1")
    if mesh_cfg.pod > 1 and not mesh_cfg.multi_pod:
        raise ValueError(f"pod = {mesh_cfg.pod} on a mesh without its pod "
                         "axis: set multi_pod=True, as multi_pod_config does")
    dp = dp_size(mesh_cfg)
    if dp == 1 or cfg is None:
        return
    if cfg.family not in DATA_PARALLEL_FAMILIES:
        raise NotImplementedError(FAMILY_REASON.format(family=cfg.family,
                                                       dp=dp))
    if cfg.mla is not None and batch is not None and batch % dp:
        raise NotImplementedError(MLA_REASON.format(batch=batch, dp=dp))


def check_train_mesh(mesh_cfg: MeshConfig, cfg: ModelConfig,
                     batch: int | None = None, microbatch: int = 0,
                     moe_impl: str = "psum") -> None:
    """``check_mesh``'s training twin: refuse a grid the training ranks do
    not cover, a family other than the dense and MoE ones on more than
    one rank (item 6.2c), model ranks over which the query heads do not
    split (item 6.8, ``api.tp_train_refusal``; the KV heads need not) or
    on which the MoE family would train in the a2a form (item 6.2c-i-b;
    the psum form trains, its experts split by expert, ``model_split``
    refusing them split on their width), and (``ValueError``) a global
    ``batch`` whose ``microbatch`` parts (one without) do not each split
    over the ``pod x data`` ranks: a rank runs its rows of each part, as
    the rules cut the part."""

    check_mesh(mesh_cfg)
    if (mesh_cfg.num_devices > 1
            and cfg.family not in api.TRAIN_FAMILIES):
        raise NotImplementedError(
            api.FAMILY_TRAIN_REASON.format(family=cfg.family))
    reason = api.tp_train_refusal(cfg, mesh_cfg.model, moe_impl)
    if reason:
        raise NotImplementedError(reason)
    if batch is None:
        return
    parts, dp = max(microbatch, 1), dp_size(mesh_cfg)
    if batch % parts or (batch // parts) % dp:
        raise ValueError(
            f"a batch of {batch} in {parts} microbatch part(s) does not "
            f"split over the {dp} pod x data ranks: each part's rows are "
            "cut over them")


def batch_splits(mesh_cfg: MeshConfig, batch: int) -> bool:
    """Whether the rules cut a batch of ``batch`` over the ``pod x data``
    ranks (``batch_pspecs``, ``cache_pspecs_tree``); where it does not,
    every rank holds it whole."""

    return batch % dp_size(mesh_cfg) == 0


def grid_coords(mesh_cfg: MeshConfig, rank: int) -> dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: rank = (pod·D + data)·M +
    model, the reference mesh's device order."""

    M, D = mesh_cfg.model, mesh_cfg.data
    if not 0 <= rank < mesh_cfg.num_devices:
        raise ValueError(f"rank {rank} is not on a {mesh_cfg.pod} x "
                         f"{mesh_cfg.data} x {mesh_cfg.model} grid")
    return {"pod": rank // (D * M), "data": rank // M % D,
            "model": rank % M}


def _axes(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _sizes(mesh_cfg: MeshConfig) -> dict[str, int]:
    return {"model": mesh_cfg.model, "data": mesh_cfg.data,
            "pod": mesh_cfg.pod}


def _parts(entry, mesh_cfg: MeshConfig) -> int:
    """How many ways a spec entry cuts its dim."""

    return math.prod(_sizes(mesh_cfg)[a] for a in _axes(entry))


def _part(entry, mesh_cfg: MeshConfig, coords: dict[str, int]) -> int:
    """Which of those parts a rank of ``coords`` holds: the axes' mixed-
    radix index, the first the slowest."""

    sizes, index = _sizes(mesh_cfg), 0
    for a in _axes(entry):
        index = index * sizes[a] + coords[a]
    return index


def local_shape(shape, spec, mesh_cfg: MeshConfig) -> tuple[int, ...]:
    """A rank's shape of a leaf of global ``shape`` under ``spec``."""

    check_mesh(mesh_cfg)
    out = []
    for n, entry in zip(shape, spec):
        parts = _parts(entry, mesh_cfg)
        if n % parts:
            raise ValueError(f"dim {n} does not split {parts} ways ({spec})")
        out.append(n // parts)
    return tuple(out)


def _slice(x: torch.Tensor, spec, mesh_cfg: MeshConfig,
           rank: int) -> torch.Tensor:
    coords = grid_coords(mesh_cfg, rank)
    index = []
    for n, m, entry in zip(x.shape, local_shape(x.shape, spec, mesh_cfg),
                           spec):
        i = _part(entry, mesh_cfg, coords)
        index.append(slice(None) if n == m else slice(i * m, (i + 1) * m))
    return x[tuple(index)]


def shard_leaf(x, spec, mesh_cfg: MeshConfig, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` (a tensor or an array) under
    ``spec`` (a copy)."""

    return _slice(torch.as_tensor(x), spec, mesh_cfg, rank).clone()


def _keys(path: str) -> tuple[str, ...]:
    return tuple(re.findall(r"\['([^']+)'\]", path))


def fsdp_split(shapes, pspecs) -> dict[str, dict[tuple, int]]:
    """The leaves ``pspecs`` split on ``"data"`` (FSDP), by the top-level
    key a rank gathers them under (``"units"``, ``"head0"``,
    ``"projector"``): ``{key: {path below it as keys: dim}}``, the dim
    counted from the end (``-2``: the rows of a (in, out) matrix), in the
    tree's order; empty without FSDP.  The one place the port decides
    which leaves a rank gathers over its FSDP group, the counterpart of
    ``model_split``.  Refuses a top-level leaf split on ``"data"`` (the
    rules keep the embeddings and ``lm_head`` on ``"model"`` only), a leaf
    split on it twice, and ``"pod"`` on a weight."""

    out: dict[str, dict[tuple, int]] = {}
    bad = []

    def visit(path, x, spec):
        on = [i for i, e in enumerate(spec) if "data" in _axes(e)]
        keys = _keys(path)
        if any("pod" in _axes(e) for e in spec) or len(on) > 1 or (
                on and len(keys) < 2):
            bad.append(path)
        elif on:
            out.setdefault(keys[0], {})[keys[1:]] = on[0] - len(spec)

    tree_map_with_path(visit, shapes, pspecs)
    if bad:
        raise NotImplementedError(
            f"the sharding rules split {bad} on the data axis in a way the "
            "port's FSDP gathers do not follow: a top-level leaf, two dims "
            f"of one leaf, or a weight on 'pod' ({GRID_ITEM})")
    return out


def _fsdp_views(shapes, pspecs, mesh_cfg: MeshConfig, device) -> dict:
    """``{path: empty view}`` for a rank's FSDP shards of the leaves of
    ``shapes`` (tensors of any device): one buffer a top-level key and
    dtype, ``(n_scan, total)`` for the stacked ``"units"`` (a unit's
    shards one contiguous row, leaf after leaf), ``(total,)`` otherwise;
    empty at ``data = 1``."""

    if mesh_cfg.data == 1:
        return {}
    views = {}
    for top, leaves in fsdp_split(shapes, pspecs).items():
        by_dtype: dict = {}
        for keys in leaves:
            x = leaf_at(shapes[top], keys)
            spec = leaf_at(pspecs[top], keys)
            by_dtype.setdefault(x.dtype, []).append(
                (keys, local_shape(x.shape, spec, mesh_cfg)))
        stacked = top == "units"
        for dtype, items in by_dtype.items():
            lead = items[0][1][:1] if stacked else ()
            if any(shape[:len(lead)] != lead for _, shape in items):
                raise ValueError(f"the stacked FSDP leaves of {top!r} do not "
                                 "share their stacking dim")
            size = [math.prod(shape[len(lead):]) for _, shape in items]
            buf = torch.empty(lead + (sum(size),), dtype=dtype,
                              device=device)
            at = 0
            for (keys, shape), n in zip(items, size):
                path = f"['{top}']" + "".join(f"['{k}']" for k in keys)
                views[path] = buf[..., at:at + n].view(shape)
                at += n
    return views


def shard_params(params, pspecs, mesh_cfg: MeshConfig, rank: int,
                 device=None):
    """Rank ``rank``'s slices of a parameter tree (``param_pspecs``), its
    FSDP shards laid out unit by unit in one buffer (``_fsdp_views``), on
    ``device`` (the tree's by default: a whole tree read from a
    checkpoint on the host is sliced there and only the slices moved)."""

    if device is None:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
    views = _fsdp_views(params, pspecs, mesh_cfg, device)

    def leaf(path, x, spec):
        part = _slice(x, spec, mesh_cfg, rank)
        if path in views:
            return views[path].copy_(part)
        return part.to(device, copy=True)

    return tree_map_with_path(leaf, params, pspecs)


def _off_model(entry):
    """A spec entry without the ``"model"`` axis."""

    axes = tuple(a for a in _axes(entry) if a != "model")
    return None if not axes else axes[0] if len(axes) == 1 else axes


def rank_cache_pspecs(cshapes, cspecs):
    """The specs a rank holds its cache of ``cshapes`` by: the rules'
    (``cache_pspecs_tree``), with the leaves of ``WHOLE_CACHE`` whole
    over ``"model"`` (their batch still cut over ``pod x data``)."""

    return tree_map_with_path(
        lambda path, _, spec: S.P(*map(_off_model, spec))
        if S.leaf_name(path) in WHOLE_CACHE else spec, cshapes, cspecs)


# the attention caches' leaves (``KVCache`` fields: (..., B, Hkv, L, D))
KV_LEAVES = ("k", "v")


def kv_cache_layout(cshapes, cspecs, axis: str = "model") -> str:
    """How the rules' ``cspecs`` (the steps' ``info["cspecs"]``) cut the
    attention KV caches on ``axis``.  On ``"model"``: ``"heads"`` where
    they put it on their KV heads, ``"sequence"`` where on their positions
    (the KV heads do not divide the axis: ``cache_pspecs_tree`` cuts the
    sequence instead), ``"whole"`` where on neither; ``"heads"`` for a
    tree without KV caches.  On ``"data"``: ``"sequence"`` where they cut
    the positions on it (a batch that does not split, and ``"model"``
    left the sequence whole), else ``"whole"``.  Refuses caches laid out
    two ways on one axis, and ``"data"`` on the KV heads."""

    seen = set()

    def visit(path, _, spec):
        if S.leaf_name(path) in KV_LEAVES:
            on = [axis in _axes(e) for e in spec]
            seen.add("heads" if on[-3] else
                     "sequence" if on[-2] else "whole")

    tree_map_with_path(visit, cshapes, cspecs)
    if len(seen) > 1 or (axis == "data" and "heads" in seen):
        raise NotImplementedError(
            f"the sharding rules cut the KV caches {sorted(seen)} on "
            f"{axis!r}; the port holds one layout a model, the heads on "
            "'model' only (ROADMAP.md queue 1, item 6.8)")
    return seen.pop() if seen else ("heads" if axis == "model" else
                                     "whole")


def shard_cache(cache, cspecs, mesh_cfg: MeshConfig, rank: int):
    """Rank ``rank``'s slices of a cache tree (by ``rank_cache_pspecs``
    of the rules' specs)."""

    return tree_map_with_path(
        lambda _, x, spec: shard_leaf(x, spec, mesh_cfg, rank), cache,
        cspecs)


def shard_nbytes(shapes, specs, mesh_cfg: MeshConfig) -> int:
    """Bytes of a rank's shards of a tree of (``meta``) shapes."""

    total = []
    tree_map_with_path(
        lambda _, x, spec: total.append(
            math.prod(local_shape(x.shape, spec, mesh_cfg))
            * x.element_size()), shapes, specs)
    return sum(total)


# a row-parallel leaf -> the column-parallel leaves whose output it takes
# (MLA's heads: wq and wkv_b; the q/k/v biases and whisper's MLP bias
# with their weights; Mamba2's head-aligned leaves before its out_proj;
# zamba2's lora_b, cut with the shared block's q/k/v columns); the
# experts' three leaves split together.  w_cat and the hybrid's Mamba
# pre-norm (mamba.norm) are gathered where split, whichever way, and so
# are the LM attention's k/v leaves (_GATHERED) under a split wo: a rank
# whose KV heads are not its own gathers k and v whole, or computes them
# whole from whole leaves (models/attention.py).  _READ_BY_HEAD adds the
# leaves a rank holds whole under a split wo whose output its heads read
# only their share of: those k/v leaves, and MLA's latent (wkv_a, whose
# c_kv and shared rope key every head reads through its wkv_b slice, and
# kv_norm), which the rules never split
_QKV = ("wq", "wk", "wv", "bq", "bk", "bv")
_GATHERED = {"attn.wo": ("attn.wk", "attn.wv", "attn.bk", "attn.bv")}
_READ_BY_HEAD = {"attn.wo": _GATHERED["attn.wo"]
                 + ("attn.wkv_a", "attn.kv_norm")}
_ROW_PARALLEL = {"attn.wo": tuple(f"attn.{w}" for w in _QKV + ("wkv_b",))
                 + ("units.lora_b",),
                 "self_attn.wo": tuple(f"self_attn.{w}" for w in _QKV),
                 "cross_attn.wo": tuple(f"cross_attn.{w}" for w in _QKV),
                 "mlp.wo": ("mlp.wi_gate", "mlp.wi_up", "mlp.wi", "mlp.bi"),
                 "shared.wo": ("shared.wi_gate", "shared.wi_up"),
                 "moe.wo": ("moe.wi_gate", "moe.wi_up"),
                 "ssm.out_proj": tuple(f"ssm.{w}" for w in (
                     "w_z", "w_x", "conv_x", "conv_x_b", "A_log", "D",
                     "dt_bias", "norm")),
                 "projector.w2": ()}
_EXPERTS = ("moe.wi_gate", "moe.wi_up", "moe.wo")


def model_split(shapes, pspecs) -> frozenset:
    """The leaves ``pspecs`` split on ``"model"``, each named by the last
    two keys of its path (``"attn.wo"``, ``"mlp.wo"``, ``"ssm.out_proj"``,
    ``"units.w_cat"``, ``"cross_attn.wo"``; ``"embed"``, ``"tok_embed"``):
    the ``split`` of a rank's ``models.layers.TP``, from which the layers
    decide every collective.  The experts' leaves (``"moe.wi_gate"``,
    ``"moe.wi_up"``, ``"moe.wo"``) are split only on their expert dim:
    their presence means expert parallelism.  Refuses a split the
    explicit collectives do not follow: a leaf split in one layer and
    whole in another, a row-parallel leaf split otherwise than its
    column-parallel inputs (the attention's k/v leaves excepted: whole
    or split under a split ``wo``, they are gathered), experts split on
    their width (the rules' TP-within-expert branch, where the experts
    neither divide the axis nor are padded to it), or the VLM projector's
    ``w1`` split (the port runs it whole)."""

    seen: dict[str, set] = {}
    width_split_experts = []

    def visit(path, _, spec):
        leaf = ".".join(re.findall(r"\['([^']+)'\]", path)[-2:])
        on = ["model" in _axes(e) for e in spec]
        seen.setdefault(leaf, set()).add(any(on))
        if leaf in _EXPERTS and any(on[-2:]):
            width_split_experts.append(leaf)

    tree_map_with_path(visit, shapes, pspecs)
    if width_split_experts:
        raise NotImplementedError(
            "the sharding rules split the experts "
            f"{sorted(set(width_split_experts))} "
            "on their width (TP within an expert): their count neither "
            "divides the model axis nor is padded to it; build the model "
            "with Ctx(ep_pad_to=<model axis>), as the JAX launcher does "
            f"({GRID_ITEM}d)")
    split = frozenset(k for k, v in seen.items() if True in v)
    bad = sorted(k for k, v in seen.items() if len(v) > 1)
    bad += [row for row, cols in _ROW_PARALLEL.items() if any(
        c in seen and (c in split) != (row in split)
        and not (row in split and c in _GATHERED.get(row, ()))
        for c in cols)]
    bad += ["projector.w1"] if "projector.w1" in split else []
    if bad:
        raise NotImplementedError(
            f"the sharding rules split {bad} in a way the port's explicit "
            "collectives do not follow: a whole leaf on every rank, or "
            "row-parallel after column-parallel; GSPMD reshards such a "
            "layout, the port does not (ROADMAP.md queue 1, item 6.8)")
    return split


def whole_kv(shapes, pspecs) -> frozenset:
    """The paths of the leaves a rank holds whole under a row-parallel
    leaf split on ``"model"`` whose output its heads read only their share
    of (``_READ_BY_HEAD``): the attention's k/v leaves where the rules
    keep them whole, their width not dividing the axis, and MLA's latent
    leaves ``wkv_a`` and ``kv_norm``, which they never split.  Each rank
    computes k and v, or the latent and the shared rope key, whole from
    them but reads only its query heads' part (its KV heads; its
    ``wkv_b`` slice), so its gradient of such a leaf is its heads' share,
    and the ranks' sum over the model group is the whole gradient
    (``train/step.py::TrainGrid.reduce``).  Where the rules split the k/v
    leaves, the gather's backward sums the ranks' shares already
    (``layers.all_gather``)."""

    split = model_split(shapes, pspecs)
    whole = {leaf for row, leaves in _READ_BY_HEAD.items() if row in split
             for leaf in leaves if leaf not in split}
    out = []
    tree_map_with_path(
        lambda path, _, __: out.append(path) if ".".join(
            re.findall(r"\['([^']+)'\]", path)[-2:]) in whole else None,
        shapes, pspecs)
    return frozenset(out)


def _key(seed: int, path: str, layer: tuple[int, ...]) -> int:
    digest = hashlib.sha256(f"{seed}|{path}|{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def _std(cfg: ModelConfig, name: str, shape) -> float | None:
    """The std of ``init``'s normal draw of a leaf of this per-layer shape
    (its rule's dims), or ``None`` for a leaf it does not draw from a
    normal (``_fill``, ``_dt_bias``): 1 over the square root of its
    fan-in, dim 1 of an expert leaf (E, in, out), dim 0 of a matrix (the
    router, MLA's projections, the Mamba projections and convs), d_model
    for the embeddings; 0.01 for zamba2's ``lora_a`` and whisper's
    ``dec_pos``."""

    if name in ("lora_a", "dec_pos"):
        return 0.01
    if len(shape) == 1 or name == "lora_b":   # norms, biases, Mamba's heads
        return None
    fan_in = {1: cfg.d_model, 2: shape[0], 3: shape[1]}[
        1 if name in ("embed", "tok_embed") else len(shape)]
    return fan_in ** -0.5


def _fill(name: str, shape) -> torch.Tensor | float:
    """A leaf ``init`` fills without a draw, one layer of it: Mamba2's
    ``A_log`` (float32), ones for its ``D`` and whisper's LayerNorm scales
    ``w``, zeros for the rest (RMSNorm offsets, biases, ``lora_b``)."""

    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1]))
    return 1.0 if name in ("D", "w") else 0.0


def _dt_bias(gen, nheads: int, device) -> torch.Tensor:
    """Mamba2's ``dt_bias`` of one layer: the inverse softplus of a
    log-uniform dt in [1e-3, 1e-1], one draw a head (``ssm.init_ssm``)."""

    u = torch.rand((nheads,), generator=gen, dtype=torch.float32,
                   device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return torch.log(torch.expm1(dt))


def init_shard(seed: int, cfg: ModelConfig, ctx: Ctx | None,
               mesh_cfg: MeshConfig, rank: int, device="cuda") -> dict:
    """Rank ``rank``'s slices of a seeded parameter tree of any family, on
    ``device``; see the module docstring.  ``ctx`` carries the expert
    padding (``Ctx.ep_pad_to``); ``None`` pads nothing."""

    check_mesh(mesh_cfg)
    device = torch.device(device)
    coords = grid_coords(mesh_cfg, rank)
    shapes = api.param_specs(api.build_model(cfg, ctx, device="meta"))
    specs = S.param_pspecs(cfg, shapes, mesh_cfg)
    views = _fsdp_views(shapes, specs, mesh_cfg, device)

    def leaf(path, meta, spec):
        name = S.leaf_name(path)
        k = min(S.rule_ndim(name, path), meta.ndim)
        out = views.get(path)
        if out is None:
            out = torch.empty(local_shape(meta.shape, spec, mesh_cfg),
                              dtype=meta.dtype, device=device)
        std = _std(cfg, name, tuple(meta.shape[-k:]))
        if std is None and name != "dt_bias":
            fill = _fill(name, meta.shape)
            if isinstance(fill, float):
                return out.fill_(fill)
            return out.copy_(_slice(fill, spec[-1:], mesh_cfg, rank))
        # one draw a matrix (a row for dt_bias): an expert leaf's expert
        # dim is drawn expert by expert like a stacking dim, and only the
        # rank's experts are
        n_lead = meta.ndim - min(k, 2)
        ranges = [range(i * m, (i + 1) * m) for i, m in (
            (_part(e, mesh_cfg, coords), m)
            for e, m in zip(spec[:n_lead], out.shape))]
        for layer in itertools.product(*ranges):
            gen = torch.Generator(device=device)
            gen.manual_seed(_key(seed, path, layer))
            if std is None:
                full = _dt_bias(gen, meta.shape[-1], device)
            else:
                full = torch.randn(meta.shape[n_lead:], generator=gen,
                                   dtype=torch.float32,
                                   device=device).mul_(std)
            at = tuple(i - r.start for i, r in zip(layer, ranges))
            out[at] = _slice(full.to(meta.dtype), spec[n_lead:], mesh_cfg,
                             rank)
            del full
        return out

    return tree_map_with_path(leaf, shapes, specs)
