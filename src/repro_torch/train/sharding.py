"""Sharding rules: parameter, cache and batch specs for every family (port
of ``repro.train.sharding``).

The rules are the JAX package's, computed from shapes alone, so they are
held against it exactly.  A spec is a ``P``: a tuple with one entry per
dim, each ``None`` (replicated), an axis name (``"model"``, ``"data"``)
or a tuple of axis names (``("pod", "data")``), as a JAX
``PartitionSpec`` holds them.

Policy (MaxText-style 2-D sharding):

* **TP** over the ``model`` axis: attention heads / flat projection widths,
  FFN hidden, vocab, MoE experts, Mamba heads.
* **FSDP** over the ``data`` axis (optional): the non-TP matrix dim of each
  weight.
* **DP** over ``("pod", "data")``: the batch dim of activations.
* Dims are sharded only when divisible by the axis size; the rules degrade
  to replication, never to invalid shardings.

Rules are expressed on the *trailing* dims of each leaf and padded with
``None`` on the left, so stacked unit params ((n_units, ...) or hybrid's
(n_units, k, ...)) inherit the per-layer rule.  The port serves what
``train/shard.py`` cuts by these specs on every axis; ``models/api.py::
tp_refusal`` and ``train/shard.py::check_mesh`` name what it does not
cover.
"""

from __future__ import annotations

import re
from typing import Any

from repro_torch.config import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.mesh.plan import divides as _div
from repro_torch.mesh.plan import dp_axes
from repro_torch.optim.optimizers import tree_map_with_path


def _canonical(entry):
    """A spec entry as JAX's ``PartitionSpec`` keeps it: a one-axis tuple
    as its axis name, an empty one as ``None``."""

    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


class P(tuple):
    """A partition spec: ``P(None, "data", "model")`` is the tuple
    ``(None, "data", "model")``, entries normalised as JAX's
    ``PartitionSpec`` normalises them, so the two compare entry for
    entry."""

    def __new__(cls, *dims):
        return super().__new__(cls, (_canonical(d) for d in dims))

    def __getnewargs__(self):
        return tuple(self)


class _Rules:
    def __init__(self, cfg: ModelConfig, mesh_cfg: MeshConfig):
        self.cfg = cfg
        self.model = mesh_cfg.model
        self.fsdp = "data" if mesh_cfg.fsdp else None
        self.fsdp_size = mesh_cfg.data if mesh_cfg.fsdp else 0

    def _f(self, dim: int):
        """FSDP axis for this dim, if divisible."""

        return self.fsdp if self.fsdp and _div(dim, self.fsdp_size) else None

    def _m(self, dim: int):
        return "model" if _div(dim, self.model) else None

    def trailing_spec(self, name: str, path: str, shape: tuple[int, ...]):
        m, f = self._m, self._f
        moe = "moe" in path and "shared" not in path
        # vocab tensors: model-axis only (FSDP on their d dim would
        # conflict with the batch's data-axis sharding in the reference)
        if name in ("embed", "tok_embed"):                 # (V, d)
            return (m(shape[0]), None)
        if name == "lm_head":                              # (d, V)
            return (None, m(shape[1]))
        if name == "dec_pos":
            return (None, None)
        if name == "router":                               # (d, E)
            return (f(shape[0]), None)
        if moe and name in ("wi_gate", "wi_up"):           # (E, d, ffe)
            if _div(shape[0], self.model):                 # EP
                return ("model", f(shape[1]), None)
            return (None, f(shape[1]), m(shape[2]))        # TP-within-expert
        if moe and name == "wo":                           # (E, ffe, d)
            if _div(shape[0], self.model):
                return ("model", None, f(shape[2]))
            return (None, m(shape[1]), f(shape[2]))
        if name in ("wq", "wk", "wv", "wi_gate", "wi_up", "wi", "w_z",
                    "w_x", "w_cat", "wkv_b"):              # (in, out_tp)
            return (f(shape[0]), m(shape[1]))
        if name in ("wo", "out_proj", "w2"):               # (tp_in, out)
            return (m(shape[0]), f(shape[1]))
        if name in ("wkv_a", "w_B", "w_C", "w_dt", "w1"):  # (in, small)
            return (f(shape[0]), None)
        if name in ("bq", "bk", "bv", "bi", "conv_x_b", "norm"):
            return (m(shape[0]),)
        if name == "conv_x":                               # (K, d_inner)
            return (None, m(shape[1]))
        if name in ("A_log", "D", "dt_bias"):              # (nheads,)
            return (m(shape[0]),)
        if name == "lora_b":                               # (3, R, width)
            return (None, None, m(shape[2]))
        if name == "lora_a":                               # (3, d, R)
            return (None, f(shape[1]), None)
        return tuple(None for _ in shape)                  # norms, scalars, rest


_KEY = re.compile(r"\['([^']*)'\]|\.(\w+)")


def leaf_name(path: str) -> str:
    """The last dict key or NamedTuple field of a path (``""`` for none),
    as the JAX rules name a leaf."""

    keys = [a or b for a, b in _KEY.findall(path)]
    return keys[-1] if keys else ""


def rule_ndim(name: str, pathstr: str) -> int:
    """How many trailing dims a leaf's rule covers; the dims before them
    are stacking dims (units, hybrid's k), always replicated."""

    moe = "moe" in pathstr and "shared" not in pathstr
    if moe and name in ("wi_gate", "wi_up", "wo"):
        return 3
    if name in ("lora_a", "lora_b"):
        return 3
    if name in ("bq", "bk", "bv", "bi", "bo", "conv_x_b", "conv_B_b",
                "conv_C_b", "norm", "A_log", "D", "dt_bias", "kv_norm",
                "norm1", "norm2", "post_norm1", "post_norm2",
                "final_norm", "w", "b", "enc_ln", "dec_ln"):
        return 1
    return 2


def param_pspecs(cfg: ModelConfig, param_shapes: Any, mesh_cfg: MeshConfig):
    """Tree of ``P`` matching ``param_shapes`` (``models.api.param_specs``)."""

    rules = _Rules(cfg, mesh_cfg)

    def spec_for(pathstr, leaf):
        name = leaf_name(pathstr)
        shape = tuple(leaf.shape)
        trailing = rules.trailing_spec(
            name, pathstr, shape[-rule_ndim(name, pathstr):] if shape else ())
        # left-pad for the stacking dims
        return P(*([None] * (len(shape) - len(trailing)) + list(trailing)))

    return tree_map_with_path(spec_for, param_shapes)


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                 batch_tree: Any):
    """Specs for a train/prefill batch dict: batch dim over DP when it
    divides, else replicated (long_500k's B=1)."""

    dp = dp_axes(mesh_cfg)
    dp_size = mesh_cfg.pod * mesh_cfg.data if mesh_cfg.multi_pod else mesh_cfg.data
    bdim = dp if _div(shape.global_batch, dp_size) else None

    def spec_for(path, leaf):
        return P(*([bdim] + [None] * (leaf.ndim - 1)))

    return tree_map_with_path(spec_for, batch_tree)


def cache_pspecs_tree(cfg: ModelConfig, shape: ShapeConfig,
                      mesh_cfg: MeshConfig, cache_shapes: Any):
    """KV/SSM cache specs.

    General decode (B divisible by DP): batch -> DP, kv-heads -> model.
    Long-context decode (B=1): heads -> model, sequence -> data; SSM
    states shard by heads.  Where the KV heads do not divide the model
    axis the rule shards the cache's sequence on it instead.
    """

    dp = dp_axes(mesh_cfg)
    dp_size = mesh_cfg.pod * mesh_cfg.data if mesh_cfg.multi_pod else mesh_cfg.data
    b_shardable = _div(shape.global_batch, dp_size)
    model = mesh_cfg.model
    data = mesh_cfg.data

    def spec_for(pathstr, leaf):
        # the batch dim: caches are stacked (n_scan, ...) or
        # (n_units, k, ...); the first dim equal to global_batch
        shp = tuple(leaf.shape)
        dims = [None] * len(shp)
        try:
            b_ix = shp.index(shape.global_batch)
        except ValueError:
            b_ix = None
        if b_ix is not None and b_shardable:
            dims[b_ix] = dp
        if b_ix is None:
            b_ix = -1  # nothing marked
        # kv caches: (.., B, H, L, hd) / mla: (.., B, L, r) / ssm h: (.., B, nh, hd, ds)
        if "c_kv" in pathstr or "k_rope" in pathstr:
            if not b_shardable and _div(shp[b_ix + 2], data):
                dims[b_ix + 2] = "data"                 # sequence sharding
        elif ".h" in pathstr or "'h'" in pathstr:       # ssm state
            if _div(shp[b_ix + 1], model):
                dims[b_ix + 1] = "model"
        elif len(shp) - (b_ix + 1) >= 3:                # KVCache k/v
            h_ix, l_ix = b_ix + 1, b_ix + 2
            if _div(shp[h_ix], model):
                dims[h_ix] = "model"
            elif _div(shp[l_ix], model):
                # kv-head count not divisible: shard the sequence
                dims[l_ix] = "model"
            if not b_shardable and _div(shp[l_ix], data) \
                    and dims[l_ix] is None:
                dims[l_ix] = "data"
        elif "conv" in pathstr:
            if _div(shp[-1], model):
                dims[-1] = "model"
        return P(*dims)

    return tree_map_with_path(spec_for, cache_shapes)
