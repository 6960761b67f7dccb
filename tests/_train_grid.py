"""Helpers shared by the tests that hold the port's sharded train step
against the JAX package's on ``gloo`` CPU ranks
(``tests/test_torch_tp_train.py``, ``tests/test_torch_kv_train.py``):
trees as ``{path: numpy}``, a rank's slices of a numpy tree, the paths a
spec tree splits on ``"model"``, a rank's groups by name, and the
launcher's checkpoint helpers."""

import os
import shutil

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map_with_path
from repro_torch.train.shard import shard_leaf

B, SEQ, STEPS = 8, 16, 2
LR = 1e-3
# tests/test_torch_train.py's tolerances
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
SGD_TOL = 1e-5
ADAM_MAX = 0.25
ADAM_FRAC = 1e-3
NORM_RTOL = 1e-6


def tc_kw(mb, opt):
    """The ``TrainConfig`` fields of a case: lr ``LR``, one warm-up step,
    microbatch ``mb`` (0: none) and optimizer ``opt``."""

    return dict(learning_rate=LR, warmup_steps=1, total_steps=10,
                microbatch=mb, optimizer=opt)


def numpy_tree(tree):
    """``{path: numpy copy}`` of a tree of tensors."""

    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(
        p, x.detach().cpu().numpy().copy()), tree)
    return out


def grid_groups(grid):
    """A ``TrainGrid``'s groups by the names the collectives' counts use."""

    return {k: g for k, g in (("model", grid.model), ("fsdp", grid.fsdp),
                              ("batch", grid.batch), ("pod", grid.pod))
            if g is not None}


def nested(flat):
    """``{"['a']['b']": x}`` as nested dicts ``{"a": {"b": x}}``."""

    out = {}
    for path, x in flat.items():
        keys = path[2:-2].split("']['")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return out


def slices(tree_np, pspecs, mesh_cfg, rank):
    """``{path: the rank's slice}`` of a numpy tree by ``pspecs``."""

    out = {}
    tree_map_with_path(lambda p, x, s: out.__setitem__(
        p, shard_leaf(x, s, mesh_cfg, rank).numpy()), tree_np, pspecs)
    return out


def on_model(shapes, pspecs) -> set:
    """The paths the specs split on ``"model"``."""

    out = set()
    tree_map_with_path(lambda p, _, s: out.add(p) if any(
        e == "model" or (isinstance(e, tuple) and "model" in e)
        for e in s) else None, shapes, pspecs)
    return out


def trees_equal(a, b):
    """Two trees of tensors equal leaf for leaf, dtypes too."""

    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def copy_step(src, dst, step):
    """A copy of checkpoint ``step`` of directory ``src`` in a new
    directory ``dst``."""

    os.makedirs(dst)
    name = f"step_{step:010d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
