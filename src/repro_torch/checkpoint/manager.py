"""Fault-tolerant checkpointing in the reference's on-disk format.

Port of ``repro.checkpoint.manager``: the same files, so a directory
either package writes of a (nested) dict of arrays loads in the other.

* **Atomic**: a save writes ``step_<n>.tmp/`` then renames it — a crash
  mid-save can never corrupt the latest checkpoint.  Each completed save
  ends with a ``MANIFEST.json`` (leaf count + file list, written last);
  ``latest_step``/``restore`` verify it and *skip* partial or corrupt
  step dirs, falling back to the newest valid step even when the
  ``LATEST`` pointer is stale.
* **Sharded leaves**: each array is cut into ≤ ``shard_bytes`` ``.npy``
  shards (``a<leaf>_s<shard>.npy``, flat and concatenated); the tree's
  structure is a JSON skeleton keyed by the flattened path string
  (``['U']``, ``['b']['x'][0]``, ``['o'].mu['w']``: dict keys sorted, a
  NamedTuple's fields by name, as ``jax.tree_util.keystr`` writes them),
  so an optimizer state (``AdamWState``/``SGDState``) either package saves
  loads in the other, its type kept.
* Leaves are saved as full arrays from the host (torch tensors, numpy
  arrays or Python scalars); ``load_pytree`` returns torch tensors on the
  device it is given.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

# (path, leaf) pairs in JAX's flattening order, paths as keystr spells them
from repro_torch.optim.optimizers import tree_flatten_with_path as _flatten

_SKELETON = "skeleton.json"
_MANIFEST = "MANIFEST.json"


def _unflatten(like, leaves: dict, path: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, f"{path}[{k!r}]")
                for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, f"{path}.{k}")
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, f"{path}[{i}]")
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, list) else tuple(out)
    return leaves[path]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree: Any, directory: str, shard_bytes: int = 1 << 30) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    skeleton = []
    files = []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr = _host(leaf)
        nshards = max(1, -(-arr.nbytes // shard_bytes))
        chunks = np.array_split(arr.reshape(-1), nshards) if arr.ndim else [arr]
        for s, chunk in enumerate(chunks):
            name = f"a{i:05d}_s{s:03d}.npy"
            np.save(os.path.join(tmp, name), chunk)
            files.append(name)
        skeleton.append({
            "path": path, "index": i, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "nshards": len(chunks),
            "layout": "flat_concat",
        })
    with open(os.path.join(tmp, _SKELETON), "w") as f:
        json.dump(skeleton, f)
    # the manifest is written LAST: its presence certifies every shard
    # file above it landed, so a kill at any earlier point leaves a dir
    # that the manager provably skips
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"num_leaves": len(skeleton), "files": files,
                   "complete": True}, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def checkpoint_valid(directory: str) -> bool:
    """True iff ``directory`` holds a complete checkpoint: the
    ``MANIFEST.json`` written last parses, claims completeness, its leaf
    count matches the skeleton, and every listed shard file exists (a dir
    without a manifest falls back to the skeleton's file list)."""

    skel_p = os.path.join(directory, _SKELETON)
    man_p = os.path.join(directory, _MANIFEST)
    try:
        with open(skel_p) as f:
            skeleton = json.load(f)
        if os.path.exists(man_p):
            with open(man_p) as f:
                man = json.load(f)
            if not man.get("complete") or man["num_leaves"] != len(skeleton):
                return False
            files = man["files"]
        else:
            files = [f"a{e['index']:05d}_s{s:03d}.npy"
                     for e in skeleton for s in range(e["nshards"])]
        return all(os.path.exists(os.path.join(directory, n)) for n in files)
    except (OSError, ValueError, KeyError, TypeError):
        return False


def load_pytree(directory: str, like: Any, device=None) -> Any:
    """The checkpoint in ``directory`` as ``like``'s structure (nested
    dicts, lists, tuples and NamedTuples; its leaves only mark places) of
    torch tensors on ``device`` (the CPU by default)."""

    with open(os.path.join(directory, _SKELETON)) as f:
        skeleton = json.load(f)
    by_path = {e["path"]: e for e in skeleton}
    leaves = {}
    for path, _ in _flatten(like):
        e = by_path[path]
        parts = [np.load(os.path.join(directory,
                                      f"a{e['index']:05d}_s{s:03d}.npy"))
                 for s in range(e["nshards"])]
        arr = np.concatenate(parts).reshape(e["shape"]).astype(e["dtype"]) \
            if e["shape"] else parts[0]
        leaves[path] = torch.from_numpy(np.array(arr)).to(
            device if device is not None else "cpu")
    return _unflatten(like, leaves)


class CheckpointManager:
    """step-numbered checkpoints + LATEST pointer + retention (``keep``
    newest steps)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, tree: Any) -> None:
        save_pytree(tree, self._step_dir(step))
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.directory, "LATEST.tmp"),
                   os.path.join(self.directory, "LATEST"))
        self._gc()

    def valid_steps(self) -> list[int]:
        """Steps on disk whose dirs pass :func:`checkpoint_valid`,
        ascending.  Partial dirs from a killed save never appear here."""

        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    s = int(d.split("_")[1])
                except ValueError:
                    continue
                if checkpoint_valid(self._step_dir(s)):
                    steps.append(s)
        return sorted(steps)

    def latest_step(self) -> int | None:
        """Newest *valid* step: the LATEST pointer when its dir verifies,
        else the newest step dir that does."""

        p = os.path.join(self.directory, "LATEST")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    step = int(f.read().strip())
            except (OSError, ValueError):
                step = None
            if step is not None and checkpoint_valid(self._step_dir(step)):
                return step
        valid = self.valid_steps()
        return valid[-1] if valid else None

    def restore(self, like: Any, step: int | None = None,
                device=None) -> tuple[int, Any] | None:
        """(step, tree) of ``step`` (default: the latest valid one) with
        its leaves on ``device``, or None when no valid step exists."""

        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return step, load_pytree(self._step_dir(step), like, device)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for d in os.listdir(self.directory):  # orphans of killed saves
            if d.endswith(".tmp") and os.path.isdir(
                    os.path.join(self.directory, d)):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
