"""Functional optimizers over trees of tensors (port of
``repro.optim.optimizers``).

The same ``init(params) -> state`` / ``update(grads, state, params) ->
(updates, state)`` contract as the JAX package, with its state types:
``AdamWState(step, mu, nu)`` and ``SGDState(step, momentum)``, the moments
float32, the step an int32 0-d tensor on the parameters' device, the
update order, bias corrections and weight-decay placement as there.  So a
state checkpoints in the JAX package's format (``checkpoint/manager.py``)
and carries across through ``convert.opt_state_from_numpy``; this is why
``torch.optim.AdamW``, whose state is laid out otherwise, is not used.

A tree is a nested dict of tensors (the LM's parameters).  Where JAX
donates its buffers to the jitted step, ``update`` works in place under
``torch.no_grad()``: it writes the new moments into ``state``'s tensors
and the updates into ``grads``' tensors, and returns both (so ``grads``
and ``state`` are consumed); ``apply_updates`` adds into ``params``.  At
gemma2-2b's 2.61 B parameters this holds params, grads and two moments
(41.8 GB) and a few temporaries of one leaf's size, not a second copy of
each tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import TrainConfig


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/tuple tree, dict keys sorted (the JAX
    package's flattening order)."""

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``tree_map`` whose ``fn(path, leaf, *rest_leaves)`` also gets each
    leaf's path as ``jax.tree_util.keystr`` spells it: ``['units']['s0']
    ['attn']['wq']`` (no spaces), a NamedTuple's field as ``.k``, a list
    or tuple position as ``[0]``.  ``rest`` trees are indexed by the first
    tree's structure, so a leaf of ``tree`` may face a subtree there (a
    spec tree's tuples)."""

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=f"{path}.{name}")
            for i, (name, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=f"{path}[{i}]")
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_flatten_with_path(tree) -> list:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order (dict keys sorted), paths as ``tree_map_with_path`` spells them."""

    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{k}", v) for k, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("", tree)]
    return [(key + path, leaf) for key, sub in items
            for path, leaf in tree_flatten_with_path(sub)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of the same structure (nested dicts,
    tuples and NamedTuples such as the optimizer states)."""

    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params) -> (updates, state)
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def _f32_zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def cosine_warmup(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; ``schedule(step)`` takes and returns 0-d
    tensors (f32)."""

    def schedule(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return schedule


def square_norm(grads) -> torch.Tensor:
    """‖g‖² of a tree, in float32."""

    return sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, sq_norm=square_norm):
    """(grads scaled in place by min(1, max_norm / (‖g‖ + 1e-9)), ‖g‖);
    ‖g‖² is ``sq_norm(grads)``: a rank's shards of a tree pass the norm
    over every rank's (``train/step.py``)."""

    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sq_norm(grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


def adamw(lr_schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm=0.0, sq_norm=square_norm):
    def init(params):
        return AdamWState(_step0(params), tree_map(_f32_zeros, params),
                          tree_map(_f32_zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm,
                                           sq_norm)
        step = state.step + 1
        lr = lr_schedule(step)
        t = step.float()
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, n, p):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            n.mul_(b2).add_((1 - b2) * torch.square(gf))
            u = torch.div(m, bc1).div_(torch.div(n, bc2).sqrt_().add_(eps))
            u.add_(weight_decay * p.float())
            return g.copy_(u.mul_(-lr))

        updates = tree_map(upd, grads, state.mu, state.nu, params)
        return updates, AdamWState(step, state.mu, state.nu)

    return Optimizer(init, update)


def sgd(lr_schedule, momentum=0.9, max_grad_norm=0.0, sq_norm=square_norm):
    def init(params):
        return SGDState(_step0(params), tree_map(_f32_zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm,
                                           sq_norm)
        step = state.step + 1
        lr = lr_schedule(step)

        def upd(g, m, p):
            m.mul_(momentum).add_(g.float())
            return g.copy_(-lr * m)

        updates = tree_map(upd, grads, state.momentum, params)
        return updates, SGDState(step, state.momentum)

    return Optimizer(init, update)


def paper_sgd(a: float, b: float):
    """The paper's plain SGD with γ_t = a / (1 + b t) (no momentum)."""

    def init(params):
        return SGDState(_step0(params), ())

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr = a / (1.0 + b * step.float())
        updates = tree_map(lambda g, p: g.mul_(-lr), grads, params)
        return updates, SGDState(step, ())

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig, sq_norm=square_norm) -> Optimizer:
    """The optimizer of ``cfg``; its clip takes ‖g‖² from ``sq_norm``."""

    sched = cosine_warmup(cfg.learning_rate, cfg.warmup_steps, cfg.total_steps)
    if cfg.optimizer == "adamw":
        return adamw(sched, cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay,
                     cfg.max_grad_norm, sq_norm)
    if cfg.optimizer == "sgd":
        return sgd(sched, cfg.beta1, cfg.max_grad_norm, sq_norm)
    if cfg.optimizer == "paper_sgd":
        return paper_sgd(cfg.learning_rate, 5e-7)
    raise ValueError(cfg.optimizer)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates``, added in place into ``params``' tensors."""

    return tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
