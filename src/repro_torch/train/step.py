"""Train and eval step factories of the LM harness (port of
``repro.train.step``, one device, no mesh).

``make_train_step`` builds the step: the model loss and its gradients by
autograd, optional microbatched gradient accumulation, then the optimizer
update.  The JAX step's shardings (``opt_pspecs``/``shardings_for``) have
no counterpart here; its buffer donation does: the step updates ``params``
and ``opt_state`` in place and returns them.

With ``microbatch = n > 1`` the leading batch dim is split into n equal
parts as the JAX step's ``grads_of`` splits it; each part's forward is
followed by the backward of ``loss_i / n``, which adds into the
parameters' ``.grad``, so the gradients of the n parts sum in one tree
(JAX's ``lax.scan`` carries a second, zero-initialised one) and only one
part's activations are alive at a time.  The loss is Σ loss_i / n.
"""

from __future__ import annotations

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.api import Model
from repro_torch.optim import Optimizer, apply_updates, make_optimizer
from repro_torch.optim.optimizers import tree_leaves, tree_map


def loss_and_grads(loss_fn, params, batches):
    """(Σ_i loss_fn(params, b_i) / n, its gradient tree) over the n
    batches in ``batches``, one forward and backward at a time.  The
    gradients are new tensors (the leaves' ``.grad``, detached from them
    afterwards); ``params``' ``requires_grad`` flags are left as found."""

    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    n = len(batches)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        total = None
        for batch in batches:
            loss = loss_fn(params, batch)
            if n > 1:
                loss = loss / n
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
    finally:
        for p, flag in zip(leaves, flags):
            p.grad = None
            p.requires_grad_(flag)
    return total, grads


def split_batch(batch: dict, n: int) -> list[dict]:
    """The batch as n equal parts of its leading dim (``[batch]`` for
    n <= 1)."""

    if not n or n <= 1:
        return [batch]
    size = {len(v) for v in batch.values()}
    if len(size) != 1 or next(iter(size)) % n:
        raise ValueError(f"cannot split the batch's leading dims "
                         f"{sorted(size)} into {n} equal parts")
    m = next(iter(size)) // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model: Model, train_cfg: TrainConfig,
                    optimizer: Optimizer | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss":
    loss})``; ``params`` and ``opt_state`` are updated in place."""

    optimizer = optimizer or make_optimizer(train_cfg)
    n_micro = train_cfg.microbatch

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model.loss, params,
                                     split_batch(batch, n_micro))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss}

    return train_step


def make_eval_step(model: Model):
    """``step(params, batch) -> loss``, without autograd."""

    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch)

    return eval_step
