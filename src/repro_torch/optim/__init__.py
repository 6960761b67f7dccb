"""Functional optimizers of the LM harness (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    AdamWState,
    Optimizer,
    SGDState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_warmup,
    make_optimizer,
    paper_sgd,
    sgd,
)

__all__ = ["AdamWState", "Optimizer", "SGDState", "adamw", "apply_updates",
           "clip_by_global_norm", "cosine_warmup", "make_optimizer",
           "paper_sgd", "sgd"]
