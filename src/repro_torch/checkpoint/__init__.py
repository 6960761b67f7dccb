"""``repro_torch.checkpoint`` — atomic, manifest-verified checkpoints in
the reference's on-disk format (``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (
    CheckpointManager,
    checkpoint_valid,
    load_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "checkpoint_valid", "save_pytree",
           "load_pytree"]
