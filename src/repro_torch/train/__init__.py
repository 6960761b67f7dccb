"""LM training of the port (``repro.train``): the one-card train step,
the sharded train step on a ``pod x data`` grid of ranks, and gossip
data-parallel training on ranks."""

from repro_torch.train.gossip_dp import (
    consensus_error,
    make_gossip_dp_step,
    rank_consensus_error,
    replicate_for_workers,
)
from repro_torch.train.step import (
    make_eval_step,
    make_sharded_train_step,
    make_train_step,
)

__all__ = ["consensus_error", "make_eval_step", "make_gossip_dp_step",
           "make_sharded_train_step", "make_train_step",
           "rank_consensus_error", "replicate_for_workers"]
