"""``repro_torch.faults`` — deterministic fault injection + self-healing
fits (the port of ``repro.faults``, DESIGN.md §13):

* :class:`FaultPlan` — seed-keyed per-round, per-edge fault masks
  (drops, stragglers, one-shot NaN corruption), decided on the host and
  replayed exactly; consumed by ``core.gossip.make_gossip_step(faults=...)``.
* :class:`DivergenceGuard` / :class:`DivergenceError` — eval-boundary
  NaN/explosion tripwire that names the unit, cost and hyper-parameters.
* :class:`RecoveryPolicy` — ``Trainer.fit(recovery=...)``: restore the
  latest valid checkpoint, re-seed the generator, decay the step size,
  resume.

This package imports no ``repro_torch.mc``/``repro_torch.core`` modules.
"""

from repro_torch.faults.plan import (
    AGE_NEVER,
    DIRECTIONS,
    FaultPlan,
    edges_exist,
)
from repro_torch.faults.recovery import (
    DivergenceError,
    DivergenceGuard,
    RecoveryPolicy,
)

__all__ = [
    "AGE_NEVER",
    "DIRECTIONS",
    "DivergenceError",
    "DivergenceGuard",
    "FaultPlan",
    "RecoveryPolicy",
    "edges_exist",
]
