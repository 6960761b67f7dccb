"""Divergence detection + the self-healing fit policy.

Port of ``repro.faults.recovery`` (pure Python; the messages are the
reference's word for word):

* :class:`DivergenceGuard` — a ``Trainer`` callback that checks the cost
  at every eval boundary and raises :class:`DivergenceError` on NaN/Inf
  or an explosion past the best cost seen.
* :class:`RecoveryPolicy` — handed to ``Trainer.fit(recovery=...)``, it
  turns the guard's raise into a restart: restore the latest valid
  checkpoint, re-seed the generator (a restarted node draws a fresh
  stream), decay the step size by ``backoff``, clear one-shot injected
  faults (``FaultPlan.refold``), and resume.  Every restart is recorded
  in ``FitResult.recovery_log`` and the ``fit_recoveries_total`` counter.

Import-light: no ``repro_torch.mc`` imports (the trainer imports *this*
module).  The guard duck-types the callback protocol.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


class DivergenceError(RuntimeError):
    """A fit's cost went NaN/Inf or exploded.

    Carries the failure point (``unit``, ``cost``), the schedule name,
    and the hyper-parameters in effect so the message alone is enough to
    reproduce and fix the run."""

    def __init__(self, unit: int, cost: float, schedule: str = "?",
                 cfg=None, reason: str = "non-finite cost"):
        self.unit = unit
        self.cost = cost
        self.schedule = schedule
        self.cfg = cfg
        self.reason = reason
        hypers = ""
        if cfg is not None:
            hypers = (f" (hyperparameters in effect: a={cfg.a:g}, "
                      f"b={cfg.b:g}, rho={cfg.rho:g}, lam={cfg.lam:g})")
        super().__init__(
            f"fit diverged at unit {unit} of schedule {schedule!r}: "
            f"cost={cost:g} — {reason}{hypers}"
        )


class DivergenceGuard:
    """Eval-boundary divergence tripwire (a ``Trainer`` callback).

    Raises :class:`DivergenceError` when the eval cost is non-finite,
    exceeds ``max_cost`` (absolute ceiling), or exceeds
    ``explode_factor`` × the best cost seen so far in this fit.  Place it
    *before* any ``Checkpoint`` callback so a poisoned state is never
    persisted; ``Trainer.fit(recovery=...)`` enforces that order
    automatically."""

    def __init__(self, explode_factor: float = 1e3,
                 max_cost: Optional[float] = None):
        if explode_factor <= 1.0:
            raise ValueError(
                f"explode_factor must be > 1, got {explode_factor}"
            )
        self.explode_factor = explode_factor
        self.max_cost = max_cost
        self._best: Optional[float] = None
        self._cfg = None
        self._schedule = "?"

    def on_fit_start(self, problem, schedule, cfg) -> None:
        self._best = None
        self._cfg = cfg
        self._schedule = getattr(schedule, "name", str(schedule))

    def on_eval(self, unit, cost, state, key) -> None:
        c = float(cost)
        if not math.isfinite(c):
            raise DivergenceError(unit, c, self._schedule, self._cfg,
                                  reason="non-finite cost")
        if self.max_cost is not None and c > self.max_cost:
            raise DivergenceError(
                unit, c, self._schedule, self._cfg,
                reason=f"cost above the max_cost ceiling {self.max_cost:g}",
            )
        if self._best is not None and c > self.explode_factor * self._best:
            raise DivergenceError(
                unit, c, self._schedule, self._cfg,
                reason=f"cost exploded {self.explode_factor:g}x past the "
                       f"best seen ({self._best:g})",
            )
        if self._best is None or c < self._best:
            self._best = c

    def on_fit_end(self, result) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How ``Trainer.fit`` self-heals when the guard fires.

    max_restarts  : restore-and-resume attempts before giving up (the
                    final failure re-raises the ``DivergenceError``)
    backoff       : step-size decay per restart — restart *k* runs with
                    ``a * backoff**k``
    on_divergence : "restore" (default) self-heals; "raise" keeps the
                    guard's error fatal while still getting guard +
                    checkpoint ordering
    """

    max_restarts: int = 3
    backoff: float = 0.5
    on_divergence: str = "restore"

    def __post_init__(self) -> None:
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if not 0.0 < self.backoff <= 1.0:
            raise ValueError(
                f"backoff is a step-size decay factor in (0, 1], got "
                f"{self.backoff}"
            )
        if self.on_divergence not in ("restore", "raise"):
            raise ValueError(
                f"on_divergence must be 'restore' or 'raise', got "
                f"{self.on_divergence!r}"
            )
