"""Callback protocol for ``Trainer.fit`` + the held-out RMSE callback.

Port of the ``Callback``/``EvalRMSE`` half of ``repro.mc.callbacks``.
Hooks (all optional — subclass and override what you need):

    on_fit_start(problem, schedule, cfg)  — before the first update
    on_eval(unit, cost, state)            — at every eval boundary; ``unit``
                                            is in the schedule's own units
    on_fit_end(result)                    — with the finished FitResult
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core import assemble as asm
from repro_torch.core.state import State


class Callback:
    """Base: every hook is a no-op."""

    def on_fit_start(self, problem, schedule, cfg) -> None:
        pass

    def on_eval(self, unit: int, cost: float, state: State) -> None:
        pass

    def on_fit_end(self, result) -> None:
        pass


class EvalRMSE(Callback):
    """Held-out completion RMSE at every eval boundary.

    Uses the problem's attached dataset (``CompletionProblem.from_dataset``)
    unless explicit test triplets are given.  The trace accumulates as
    ``(t, rmse)`` pairs in ``.history``; ``log`` (e.g. ``print``) gets one
    formatted line per point."""

    def __init__(self, test_rows=None, test_cols=None, test_vals=None,
                 log: Optional[Callable[[str], None]] = None,
                 consensus: bool = True):
        self._given = (test_rows, test_cols, test_vals)
        self.log = log
        self.consensus = consensus
        self.history: list[tuple[int, float]] = []
        self.consensus_history: list[tuple[int, float, float]] = []
        self._problem = None
        self._triplets = None

    def on_fit_start(self, problem, schedule, cfg) -> None:
        self._problem = problem
        if self._given[0] is not None:
            self._triplets = self._given
            return
        ds = problem.dataset
        if ds is None:
            raise ValueError(
                "EvalRMSE needs test triplets: attach a dataset "
                "(CompletionProblem.from_dataset) or pass "
                "test_rows/test_cols/test_vals explicitly"
            )
        self._triplets = (ds.test_rows, ds.test_cols,
                          ds.test_vals - problem.mu)

    def on_eval(self, unit, cost, state) -> None:
        u, w = asm.assemble(state.U, state.W, self._problem.spec)
        rows, cols, vals = self._triplets
        r = asm.rmse(u, w, rows, cols, vals)
        self.history.append((int(state.t), r))
        line = f"  t={int(state.t):>8d}  cost={cost:.4e}  rmse={r:.4f}"
        if self.consensus:
            cu, cw = asm.consensus_error(state.U, state.W)
            self.consensus_history.append((int(state.t), cu, cw))
            line += f"  consensus={max(cu, cw):.3e}"
        if self.log:
            self.log(line)
