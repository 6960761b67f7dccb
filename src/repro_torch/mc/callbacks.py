"""Callback protocol for ``Trainer.fit`` + the stock callbacks.

Port of ``repro.mc.callbacks``.  Hooks (all optional — subclass and
override what you need):

    on_fit_start(problem, schedule, cfg)  — before the first update
    on_eval(unit, cost, state, key)       — at every eval boundary; ``unit``
                                            is in the schedule's own units
                                            (iterations or rounds), ``key``
                                            is the fit's ``torch.Generator``
                                            at that boundary (what a
                                            restart needs)
    on_fit_end(result)                    — with the finished FitResult

Stock callbacks:

    EvalRMSE   — held-out completion RMSE trace
    BenchLogger— wall-clock + cost trace, device-true stamps
                 (``obs.device_sync`` before the clock reads)
    Telemetry  — per-boundary metrics (units, cost, consensus error,
                 device-true eval-interval time) into ``repro_torch.obs``
    Checkpoint — restart-exact save/restore via CheckpointManager: persists
                 (U, W, t, the generator's state, unit) so
                 ``Trainer.fit(resume_from=...)`` replays the identical
                 stream from the saved boundary
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import assemble as asm
from repro_torch.core.state import State


class Callback:
    """Base: every hook is a no-op."""

    def on_fit_start(self, problem, schedule, cfg) -> None:
        pass

    def on_eval(self, unit: int, cost: float, state: State,
                key: torch.Generator) -> None:
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

    def on_eval(self, unit, cost, state, key) -> None:
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


class BenchLogger(Callback):
    """Wall-clock + cost trace: ``.history`` holds (unit, t, cost,
    seconds-since-fit-start) rows; ``log`` gets one line per eval.

    Stamps are **device-true**: the eval stamp synchronizes on the live
    factors first (``obs.device_sync``, the primitive ``obs.span`` uses),
    so timings measure compute, not the enqueue."""

    def __init__(self, log: Optional[Callable[[str], None]] = print):
        self.log = log
        self.history: list[tuple[int, int, float, float]] = []
        self._t0 = 0.0

    def on_fit_start(self, problem, schedule, cfg) -> None:
        self._t0 = time.perf_counter()

    def on_eval(self, unit, cost, state, key) -> None:
        obs.device_sync(state.U)
        dt = time.perf_counter() - self._t0
        self.history.append((unit, int(state.t), cost, dt))
        if self.log:
            self.log(f"  [{dt:8.2f}s] unit={unit:>8d} t={int(state.t):>8d} "
                     f"cost={cost:.4e}")


class Telemetry(Callback):
    """Stream training metrics into the ``repro_torch.obs`` registry.

    Every schedule reports through the same names:

        train_units_total          counter — schedule units advanced
        train_evals_total          counter — eval boundaries fired
        train_fits_total           counter — completed fits
        train_cost                 gauge   — last eval-boundary cost
        train_consensus_error      gauge   — max of the U/W consensus
                                   errors (``consensus=False`` skips it)
        train_eval_interval_seconds  histogram — device-true time between
                                   boundaries
        train_fit_seconds          histogram — whole-fit wall time
        train_final_cost           gauge   — the finished fit's cost

    The gossip plane adds its own ``train_gossip_*`` and ``gossip_*``
    counters from inside the schedule loop.  All metrics respect the
    global ``obs.set_enabled`` switch."""

    def __init__(self, registry: Optional[obs.Registry] = None,
                 consensus: bool = True):
        self.registry = registry if registry is not None else obs.get_registry()
        self.consensus = consensus
        self._last_unit = 0
        self._t_last = 0.0
        self._t_start = 0.0

    def on_fit_start(self, problem, schedule, cfg) -> None:
        self._last_unit = 0
        self._t_start = self._t_last = time.perf_counter()

    def on_eval(self, unit, cost, state, key) -> None:
        reg = self.registry
        if not reg.enabled:
            return
        obs.device_sync(state.U)
        now = time.perf_counter()
        reg.histogram("train_eval_interval_seconds").observe(
            now - self._t_last)
        self._t_last = now
        reg.counter("train_units_total").inc(max(unit - self._last_unit, 0))
        self._last_unit = unit
        reg.counter("train_evals_total").inc()
        reg.gauge("train_cost").set(float(cost))
        if self.consensus:
            cu, cw = asm.consensus_error(state.U, state.W)
            reg.gauge("train_consensus_error").set(max(float(cu), float(cw)))

    def on_fit_end(self, result) -> None:
        reg = self.registry
        if not reg.enabled:
            return
        reg.counter("train_fits_total").inc()
        reg.histogram("train_fit_seconds").observe(
            time.perf_counter() - self._t_start)
        reg.gauge("train_final_cost").set(result.final_cost)


class Checkpoint(Callback):
    """Restart-exact checkpointing through :class:`CheckpointManager`.

    Saves ``{U, W, t, key, unit}`` every ``every``-th eval boundary
    (atomic rename, retention-GC'd); ``key`` is the generator's
    ``get_state()`` (a uint8 tensor).  ``Trainer.fit(resume_from=...)``
    accepts this callback, a manager, or a directory path and continues
    the run from the saved boundary with the identical stream.

    On a rank grid (a problem placed by an R×C plan) every rank holds the
    same gathered state at a boundary: rank 0 writes it, and every rank
    waits at a barrier after the save, so none restores before it has
    landed."""

    def __init__(self, directory_or_manager, every: int = 1):
        if isinstance(directory_or_manager, CheckpointManager):
            self.manager = directory_or_manager
        else:
            self.manager = CheckpointManager(str(directory_or_manager))
        if every <= 0:
            raise ValueError(f"every must be positive, got {every}")
        self.every = every
        self._evals = 0
        self._grid = False

    def on_fit_start(self, problem, schedule, cfg) -> None:
        self._evals = 0
        plan = getattr(problem, "plan", None)
        self._grid = plan is not None and not plan.is_single_device

    def on_eval(self, unit, cost, state, key) -> None:
        self._evals += 1
        if self._evals % self.every:
            return
        if not self._grid or dist.get_rank() == 0:
            self.manager.save(unit, {
                "U": state.U, "W": state.W, "t": state.t,
                "key": key.get_state(),
                "unit": torch.tensor(unit, dtype=torch.int32),
            })
        if self._grid:
            dist.barrier()

    def restore(self, problem):
        """(unit, state, generator state) from the latest checkpoint, or
        None."""

        return restore_session(self.manager, problem)


def restore_session(manager: CheckpointManager, problem):
    """Load the latest ``Checkpoint``-format session checkpoint: (unit,
    global ``State`` on the problem's device, the generator's state as a
    CPU uint8 tensor), or None when the directory holds no valid step."""

    spec = problem.spec
    restored = manager.restore({"U": 0, "W": 0, "t": 0, "key": 0,
                                "unit": 0}, device=problem.device)
    if restored is None:
        return None
    step, tree = restored
    want = ((spec.p, spec.q, spec.mb, spec.r), (spec.p, spec.q, spec.nb,
                                                   spec.r))
    got = (tuple(tree["U"].shape), tuple(tree["W"].shape))
    if got != want:
        raise ValueError(
            f"checkpoint step {step} in {manager.directory} holds factors "
            f"shaped {got[0]} / {got[1]}, the problem needs {want[0]} / "
            f"{want[1]}")
    state = State(tree["U"], tree["W"], tree["t"])
    return int(tree["unit"]), state, tree["key"].cpu()
