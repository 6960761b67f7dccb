"""Execution schedules for ``Trainer.fit``.

Port of ``repro.mc.schedules``: every schedule consumes the same
``CompletionProblem`` + ``GossipMCConfig`` + ``torch.Generator`` and
produces the same ``(State, history)`` pair.

    Sequential  — Algorithm 1 verbatim: one random structure per iteration
    Wave        — ≤8 conflict-free parity waves per round
    FullGD      — deterministic limit: all structures at once (GD on L)

``run(problem, cfg, generator, state=..., eval_cb=None)`` starts from
``state``; ``eval_cb(unit, cost, state)`` fires at every eval boundary,
``unit`` in the schedule's own units (iterations or rounds).  The gossip,
incremental and checkpoint-resume paths are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.config import GossipMCConfig
from repro_torch.core import sequential as core_sequential
from repro_torch.core import waves as core_waves
from repro_torch.core.state import State
from repro_torch.mc.problem import CompletionProblem

EvalCb = Optional[Callable[[int, float, State], None]]


class Schedule:
    """Strategy interface: subclasses define ``name`` and ``run``."""

    name = "abstract"

    def run(self, problem: CompletionProblem, cfg: GossipMCConfig,
            generator: torch.Generator, *, state: State,
            eval_cb: EvalCb = None) -> tuple[State, list[tuple[int, float]]]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sequential(Schedule):
    """Paper Algorithm 1: one uniformly sampled structure per iteration."""

    num_iters: int = 20_000
    eval_every: int = 0

    name = "sequential"

    def run(self, problem, cfg, generator, *, state, eval_cb=None):
        eng = problem.engine
        return core_sequential._fit(
            problem.data, problem.spec, cfg, generator,
            num_iters=self.num_iters, eval_every=self.eval_every,
            state=state, method=eng.method, chunk=eng.chunk,
            progress_cb=eval_cb,
        )


@dataclasses.dataclass(frozen=True)
class Wave(Schedule):
    """Parity-wave rounds: all non-overlapping structures of a wave updated
    in one conflict-free step, waves in random order."""

    num_rounds: int = 200
    eval_every: int = 0

    name = "wave"
    _mode = "wave"

    def run(self, problem, cfg, generator, *, state, eval_cb=None):
        eng = problem.engine
        return core_waves._fit(
            problem.data, problem.spec, cfg, generator,
            num_rounds=self.num_rounds, eval_every=self.eval_every,
            mode=self._mode, state=state, method=eng.method,
            chunk=eng.chunk, progress_cb=eval_cb,
        )


@dataclasses.dataclass(frozen=True)
class FullGD(Wave):
    """Deterministic limit: every structure at once = GD on the collapsed
    objective L."""

    name = "full"
    _mode = "full"


_BY_NAME = {
    "sequential": Sequential,
    "wave": Wave,
    "full": FullGD,
    "full_gd": FullGD,
}


def make_schedule(spec: Union[str, Schedule], **overrides) -> Schedule:
    """Resolve a schedule: pass a ``Schedule`` through, or build one from
    its name (``"sequential" | "wave" | "full"``) with default sizes
    overridable by keyword."""

    if isinstance(spec, Schedule):
        if overrides:
            return dataclasses.replace(spec, **overrides)
        return spec
    try:
        cls = _BY_NAME[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown schedule {spec!r}; expected one of "
            f"{sorted(_BY_NAME)} or a Schedule instance"
        ) from None
    return cls(**overrides)
