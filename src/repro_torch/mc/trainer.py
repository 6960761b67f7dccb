"""``Trainer`` + ``FitResult`` — the session layer over the schedules.

Port of ``repro.mc.trainer``::

    from repro_torch.mc import CompletionProblem, FullGD, Trainer

    problem = CompletionProblem.from_dataset(ds, p=4, q=4, rank=8,
                                             layout="sparse")
    result = Trainer(cfg).fit(problem, FullGD(num_rounds=500), seed=0)
    index = result.to_recommend_index()

``FitResult`` carries the final ``State``, the (t, cost) loss trace, the
wall time and the bridges into evaluation (``factors``, ``rmse``) and
serving (``to_recommend_index``).  The random stream is a
``torch.Generator`` on the problem's device seeded with ``seed``; it
draws the initial state (unless ``state=`` is given), the wave order and
the sequential structure picks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.config import GossipMCConfig
from repro_torch.core import assemble as asm
from repro_torch.core.state import State, init_state
from repro_torch.mc.callbacks import Callback
from repro_torch.mc.problem import CompletionProblem
from repro_torch.mc.schedules import Schedule, make_schedule
from repro_torch.serve.recommend import RecommendIndex, build_index


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class FitResult:
    """Everything a finished fit produced."""

    state: State
    history: list            # (t, cost) pairs at eval boundaries
    wall_time: float         # seconds inside the schedule loop
    schedule: str            # schedule name ("sequential" | "wave" | "full")
    problem: CompletionProblem

    @property
    def final_cost(self) -> float:
        return self.history[-1][1] if self.history else float("nan")

    @property
    def t(self) -> int:
        """Structure-update count (the paper's iteration clock)."""

        return int(self.state.t)

    def factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Consensus-assembled global (m, r) / (n, r) factors."""

        return asm.assemble(self.state.U, self.state.W, self.problem.spec)

    def consensus_error(self) -> tuple[float, float]:
        return asm.consensus_error(self.state.U, self.state.W)

    def rmse(self, rows=None, cols=None, vals=None) -> float:
        """Held-out completion RMSE; defaults to the problem's attached
        dataset test split (``vals`` are compared in the problem's
        mean-centered frame automatically)."""

        if rows is None:
            ds = self.problem.dataset
            if ds is None:
                raise ValueError(
                    "no test triplets: attach a dataset "
                    "(CompletionProblem.from_dataset) or pass "
                    "rows/cols/vals explicitly"
                )
            rows, cols, vals = ds.test_rows, ds.test_cols, ds.test_vals
        u, w = self.factors()
        return asm.rmse(u, w, rows, cols,
                        np.asarray(vals, np.float32) - self.problem.mu)

    def to_recommend_index(self) -> RecommendIndex:
        """Assemble the factors, trim grid padding to the true
        (num_users, num_items) shape, and attach the seen-item exclusion
        table from the problem's observed entries."""

        p = self.problem
        return build_index(
            self.state.U, self.state.W, p.spec,
            num_users=p.num_users or None, num_items=p.num_items or None,
            seen_coo=p.seen_coo,
        )


class Trainer:
    """Runs any ``Schedule`` against any ``CompletionProblem``.

    ``cfg`` carries the paper's hyper-parameters (ρ, λ, step-size a/b);
    ``None`` uses the paper defaults sized to the problem's grid.
    ``callbacks`` fire at fit start, every eval boundary, and fit end.
    """

    def __init__(self, cfg: GossipMCConfig | None = None,
                 callbacks: Sequence[Callback] = ()):
        self.cfg = cfg
        self.callbacks = list(callbacks)

    def _config_for(self, problem: CompletionProblem) -> GossipMCConfig:
        if self.cfg is not None:
            return self.cfg
        spec = problem.spec
        return GossipMCConfig(m=spec.m, n=spec.n, p=spec.p, q=spec.q,
                              rank=spec.r)

    def fit(
        self,
        problem: CompletionProblem,
        schedule: Union[str, Schedule] = "wave",
        *,
        seed: int = 0,
        state: State | None = None,
        **schedule_overrides,
    ) -> FitResult:
        """Run the schedule to completion and return a :class:`FitResult`.

        ``schedule`` is a ``Schedule`` instance or a name ("sequential",
        "wave", "full"); keyword overrides (e.g. ``num_rounds=500``) are
        applied either way.  ``state`` starts from given factors (the
        parity tests inject the reference's initial state this way)."""

        if not isinstance(problem, CompletionProblem):
            raise TypeError(
                f"Trainer.fit expects a CompletionProblem, got "
                f"{type(problem).__name__}; build one with "
                "CompletionProblem.from_dense/from_entries/from_dataset"
            )
        sched = make_schedule(schedule, **schedule_overrides)
        cfg = self._config_for(problem)
        generator = torch.Generator(device=problem.device)
        generator.manual_seed(seed)
        if state is None:
            state = init_state(generator, problem.spec)

        for cb in self.callbacks:
            cb.on_fit_start(problem, sched, cfg)

        def eval_cb(unit, cost, st):
            for cb in self.callbacks:
                cb.on_eval(unit, cost, st)

        t0 = time.perf_counter()
        state, history = sched.run(
            problem, cfg, generator, state=state,
            eval_cb=eval_cb if self.callbacks else None,
        )
        synchronize(problem.device)
        result = FitResult(state=state, history=history,
                           wall_time=time.perf_counter() - t0,
                           schedule=sched.name, problem=problem)
        for cb in self.callbacks:
            cb.on_fit_end(result)
        return result
