"""``Trainer`` + ``FitResult`` — the session layer over the schedules.

Port of ``repro.mc.trainer``::

    from repro_torch.mc import CompletionProblem, FullGD, Trainer

    problem = CompletionProblem.from_dataset(ds, p=4, q=4, rank=8,
                                             layout="sparse")
    result = Trainer(cfg).fit(problem, FullGD(num_rounds=500), seed=0)
    svc = result.to_service(k=10)                  # fixed-batch front end
    engine = result.to_engine(quant="int8")        # bucketed, int8 cache

    grown = problem.append(rows, cols, vals)       # streaming ratings
    refreshed = Trainer(cfg).refit(result, grown)  # warm start, Incremental

``FitResult`` carries the final ``State``, the (t, cost) loss trace, the
wall time and the bridges into evaluation (``factors``, ``rmse``) and
serving (``to_recommend_index``, ``to_service``, ``to_engine``), on the
problem's device.  The random stream is a
``torch.Generator`` on the problem's device seeded with ``seed``; it
draws the initial state (unless ``state=`` is given), the wave order and
the sequential structure picks.

Checkpoint resume (``resume_from=``) restores (state, generator state,
unit) saved by the ``Checkpoint`` callback and replays the identical
stream; ``recovery=RecoveryPolicy(...)`` makes the fit self-healing.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import GossipMCConfig
from repro_torch.core import assemble as asm
from repro_torch.core.state import State, init_state
from repro_torch.faults import DivergenceError, DivergenceGuard
from repro_torch.mc.callbacks import Callback, Checkpoint, restore_session
from repro_torch.mc.problem import CompletionProblem
from repro_torch.mc.schedules import Schedule, make_schedule
from repro_torch.serve.recommend import (RecommendIndex, RecommendService,
                                        build_index)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def restart_seed(seed: int, restart: int) -> int:
    """The generator seed of self-healing restart ``restart`` of a fit
    whose generator was seeded ``seed``: a pure function of the two (the
    reference folds its key by the restart), below 2**63."""

    return int(np.random.SeedSequence([int(seed), int(restart)])
               .generate_state(1, np.uint64)[0]) & (2**63 - 1)


def _check_protocol(callbacks) -> None:
    for cb in callbacks:
        try:
            inspect.signature(cb.on_eval).bind(0, 0.0, None, None)
        except TypeError:
            raise TypeError(
                f"{type(cb).__name__}.on_eval does not take (unit, cost, "
                "state, key): the callback protocol is on_eval(unit, cost, "
                "state, key), where key is the fit's torch.Generator"
            ) from None


@dataclasses.dataclass
class FitResult:
    """Everything a finished fit produced."""

    state: State
    history: list            # (t, cost) pairs at eval boundaries
    wall_time: float         # seconds inside the schedule loop
    schedule: str            # schedule name ("sequential" | "wave" | "full" |
                             # "incremental" | "gossip")
    problem: CompletionProblem
    # one entry per self-healing restart (Trainer.fit(recovery=...)):
    # {restart, unit, cost, reason, resumed_from, step_a}
    recovery_log: list = dataclasses.field(default_factory=list)

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
        table from the problem's observed entries.  A fit on a rank grid
        holds the global state (``Gossip`` gathers it), so every rank
        builds the same whole index, with no collective."""

        p = self.problem
        return build_index(
            self.state.U, self.state.W, p.spec,
            num_users=p.num_users or None, num_items=p.num_items or None,
            seen_coo=p.seen_coo,
        )

    def _serving_plan(self, plan):
        """``plan``, else the problem's own plan when it spans more than
        one rank (the catalog is then sharded over the fit's ranks)."""

        if plan is None:
            pp = self.problem.plan
            if pp is not None and not pp.is_single_device:
                plan = pp
        return plan

    def to_service(self, batch: int = 256, k: int = 10,
                   exclude_seen: bool = True, plan=None, quant=None,
                   quant_method=None) -> RecommendService:
        """Fixed-batch top-k serving front end over the trained factors.

        ``plan`` (a ``MeshPlan``; defaults to the problem's own plan when
        it spans more than one rank) shards the catalog's item axis over
        the plan's ranks with the two-stage top-k; every rank then calls
        this and the service's methods alike.  ``quant="int8"`` serves the
        int8 factor cache; ``quant_method`` picks its scoring path."""

        return RecommendService(self.to_recommend_index(), batch=batch, k=k,
                                exclude_seen=exclude_seen,
                                plan=self._serving_plan(plan), quant=quant,
                                quant_method=quant_method)

    def to_engine(self, buckets=None, k: int = 10, exclude_seen: bool = True,
                  plan=None, refresh_policy=None, trainer=None,
                  seen_headroom: int = 64, quant=None, quant_method=None):
        """Bucket-batched serving engine over the trained factors
        (``repro_torch.serving.ServingEngine``), every bucket readied here,
        so the first request is already hot.

        ``plan`` defaults as in :meth:`to_service`; on a rank grid every
        rank calls this, and requests go to rank 0's engine.

        Pass ``trainer`` (plus a ``refresh_policy``) and the engine is bound
        for policy-driven auto-refit: ``engine.note_append(n, problem)``
        runs ``trainer.refit`` and hot-swaps the factors once the policy
        trips.  ``quant="int8"`` serves the int8 factor cache through the
        ``dequant_score`` kernel."""

        from repro_torch.serving import DEFAULT_BUCKETS, ServingEngine

        engine = ServingEngine(
            self.to_recommend_index(),
            buckets=buckets if buckets is not None else DEFAULT_BUCKETS,
            k=k, exclude_seen=exclude_seen, plan=self._serving_plan(plan),
            seen_headroom=seen_headroom, refresh_policy=refresh_policy,
            quant=quant, quant_method=quant_method,
        )
        engine._fit_result = self
        if trainer is not None:
            engine.bind(trainer, self)
        return engine


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
        resume_from: Union[Checkpoint, CheckpointManager, str, None] = None,
        recovery=None,
        **schedule_overrides,
    ) -> FitResult:
        """Run the schedule to completion and return a :class:`FitResult`.

        ``schedule`` is a ``Schedule`` instance or a name ("sequential",
        "wave", "full", "gossip"); keyword overrides (e.g.
        ``num_rounds=500``) are applied either way.  ``state`` starts from
        given factors (the parity tests inject the reference's initial
        state this way).

        ``resume_from`` (a :class:`Checkpoint`, a manager or a directory)
        restarts from the latest session checkpoint: state, generator
        state and progress unit, replaying the exact stream of the
        uninterrupted run — the per-round minibatches of a
        ``Gossip(batch=)`` fit included, whose stream seed is a pure
        function of the generator's seed.

        ``recovery=RecoveryPolicy(...)`` makes the fit self-healing
        (DESIGN.md §13): a ``DivergenceGuard`` watches every eval boundary
        (one is added if the callbacks carry none; guards always run
        *before* ``Checkpoint``, so a poisoned state is never persisted),
        and on divergence the fit restores the latest valid checkpoint
        (or starts over when there is none), re-seeds the generator by
        :func:`restart_seed`, runs at ``a * backoff**restart``, refolds
        the schedule's ``FaultPlan`` and resumes.  Restarts land in
        ``FitResult.recovery_log`` and the ``fit_recoveries_total``
        counter; exhausting ``max_restarts`` (or
        ``on_divergence="raise"``) re-raises the ``DivergenceError``.
        On a rank grid every rank sees the same all-reduced cost, so every
        guard fires at the same boundary and every rank restores from the
        same directory."""

        if not isinstance(problem, CompletionProblem):
            raise TypeError(
                f"Trainer.fit expects a CompletionProblem, got "
                f"{type(problem).__name__}; build one with "
                "CompletionProblem.from_dense/from_entries/from_dataset"
            )
        sched = make_schedule(schedule, **schedule_overrides)
        if problem.plan is not None and not problem.plan.is_single_device \
                and not sched.runs_on_tiles:
            raise ValueError(
                f"a problem placed on a {problem.plan.row_size}x"
                f"{problem.plan.col_size} rank grid holds one tile of the "
                f"blocks; only the Gossip schedule runs on it, not "
                f"{sched.name!r}")
        _check_protocol(self.callbacks)
        cfg = self._config_for(problem)
        generator = torch.Generator(device=problem.device)
        generator.manual_seed(seed)

        mgr = resume_from
        if isinstance(mgr, Checkpoint):
            mgr = mgr.manager
        if isinstance(mgr, str):
            mgr = CheckpointManager(mgr)
        done = 0
        if mgr is not None:
            restored = restore_session(mgr, problem)
            if restored is not None:
                done, state, key = restored
                generator.set_state(key)

        if recovery is None:
            return self._run_attempt(problem, sched, cfg, generator, state,
                                     done, self.callbacks)
        return self._run_recovering(problem, sched, cfg, generator, state,
                                    done, mgr, recovery)

    def _run_attempt(self, problem, sched, cfg, generator, state, done,
                     callbacks, recovery_log=None) -> FitResult:
        """One uninterrupted schedule run (the body every fit shares)."""

        if state is None:
            state = init_state(generator, problem.spec)
        for cb in callbacks:
            cb.on_fit_start(problem, sched, cfg)

        def eval_cb(unit, cost, st, key):
            for cb in callbacks:
                cb.on_eval(unit, cost, st, key)

        # the fit's outermost timer: device-true (synchronizes on the
        # final factors before the clock stops) and annotated, so a
        # profiler trace (obs.trace) shows one slice per fit
        t0 = time.perf_counter()
        with obs.span(f"fit.{sched.name}", annotate=True) as sp:
            state, history = sp.outputs(sched.run(
                problem, cfg, generator, state=state, done=done,
                eval_cb=eval_cb if callbacks else None,
            ))
        result = FitResult(
            state=state, history=history,
            wall_time=time.perf_counter() - t0,
            schedule=sched.name, problem=problem,
            recovery_log=recovery_log if recovery_log is not None else [],
        )
        for cb in callbacks:
            cb.on_fit_end(result)
        return result

    def _run_recovering(self, problem, sched, cfg, generator, state, done,
                        mgr, recovery) -> FitResult:
        """The self-healing loop around :meth:`_run_attempt`."""

        if mgr is None:
            for cb in self.callbacks:
                if isinstance(cb, Checkpoint):
                    mgr = cb.manager
                    break
        if mgr is None and recovery.on_divergence == "restore":
            raise ValueError(
                "recovery with on_divergence='restore' needs a checkpoint "
                "to restore from: add a Checkpoint callback to the Trainer "
                "or pass resume_from="
            )
        # guards before everything else — in particular before Checkpoint,
        # so a diverged state is never persisted as a restore point
        guards = [cb for cb in self.callbacks
                  if isinstance(cb, DivergenceGuard)]
        others = [cb for cb in self.callbacks
                  if not isinstance(cb, DivergenceGuard)]
        if not guards:
            guards = [DivergenceGuard()]
        callbacks = guards + others

        recovery_log: list = []
        restart = 0
        attempt_sched, attempt_cfg = sched, cfg
        while True:
            try:
                return self._run_attempt(problem, attempt_sched, attempt_cfg,
                                         generator, state, done, callbacks,
                                         recovery_log=recovery_log)
            except DivergenceError as err:
                if recovery.on_divergence == "raise" \
                        or restart >= recovery.max_restarts:
                    raise
                restart += 1
                obs.counter("fit_recoveries_total").inc()
                restored = restore_session(mgr, problem) if mgr else None
                if restored is not None:
                    done, state, key = restored
                    generator.set_state(key)
                else:
                    # nothing valid on disk yet: start the fit over (with
                    # the decayed step size and a re-seeded generator)
                    done, state = 0, None
                # a restarted node draws a fresh (deterministic) stream
                generator.manual_seed(
                    restart_seed(generator.initial_seed(), restart))
                a = cfg.a * recovery.backoff ** restart
                attempt_cfg = dataclasses.replace(cfg, a=a)
                faults = getattr(attempt_sched, "faults", None)
                if faults is not None:
                    attempt_sched = dataclasses.replace(
                        attempt_sched, faults=faults.refold(restart))
                recovery_log.append({
                    "restart": restart,
                    "unit": err.unit,
                    "cost": err.cost,
                    "reason": err.reason,
                    "resumed_from": done,
                    "step_a": a,
                })

    def refit(
        self,
        result: FitResult,
        problem: CompletionProblem | None = None,
        schedule: Union[str, Schedule, None] = None,
        *,
        seed: int = 0,
        reset_clock: bool = False,
        **schedule_overrides,
    ) -> FitResult:
        """Warm-start refresh from a finished fit — the incremental half of
        the streaming loop.

        Resumes from ``result``'s trained ``(U, W)`` against ``problem``
        (typically ``result.problem.append(...)``'s output; defaults to
        ``result.problem``) and runs only the cheap incremental rounds:
        ``schedule`` defaults to :class:`~repro_torch.mc.Incremental`, a
        short wave run.  The iteration clock ``t`` carries over, so the
        γ_t = a/(1+bt) step size continues its decay; ``reset_clock=True``
        restarts it for appends that shift the data hard.  The refreshed
        ``FitResult`` feeds ``ServingEngine.refresh``."""

        if problem is None:
            problem = result.problem
        if not isinstance(problem, CompletionProblem):
            raise TypeError(
                f"Trainer.refit expects a CompletionProblem, got "
                f"{type(problem).__name__}"
            )
        if problem.spec != result.problem.spec:
            raise ValueError(
                f"refit needs matching factor shapes: new problem grid "
                f"{problem.spec} != fitted grid {result.problem.spec}; a "
                f"reshaped problem needs a cold Trainer.fit"
            )
        state = result.state
        if reset_clock:
            state = state._replace(t=state.t * 0)
        if schedule is None:
            schedule = "incremental"
        return self.fit(problem, schedule, seed=seed, state=state,
                        **schedule_overrides)
