"""Execution schedules for ``Trainer.fit``.

Port of ``repro.mc.schedules``: every schedule consumes the same
``CompletionProblem`` + ``GossipMCConfig`` + ``torch.Generator`` and
produces the same ``(State, history)`` pair.

    Sequential  — Algorithm 1 verbatim: one random structure per iteration
    Wave        — ≤8 conflict-free parity waves per round
    FullGD      — deterministic limit: all structures at once (GD on L)
    Incremental — short warm-start Wave run, ``Trainer.refit``'s default
    Gossip      — rounds over a grid of torch.distributed ranks, factor
                  edges exchanged point to point; full or minibatch
                  (``batch=``) f-gradients, faults, asynchronous rounds

``run(problem, cfg, generator, state=..., done=0, eval_cb=None)`` starts
from ``state``; ``done`` (in the schedule's own units — iterations or
rounds) resumes a checkpointed run, and ``eval_cb(unit, cost, state,
generator)`` fires at every eval boundary (the restart-exact checkpoint
hook).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.core import gossip as core_gossip
from repro_torch.core import sequential as core_sequential
from repro_torch.core import waves as core_waves
from repro_torch.core.state import State
from repro_torch.faults.plan import AGE_NEVER, edges_exist
from repro_torch.mc.problem import CompletionProblem
from repro_torch.mesh.plan import MeshPlan
from repro_torch.sparse.store import MinibatchStream, minibatch_grad_scale

EvalCb = Optional[Callable[[int, float, State, torch.Generator], None]]


class Schedule:
    """Strategy interface: subclasses define ``name`` and ``run``;
    ``runs_on_tiles`` says whether ``run`` takes a problem whose rank
    holds only its tile of the blocks."""

    name = "abstract"
    runs_on_tiles = False

    def run(self, problem: CompletionProblem, cfg: GossipMCConfig,
            generator: torch.Generator, *, state: State, done: int = 0,
            eval_cb: EvalCb = None) -> tuple[State, list[tuple[int, float]]]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sequential(Schedule):
    """Paper Algorithm 1: one uniformly sampled structure per iteration."""

    num_iters: int = 20_000
    eval_every: int = 0

    name = "sequential"

    def run(self, problem, cfg, generator, *, state, done=0, eval_cb=None):
        eng = problem.engine
        return core_sequential._fit(
            problem.data, problem.spec, cfg, generator,
            num_iters=self.num_iters, eval_every=self.eval_every,
            state=state, method=eng.method, chunk=eng.chunk, done=done,
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

    def run(self, problem, cfg, generator, *, state, done=0, eval_cb=None):
        eng = problem.engine
        return core_waves._fit(
            problem.data, problem.spec, cfg, generator,
            num_rounds=self.num_rounds, eval_every=self.eval_every,
            mode=self._mode, state=state, method=eng.method,
            chunk=eng.chunk, start_round=done, progress_cb=eval_cb,
        )


@dataclasses.dataclass(frozen=True)
class FullGD(Wave):
    """Deterministic limit: every structure at once = GD on the collapsed
    objective L."""

    name = "full"
    _mode = "full"


@dataclasses.dataclass(frozen=True)
class Incremental(Wave):
    """Warm-start refresh rounds — the default of ``Trainer.refit``.

    The same wave updates as :class:`Wave`, sized for the streaming loop:
    after an append the factors are already near the new optimum, so a
    short run of rounds recovers the cold fit's quality at a fraction of
    the iterations.  Only the default size differs; resuming from a
    trained ``State`` is what makes it incremental."""

    num_rounds: int = 40
    eval_every: int = 0

    name = "incremental"


@dataclasses.dataclass(frozen=True)
class Gossip(Schedule):
    """Synchronous full-GD rounds over a grid of ``torch.distributed``
    ranks: each rank steps its tile of the (p, q) block grid, factor edges
    travel to the four grid neighbours point to point, and bounded
    staleness and int8/top-k message compression ride on the exchange.

    The plan comes from ``plan=`` on the schedule, then the problem's own
    ``CompletionProblem.plan``, else the 1×1 plan — the degenerate case,
    which runs the FullGD step op for op.  Under an R×C plan the problem
    must have been built with that plan (each rank holds its tile) inside
    a process group of R·C ranks (``repro_torch.launch.gossip``); the
    returned ``State`` is the global one, all-gathered from the tiles.

    ``batch=<int>`` switches to stochastic rounds: every round samples a
    fresh per-block minibatch of the sparse store through a restart-exact
    ``MinibatchStream`` (its seed derived from the fit's generator seed,
    or ``batch_seed``; the step's positions keyed on the absolute round)
    and feeds it to the step with the ``minibatch_grad_scale`` correction
    of the full store, so a round costs O(batch) a rank instead of
    O(nnz).  Every rank draws the whole grid's positions and keeps its
    tile, so an R×C grid runs the 1×1 stream.  Requires the sparse layout.

    ``faults=FaultPlan(...)`` turns on deterministic fault injection
    (DESIGN.md §13): dropped/straggling edges reuse the last received
    halo, ages past ``max_staleness`` degrade the seam to the local-only
    gradient, and each chunk's fault counts, summed over the ranks,
    stream into ``gossip_edges_dropped_total``,
    ``gossip_stale_rounds_total``, ``gossip_straggled_edges_total`` and
    the ``gossip_halo_age`` histogram.

    ``async_rounds=True`` is the non-blocking regime (DESIGN.md §15):
    the halo exchange fires every ``exchange_every``-th absolute round
    only; skipped rounds run on the last received halos, bounded by
    ``max_staleness``.  ``train_gossip_halo_bytes_total`` counts only the
    rounds that exchanged, ``gossip_skipped_exchanges_total`` the others.

    Checkpoint resume (``done``) restores the factors only; the halos are
    rebuilt on the first resumed exchange, so a resume of a synchronous
    fit with ``staleness == 1``, no compression and no faults is exact.
    Stale halos are not persisted (a restarted node re-gossips)."""

    num_rounds: int = 200
    eval_every: int = 0
    plan: Any = None
    staleness: int = 1
    compression: str = "none"
    topk_fraction: float = 0.25
    faults: Any = None
    max_staleness: int = 3
    batch: Optional[int] = None
    batch_seed: Optional[int] = None
    async_rounds: bool = False
    exchange_every: int = 1

    name = "gossip"
    runs_on_tiles = True

    def _plan(self, problem) -> MeshPlan:
        p, q = problem.spec.p, problem.spec.q
        if self.plan is not None:
            return MeshPlan.build(p, q, self.plan)
        if problem.plan is not None:
            return problem.plan
        return MeshPlan.build(p, q)

    def run(self, problem, cfg, generator, *, state, done=0, eval_cb=None):
        eng = problem.engine
        plan = self._plan(problem)
        spec = problem.spec
        if self.batch is not None and problem.layout != "sparse":
            raise ValueError(
                "Gossip(batch=) needs layout='sparse': stochastic rounds "
                "sample the sparse store"
            )

        def step_for(n: int):
            if n not in steps:
                steps[n] = core_gossip.make_gossip_step(
                    (spec.p, spec.q), cfg, plan=plan,
                    staleness=self.staleness, compression=self.compression,
                    topk_fraction=self.topk_fraction, steps_per_call=n,
                    layout=problem.layout, method=eng.method,
                    chunk=eng.chunk, faults=self.faults,
                    max_staleness=self.max_staleness,
                    async_rounds=self.async_rounds,
                    exchange_every=self.exchange_every, batch=self.batch,
                )
            return steps[n]

        steps: dict[int, Any] = {}
        eval_every = self.eval_every or self.num_rounds
        # validates the options; a minibatch step takes one round a call
        step_for(1 if self.batch is not None
                 else min(eval_every, self.num_rounds))
        if not plan.is_single_device and problem.plan != plan:
            raise ValueError(
                f"Gossip over a {plan.row_size}x{plan.col_size} rank grid "
                "needs the problem's tiles: build it with "
                "CompletionProblem.from_*(..., plan=plan)")
        if tuple(state.U.shape[:2]) == (spec.p, spec.q):
            state = plan.local_slice(state)      # the global draw -> my tile
        # round0=done keeps the FaultPlan and async clocks aligned on resume
        carry = core_gossip.init_carry(state, round0=done)
        device = state.U.device

        stream = scale = None
        if self.batch is not None:
            # the stream's seed is a pure function of the fit's seed, so
            # a rerun or a resume replays the identical per-round
            # minibatches
            seed = (self.batch_seed if self.batch_seed is not None else int(
                np.random.SeedSequence([generator.initial_seed(), 0x0BA7C4])
                .generate_state(1, np.uint64)[0]))
            stream = MinibatchStream(problem.data, self.batch, seed=seed,
                                     plan=plan)
            scale = minibatch_grad_scale(problem.data, self.batch)

        # exact comm accounting from the plan's geometry: what one exchange
        # moves over the wires (0 on a 1x1 plan); per chunk only the rounds
        # that exchanged count
        exchange_bytes = core_gossip.halo_bytes_per_round(
            plan, spec.mb, spec.nb, spec.r, self.compression,
        )["total_bytes"]
        rounds_c = obs.counter("train_gossip_rounds_total")
        bytes_c = obs.counter("train_gossip_halo_bytes_total")
        round_h = obs.histogram("train_gossip_round_seconds")
        track_stats = self.faults is not None or self.async_rounds
        if track_stats:
            dropped_c = obs.counter("gossip_edges_dropped_total")
            stale_c = obs.counter("gossip_stale_rounds_total")
            strag_c = obs.counter("gossip_straggled_edges_total")
            age_h = obs.histogram("gossip_halo_age")
            seen = core_gossip.FaultStats()
        if self.async_rounds:
            skipped_c = obs.counter("gossip_skipped_exchanges_total")

        history: list[tuple[int, float]] = []
        rd = done
        while rd < self.num_rounds:
            n = min(eval_every - rd % eval_every, self.num_rounds - rd)
            with obs.span("gossip.rounds") as sp:
                if stream is None:
                    carry = step_for(n)(problem.data, carry)
                else:
                    # one sampled store a round, keyed on the absolute round
                    step = step_for(1)
                    for t in range(rd, rd + n):
                        carry = step(stream.batch_at(t), scale, carry)
                sp.outputs(carry.state)
            round_h.observe(sp.seconds / n)
            rounds_c.inc(n)
            if self.async_rounds:
                # exchanges fire on absolute rounds rnd % exchange_every
                # == 0: count the chunk's exactly
                n_ex = core_gossip.exchange_rounds_in(rd, n,
                                                      self.exchange_every)
                skipped_c.inc(n - n_ex)
            else:
                # the staleness clock restarts with every chunked call
                n_ex = core_gossip.exchange_rounds_in(0, n, self.staleness)
            bytes_c.inc(n_ex * exchange_bytes)
            if track_stats:
                # the carry's counts are this rank's, cumulative: one
                # all-gather a chunk sums the deltas over the ranks and
                # brings every rank's ages
                delta = [a - b for a, b in zip(carry.stats, seen)]
                seen = carry.stats
                grid = core_gossip.gather_ints(
                    plan, delta + carry.halos.age[0, 0].tolist(), device)
                dropped_c.inc(int(grid[:, 0].sum()))
                stale_c.inc(int(grid[:, 1].sum()))
                strag_c.inc(int(grid[:, 2].sum()))
                self._observe_ages(age_h, plan, grid[:, 3:])
            rd += n
            cost = float(core_gossip.distributed_cost(
                problem.data, carry.state, cfg.lam, plan, method=eng.method))
            history.append((int(carry.state.t), cost))
            if eval_cb:
                eval_cb(rd, cost, core_gossip.gather_state(plan, carry.state),
                        generator)
        return core_gossip.gather_state(plan, carry.state), history

    @staticmethod
    def _observe_ages(age_h, plan, ages) -> None:
        """Sample each rank's per-direction halo age (``ages``: (ranks, 4)
        in rank order) into the histogram, skipping directions without a
        neighbour and the never-received sentinel."""

        exists = edges_exist(plan)
        for k in range(plan.num_devices):
            for d in range(4):
                if exists[k, d] and ages[k, d] < AGE_NEVER:
                    age_h.observe(float(ages[k, d]))


_BY_NAME = {
    "sequential": Sequential,
    "wave": Wave,
    "full": FullGD,
    "full_gd": FullGD,
    "incremental": Incremental,
    "gossip": Gossip,
}


def make_schedule(spec: Union[str, Schedule], **overrides) -> Schedule:
    """Resolve a schedule: pass a ``Schedule`` through, or build one from
    its name (``"sequential" | "wave" | "full" | "incremental" |
    "gossip"``) with default
    sizes overridable by keyword."""

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
