"""Start an R×C grid of ``torch.distributed`` ranks and run a gossip fit
in each.

    from repro_torch.launch.gossip import FitJob, ProblemRecipe, fit_on_grid

    recipe = ProblemRecipe("lowrank_problem", dict(m=500, n=500, r=5,
                                                   density=0.2, seed=1),
                           p=4, q=4, rank=5)
    out, = fit_on_grid([FitJob(recipe, cfg, Gossip(num_rounds=300))],
                       grid=(2, 2))
    out["U"], out["history"], out["ms_per_round"]

``fit_on_grid`` runs its jobs one after the other in one grid of
processes, which pays its start-up once; ``run_on_grid`` runs any
picklable ``fn(rank, device, *args)`` on every rank.  A job may carry
picklable callbacks (``Checkpoint`` on a directory, ``DivergenceGuard``,
:class:`StopAt`), a ``RecoveryPolicy`` and a checkpoint to resume from;
each rank gets its own copy of them.

Each rank is a process started by ``torch.multiprocessing`` (forked from
a ``forkserver`` that imported torch once and holds no CUDA context) that
joins a process group through a ``FileStore`` in a fresh temporary
directory (no network).  The backend is ``nccl`` when every rank has a
card of its own and ``gloo`` otherwise (on the CPU, or ranks sharing one
card, whose edges ``core.gossip.HaloExchange`` then stages through pinned
host buffers).  Rank k runs on ``cuda:{k % device_count}`` unless
``device="cpu"``.  Every wait has a deadline: a rank that fails or hangs
ends the whole grid with an error instead of a hang.  The forkserver
outlives a grid, so that the next one skips its start-up; ``shutdown``
stops it, and runs at interpreter exit once a grid has started, so a
program that ran grids leaves no process behind.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import math
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import data as data_mod
from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.convert import state_from_numpy
from repro_torch.faults import DivergenceError
from repro_torch.mc import Callback, CompletionProblem, Trainer
from repro_torch.mesh.plan import MeshPlan


# after one rank fails, how long the others get to report theirs
FAIL_GRACE_S = 10.0
# a collective's limit on a grid without a deadline: a rank may do long
# host work (a profile's processing, a checkpoint's write) while the
# others wait at the next collective, which the backend's default limit
# (10 minutes under nccl) would end
NO_DEADLINE = datetime.timedelta(days=7)


def shutdown() -> None:
    """Stop the forkserver that ``run_on_grid`` starts and
    multiprocessing's resource tracker, and wait until both have exited.
    A later grid starts them anew."""

    # multiprocessing offers no public call that stops them; these are the
    # ones its own tests use
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


def pick_backend(device: str, world: int) -> str:
    """``nccl`` when each of ``world`` ranks has a card of its own,
    ``gloo`` otherwise."""

    if device != "cpu" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _entry(fn, rank, world, init_file, backend, device, timeout, results,
           spawned, args):
    try:
        marks = {"entered_s": time.time() - spawned}
        dev = torch.device("cpu") if device == "cpu" else torch.device(
            "cuda", rank % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.empty(1, device=dev)          # the context, timed apart
        else:
            torch.set_num_threads(1)
        marks["device_s"] = time.time() - spawned
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=NO_DEADLINE if timeout is None
            else datetime.timedelta(seconds=timeout))
        marks["group_s"] = time.time() - spawned
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        marks["done_s"] = time.time() - spawned
        results.put((rank, True, (out, marks)))
    except BaseException:                       # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_on_grid(fn: Callable, grid: tuple[int, int], *args,
                device: str = "cuda", timeout: float | None = 600.0,
                marks: list | None = None) -> list:
    """Run ``fn(rank, device, *args)`` in R·C processes, one a rank, and
    return their results in rank order.  ``fn`` must be picklable (a
    module-level function).  Raises if a rank raises (with every failed
    rank's traceback), or if the grid has not finished within ``timeout``
    seconds (also each collective's limit; ``None``: no deadline, and a
    collective waits up to ``NO_DEADLINE``); every process is ended either
    way.  ``marks``, if given, gets
    each rank's seconds from the spawn to its entry (``entered_s``), its
    device ready (``device_s``), the process group formed (``group_s``)
    and ``fn`` done (``done_s``)."""

    world = grid[0] * grid[1]
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device=\"cpu\" to "
            "run the ranks on the CPU")
    backend = pick_backend(device, world)
    # ranks fork from a server that has imported torch and this module
    # once, and has no CUDA context of its own
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", __name__])
    atexit.unregister(shutdown)     # registered once, however many grids
    atexit.register(shutdown)
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gossip-grid-")
    spawned = time.time()
    procs = [ctx.Process(
        target=_entry, daemon=True,
        args=(fn, rank, world, os.path.join(tmp, "store"), backend, device,
              timeout, results, spawned, args)) for rank in range(world)]
    deadline = math.inf if timeout is None else time.monotonic() + timeout
    out: dict[int, Any] = {}
    failed: dict[int, str] = {}
    try:
        for proc in procs:
            proc.start()
        while len(out) + len(failed) < world:
            if failed:      # the others fail soon after; name them all
                deadline = min(deadline, time.monotonic() + FAIL_GRACE_S)
            try:
                rank, ok, payload = results.get(timeout=None if math.isinf(
                    deadline) else max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                if failed:
                    break
                raise TimeoutError(
                    f"the {grid[0]}x{grid[1]} rank grid did not finish in "
                    f"{timeout:.0f} s; ranks done: {sorted(out)}") from None
            if ok:
                out[rank] = payload
            else:
                failed[rank] = payload
        if failed:
            raise RuntimeError("".join(
                f"rank {rank} failed:\n{tb}"
                for rank, tb in sorted(failed.items())))
        for proc in procs:
            proc.join(timeout=None if math.isinf(deadline) else max(
                1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(5)
            if proc.is_alive():
                proc.kill()
                proc.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if marks is not None:
        marks.extend(out[k][1] for k in range(world))
    return [out[k][0] for k in range(world)]


@dataclasses.dataclass(frozen=True)
class ProblemRecipe:
    """A picklable recipe each rank builds its tile from: a dataset of
    ``repro_torch.data`` made from its seed, then
    ``CompletionProblem.from_dataset``."""

    dataset: str                      # "lowrank_problem" | "movielens_proxy"
    dataset_kw: dict
    p: int
    q: int
    rank: int
    layout: str = "dense"
    mean_center: bool = False

    def build(self, plan=None, device="cuda") -> CompletionProblem:
        make = {"lowrank_problem": data_mod.lowrank_problem,
                "movielens_proxy": data_mod.movielens_proxy}[self.dataset]
        return CompletionProblem.from_dataset(
            make(**self.dataset_kw), self.p, self.q, self.rank,
            layout=self.layout, mean_center=self.mean_center, plan=plan, device=device)


# the f-gradient kernels' wrappers, whose launches each rank reports
def _wrappers():
    from repro_torch.kernels.masked_factor_grad import ops as mfg
    from repro_torch.kernels.sddmm import ops as sddmm

    return {"sddmm_segment_grad": sddmm.sddmm_segment_grad,
            "sddmm_factor_grad": sddmm.sddmm_factor_grad,
            "masked_factor_grad": mfg.masked_factor_grad}


class FitStopped(Exception):
    """Raised by :class:`StopAt` to end a fit at an eval boundary."""

    def __init__(self, unit: int):
        super().__init__(f"fit stopped at unit {unit}")
        self.unit = unit


class StopAt(Callback):
    """Ends the fit at the first eval boundary at or past ``unit`` by
    raising :class:`FitStopped`, after the callbacks before it in the
    list have seen that boundary (a ``Checkpoint`` placed before it has
    saved it): a killed fit, for resume tests."""

    def __init__(self, unit: int):
        self.unit = unit

    def on_eval(self, unit, cost, state, key) -> None:
        if unit >= self.unit:
            raise FitStopped(unit)


# the counters each rank reports per job (rank 0's are the grid totals
# for the gossip_* fault counters, which the schedule sums over ranks)
COUNTERS = ("train_gossip_rounds_total", "train_gossip_halo_bytes_total",
            "train_gossip_staged_bytes_total", "gossip_edges_dropped_total",
            "gossip_stale_rounds_total", "gossip_straggled_edges_total",
            "gossip_skipped_exchanges_total", "fit_recoveries_total")


def _stacks() -> dict:
    """Launches so far by the stack's leading shape ("2x2"), of the
    wrappers that count them."""

    return {k: {"x".join(map(str, lead)): n
                for lead, n in fn.by_stack.items()}
            for k, fn in _wrappers().items() if hasattr(fn, "by_stack")}


@dataclasses.dataclass(frozen=True)
class FitJob:
    """One fit of :func:`fit_on_grid`: ``state`` is an optional global
    initial ``(U, W, t)`` of numpy arrays, else every rank draws the same
    one from the trainer's default seed.  ``callbacks`` are picklable
    ``Trainer`` callbacks (each rank gets its own copy), ``recovery`` a
    ``RecoveryPolicy`` and ``resume_from`` a checkpoint directory, as
    ``Trainer.fit`` takes them."""

    recipe: ProblemRecipe
    cfg: GossipMCConfig
    schedule: Any
    state: Any = None
    callbacks: tuple = ()
    recovery: Any = None
    resume_from: Any = None


def _fit_rank(rank, device, jobs, grid, warmup_rounds):
    outs, problems = [], []          # (recipe, its tile), built once
    for job in jobs:
        recipe = job.recipe
        t0 = time.perf_counter()
        built = [tile for rec, tile in problems if rec == recipe]
        if built:
            problem = built[0]
        else:
            plan = MeshPlan.build(recipe.p, recipe.q, grid=grid)
            problem = recipe.build(plan, device)
            problems.append((recipe, problem))
        st0 = None if job.state is None else state_from_numpy(*job.state,
                                                              device)
        t1 = time.perf_counter()
        if warmup_rounds:
            Trainer(job.cfg).fit(problem, dataclasses.replace(
                job.schedule, num_rounds=warmup_rounds, eval_every=0),
                state=st0)
        t2 = time.perf_counter()
        obs.reset()
        launches = {k: fn.launches for k, fn in _wrappers().items()}
        stacks = _stacks()
        out = {"rank": rank, "build_s": t1 - t0, "warmup_s": t2 - t1,
               "history": [], "recovery_log": [], "t": None,
               "stopped_at": None, "diverged": None}
        try:
            res = Trainer(job.cfg, callbacks=job.callbacks).fit(
                problem, job.schedule, state=st0,
                resume_from=job.resume_from, recovery=job.recovery)
        except FitStopped as stop:
            out["stopped_at"] = stop.unit
        except DivergenceError as err:
            out["diverged"] = {"unit": err.unit, "cost": err.cost,
                               "reason": err.reason, "message": str(err)}
        else:
            out.update(wall_time=res.wall_time, history=res.history,
                       t=res.t, recovery_log=res.recovery_log)
            if rank == 0:
                out["U"] = res.state.U.cpu().numpy()
                out["W"] = res.state.W.cpu().numpy()
        out["wall_time"] = out.get("wall_time", time.perf_counter() - t2)
        out["counters"] = {name: obs.counter(name).value
                           for name in COUNTERS}
        ages = obs.histogram("gossip_halo_age")
        out["halo_age"] = {"count": ages.count, "sum": ages.sum}
        out["launches"] = {k: fn.launches - launches[k]
                           for k, fn in _wrappers().items()}
        out["launches_by_stack"] = {
            k: {lead: n - stacks[k].get(lead, 0) for lead, n in got.items()
                if n > stacks[k].get(lead, 0)}
            for k, got in _stacks().items()}
        outs.append(out)
    return outs


def fit_on_grid(jobs, *, grid: tuple[int, int], device: str = "cuda",
                warmup_rounds: int = 0, timeout: float = 600.0) -> list[dict]:
    """Run each ``FitJob`` — ``Trainer(cfg).fit(problem, schedule)`` with
    every rank holding its tile of the recipe's problem — in one R×C grid
    of processes, one job after the other.

    ``warmup_rounds`` runs a short fit before each, so that the timed one
    does not pay one-time loading.  Per job: rank 0's global factors
    ``U``/``W``, cost ``history``, ``t``, ``recovery_log`` and counters
    (:data:`COUNTERS`; the ``gossip_*`` fault counters are the grid's
    sums) and the ``gossip_halo_age`` histogram's ``halo_age`` count and
    sum (every rank's ages); ``stopped_at`` (the unit a :class:`StopAt`
    ended it at) or ``diverged`` (the ``DivergenceError``'s unit, cost,
    reason and message) where the fit did not finish, and then no
    factors; the fit's
    ``wall_time`` and ``ms_per_round``, and ``build_s``/``warmup_s``
    (slowest rank); summed over the ranks, ``staged_bytes_per_round``, the
    f-gradient kernels' ``launches`` and, for the segment and dense
    kernels, ``launches_by_stack``; and the grid's ``startup``
    marks (``run_on_grid``'s, slowest rank)."""

    jobs = list(jobs)
    marks: list = []
    ranks = run_on_grid(_fit_rank, grid, jobs, grid, warmup_rounds,
                        device=device, timeout=timeout, marks=marks)
    startup = {key: max(m[key] for m in marks)
               for key in ("entered_s", "device_s", "group_s", "done_s")}
    results = []
    for k in range(len(jobs)):
        per_rank = [r[k] for r in ranks]
        out = dict(per_rank[0])
        rounds = out["counters"]["train_gossip_rounds_total"]
        out["wall_time"] = max(r["wall_time"] for r in per_rank)
        out["ms_per_round"] = 1e3 * out["wall_time"] / max(rounds, 1)
        staged = sum(r["counters"]["train_gossip_staged_bytes_total"]
                     for r in per_rank)
        out["staged_bytes_per_round"] = staged / max(rounds, 1)
        out["staged"] = staged > 0
        out["launches"] = {name: sum(r["launches"][name] for r in per_rank)
                           for name in out["launches"]}
        out["launches_by_stack"] = {
            name: {lead: sum(r["launches_by_stack"][name].get(lead, 0)
                             for r in per_rank)
                   for lead in {ld for r in per_rank
                                for ld in r["launches_by_stack"][name]}}
            for name in out["launches_by_stack"]}
        out["backend"] = pick_backend(device, grid[0] * grid[1])
        out["build_s"] = max(r["build_s"] for r in per_rank)
        out["warmup_s"] = max(r["warmup_s"] for r in per_rank)
        out["startup"] = startup
        results.append(out)
    return results
