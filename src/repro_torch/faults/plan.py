"""``FaultPlan`` — deterministic, seed-keyed fault injection for gossip.

Port of ``repro.faults.plan``.  A pure-function description of which halo
edges fail at which round, so every injected failure replays exactly.
Every decision is a function of ``(key, restart, round, edge)`` only:

    plan = FaultPlan(key=0, p_drop_edge=0.2, p_straggle=0.05)
    drops, straggles = plan.edge_events(rnd, edge_index)   # (4,) bools each

``edge_index`` identifies the *receiver* (its linear rank in the R×C
grid); the 4 lanes are the halo directions in :data:`DIRECTIONS` order.
The decisions are evaluated **on the host**: numpy booleans, the same in
every rank's process, on the CPU and with a card, and in :meth:`replay`.
The reference chains ``jax.random.fold_in`` (threefry), which torch
cannot reproduce; the port draws each decision from a PCG64 stream seeded
by ``SeedSequence([key, restart, rnd, edge_index])``: four uniforms for
the drops, then four for the straggles.  :meth:`from_masks` builds a plan
that replays given masks instead (the parity tests hand it the
reference's ``replay`` output).

Failure semantics (wired in ``core/gossip.py``):

* **drop** — the receiver does not get this round's edge message and
  keeps the *last received* halo; the halo's age grows.  Past
  ``max_staleness`` the seam degrades to the block's local-only gradient.
* **straggle** — the neighbour is late; the synchronous simulation reuses
  the stale halo like a drop, accounted separately.  ``straggler_scale``
  is the modelled slowdown of a straggling round, pure accounting.
* **nan_at** — a one-shot corruption: at absolute round ``nan_at`` every
  delivered halo message carries NaN, which trips the ``DivergenceGuard``
  at the next eval boundary.  ``refold`` clears it.

See DESIGN.md §13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

# Halo directions, in the order core/gossip.py exchanges them.  The age
# lane layout of ``HaloState.age`` and every (4,)-shaped fault mask use
# this order.
DIRECTIONS = ("left_u", "right_u", "up_w", "down_w")

# Sentinel age for "never received" — any bound check fails against it,
# so an un-gossiped zero halo can never pull a seam toward zero.
AGE_NEVER = 1_000_000


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-keyed fault schedule for the gossip plane.

    ``key`` is a non-negative int seed.  Probabilities are per round, per
    directed edge, evaluated independently at each exchange round.
    ``restart`` tags the recovery generation: :meth:`refold` bumps it, so
    a self-healed fit draws a fresh (but still deterministic) fault
    stream instead of replaying the one that killed it.  ``masks``, set
    only by :meth:`from_masks`, replaces the drawn stream."""

    key: Any = 0
    p_drop_edge: float = 0.0
    p_straggle: float = 0.0
    straggler_scale: float = 4.0
    nan_at: Optional[int] = None
    restart: int = 0
    masks: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self) -> None:
        for name in ("p_drop_edge", "p_straggle"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{name} is a probability, got {v}"
                )
        if self.straggler_scale < 1.0:
            raise ValueError(
                f"straggler_scale models a slowdown (>= 1), got "
                f"{self.straggler_scale}"
            )
        if self.nan_at is not None and self.nan_at < 0:
            raise ValueError(f"nan_at must be a round index, got {self.nan_at}")
        if not isinstance(self.key, (int, np.integer)) or self.key < 0:
            raise ValueError(
                f"key must be a non-negative int seed, got {self.key!r}")

    @classmethod
    def from_masks(cls, drops, straggles, nan_at: Optional[int] = None,
                   **kw) -> "FaultPlan":
        """A plan whose events are the given bool arrays, shaped
        ``(rounds, num_edges, 4)``: ``edge_events(rnd, e)`` returns
        ``drops[rnd, e], straggles[rnd, e]``.  The masks replay unchanged
        whatever the restart."""

        drops = np.asarray(drops, bool)
        straggles = np.asarray(straggles, bool)
        if drops.ndim != 3 or drops.shape[-1] != 4 \
                or straggles.shape != drops.shape:
            raise ValueError(
                f"masks must be two (rounds, num_edges, 4) arrays, got "
                f"{drops.shape} and {straggles.shape}")
        return cls(nan_at=nan_at, masks=(drops, straggles), **kw)

    # ------------------------------------------------------------------ #
    # the pure fault function
    # ------------------------------------------------------------------ #

    def edge_events(self, rnd: int, edge_index: int):
        """(dropped, straggled): two (4,) numpy bool vectors for the
        receiver ``edge_index`` at absolute round ``rnd`` — one lane per
        :data:`DIRECTIONS` entry.  Pure in ``(key, restart, rnd,
        edge_index)``."""

        if self.masks is not None:
            drops, straggles = self.masks
            if rnd >= drops.shape[0] or edge_index >= drops.shape[1]:
                raise IndexError(
                    f"round {rnd}, edge {edge_index} is outside the plan's "
                    f"masks of {drops.shape[0]} rounds x {drops.shape[1]} "
                    "edges")
            return drops[rnd, edge_index].copy(), \
                straggles[rnd, edge_index].copy()
        seq = np.random.SeedSequence(
            [int(self.key), int(self.restart), int(rnd), int(edge_index)])
        u = np.random.Generator(np.random.PCG64(seq)).random(8)
        return u[:4] < self.p_drop_edge, u[4:] < self.p_straggle

    def nan_event(self, rnd: int) -> bool:
        """True at the one-shot corruption round (always False when
        ``nan_at`` is unset)."""

        return self.nan_at is not None and int(rnd) == self.nan_at

    # ------------------------------------------------------------------ #
    # replay + recovery
    # ------------------------------------------------------------------ #

    def replay(self, rounds: int, num_edges: int) -> dict:
        """Materialize the full fault schedule: bool arrays of shape
        (rounds, num_edges, 4) for drops and straggles — the *same*
        function the gossip step evaluates."""

        drops = np.zeros((rounds, num_edges, 4), bool)
        straggles = np.zeros((rounds, num_edges, 4), bool)
        for rnd in range(rounds):
            for e in range(num_edges):
                drops[rnd, e], straggles[rnd, e] = self.edge_events(rnd, e)
        return {"drops": drops, "straggles": straggles}

    def refold(self, restart: int) -> "FaultPlan":
        """The plan a self-healed fit resumes under: same probabilities,
        the stream keyed by the restart generation, and the one-shot
        ``nan_at`` corruption cleared (transient faults do not replay)."""

        return dataclasses.replace(self, restart=restart, nan_at=None)

    def expected_drops(self, plan, rounds: int) -> float:
        """Analytic E[dropped edges] over ``rounds`` on a ``MeshPlan``'s
        rank grid."""

        return self.p_drop_edge * plan.num_halo_edges * rounds


def edges_exist(plan) -> np.ndarray:
    """(num_devices, 4) bools: which halo directions of each rank of
    ``plan``'s R×C grid have a neighbour (boundary ranks have none
    outward)."""

    R, C = plan.row_size, plan.col_size
    exists = np.zeros((R * C, 4), bool)
    for di in range(R):
        for dj in range(C):
            exists[di * C + dj] = (dj > 0, dj < C - 1, di > 0, di < R - 1)
    return exists
