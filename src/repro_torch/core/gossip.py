"""Distributed gossip matrix completion over a grid of ``torch.distributed``
ranks (the synchronous schedule).

Port of ``repro.core.gossip``.  The p×q block grid is tiled over an R×C
grid of ranks (``MeshPlan``); rank k owns the contiguous tile of blocks
``plan.local_slice`` cuts.  Per round each rank

  1. exchanges factor *edges* with its 4 grid neighbours by point-to-point
     messages (``dist.batch_isend_irecv``; the reference's ``ppermute``):
     no all-reduce, no central server,
  2. computes the full local gradient of the collapsed objective L
     (``waves.full_gradients`` on its own block stack, so the f-gradient
     kernels run per rank) with the halos supplying the seam pairs,
  3. takes the γ_t step.

Bounded staleness (``staleness k``): halos are refreshed every k-th round
and reused in between.  Optional int8/top-k message compression
(``compress.py``) with error feedback rides on the exchange.

On a 1×1 plan there is no process group and no message: every seam is
interior and ``full_gradients`` handles it, so a round is the FullGD step
op for op.  With ``nccl`` each rank's card sends its edges directly; where
ranks share one card (``gloo``, which moves CPU tensors only) the four
edges are staged through pinned host buffers, and the bytes staged are
counted in ``train_gossip_staged_bytes_total``.

``batch=`` makes each round's f-gradients stochastic: the step consumes a
per-round minibatch store plus the ``minibatch_grad_scale`` correction
(nnz/batch per block of the full store), so a round costs O(batch)
instead of O(nnz) a rank.

Fault tolerance (``faults=FaultPlan(...)``, DESIGN.md §13): a dropped or
straggling edge message leaves the receiver on its **last received**
halo; ``HaloState.age`` counts rounds since each direction's receive,
and past ``max_staleness`` the seam degrades to the block's local-only
gradient.  Asynchronous rounds (``async_rounds=True``, DESIGN.md §15):
the exchange fires only every ``exchange_every``-th absolute round, and
the skipped rounds age the halos like drops.  Every decision (drop,
straggle, NaN injection, exchange or not, the gates) is a Python value
known on the host before the round starts, so none needs a read from
the card, and every rank agrees on whether an exchange happens without a
collective.  A drop is decided on the receiver's side after a symmetric
exchange: every rank still sends and receives all its edges, so the
point-to-point calls always pair.  The counters (``FaultStats``) are
host ints of the rank's own events.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.core import compress as C
from repro_torch.core import objective as obj
from repro_torch.core.state import Problem, State
from repro_torch.core.waves import full_gradients
from repro_torch.faults.plan import AGE_NEVER
from repro_torch.mesh.plan import MeshPlan, current_rank
from repro_torch.sparse.store import SparseProblem

# the halo directions, in faults.DIRECTIONS order; a message's tag is the
# receiver's direction
LEFT, RIGHT, UP, DOWN = range(4)


class HaloState(NamedTuple):
    """Cached neighbour edges on the rank's own tile: ``pl = p / R`` block
    rows, ``ql = q / C`` block columns.

    ``age`` counts rounds since each direction's halo was last received
    (0 = fresh, ``AGE_NEVER`` = never received), lanes in
    ``faults.DIRECTIONS`` order.  Every block of a tile shares one age.
    It is a host (CPU) tensor: the host decides the gates from it, so
    reading it never waits for the card.  Ages move under a
    ``FaultPlan`` and under ``async_rounds``; the plain synchronous path
    threads them through untouched."""

    left_u: torch.Tensor   # left neighbour's last block-col U   (pl, mb, r)
    right_u: torch.Tensor  # right neighbour's first block-col U (pl, mb, r)
    up_w: torch.Tensor     # upper neighbour's last block-row W  (ql, nb, r)
    down_w: torch.Tensor   # lower neighbour's first block-row W (ql, nb, r)
    age: torch.Tensor      # rounds since last receive, host int32 (pl, ql, 4)


class FaultStats(NamedTuple):
    """The rank's own fault counts since the carry was made (host ints;
    the ``Gossip`` schedule sums them over the ranks once a chunk into
    ``gossip_edges_dropped_total`` / ``gossip_stale_rounds_total`` /
    ``gossip_straggled_edges_total``)."""

    dropped: int = 0      # edge messages lost outright
    stale: int = 0        # rounds computed on >=1 stale halo
    straggled: int = 0    # edge messages late (reused-stale, counted apart)


class GossipCarry(NamedTuple):
    state: State               # the rank's tile of the factors
    halos: HaloState
    ef_u_last: torch.Tensor    # error-feedback residuals (compression)
    ef_u_first: torch.Tensor
    ef_w_last: torch.Tensor
    ef_w_first: torch.Tensor
    rnd: int                   # absolute gossip round
    stats: FaultStats


def host_collectives(device: torch.device, group=None) -> bool:
    """True where this rank's collectives over ``group`` (default: the
    default group) must move host tensors: a card under a backend other
    than ``nccl`` (``gloo`` takes CPU tensors only, and ranks that share
    one card cannot run ``nccl``)."""

    return device.type == "cuda" and dist.get_backend(group) != "nccl"


class HaloExchange:
    """One rank's edge exchange with its grid neighbours.

    ``__call__`` takes the four outgoing messages and returns the four
    received halos; a direction with no neighbour receives zeros (the
    caller leaves that seam out).  Staging through pinned host buffers is
    chosen here, from the backend and the device, never by catching an
    error."""

    def __init__(self, plan: MeshPlan, device: torch.device):
        self.rank = current_rank()
        R, Cc = plan.grid
        di, dj = plan.coords(self.rank)
        # peer rank of each receiving direction
        self.peers = (self.rank - 1 if dj > 0 else None,
                      self.rank + 1 if dj < Cc - 1 else None,
                      self.rank - Cc if di > 0 else None,
                      self.rank + Cc if di < R - 1 else None)
        self.staged = host_collectives(device)
        self._pinned: dict = {}

    def has(self, direction: int) -> bool:
        return self.peers[direction] is not None

    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.shape != like.shape:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def __call__(self, u_last, u_first, w_last, w_first):
        # (message, receiving direction at the peer, peer): my last U
        # column is my right neighbour's left halo, and so on
        sends = ((u_last, LEFT, self.peers[RIGHT]),
                 (u_first, RIGHT, self.peers[LEFT]),
                 (w_last, UP, self.peers[DOWN]),
                 (w_first, DOWN, self.peers[UP]))
        likes = (u_last, u_first, w_last, w_first)
        out = [torch.zeros_like(x) for x in likes]
        ops, recvs, staged = [], [], 0
        for msg, tag, peer in sends:
            if peer is None:
                continue
            msg = msg.contiguous()
            if self.staged:
                buf = self._host(("send", tag), msg)
                buf.copy_(msg)
                msg, staged = buf, staged + msg.numel() * msg.element_size()
            ops.append(dist.P2POp(dist.isend, msg, peer, tag=tag))
        for d in range(4):
            peer = self.peers[d]
            if peer is None:
                continue
            buf = self._host(("recv", d), out[d]) if self.staged else out[d]
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=d))
            recvs.append((d, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for d, buf in recvs:
            if self.staged:
                out[d].copy_(buf)
                staged += buf.numel() * buf.element_size()
        if staged:
            obs.counter("train_gossip_staged_bytes_total").inc(staged)
        return out


def exchange_halos(U, W, exchange: HaloExchange, compression="none",
                   ef=None, topk_fraction=0.25, age=None):
    """One gossip exchange; returns HaloState + updated error feedback.

    Messages: my last/first block column of U (to my right/left
    neighbour) and my last/first block row of W (to my lower/upper
    neighbour).  ``age`` is threaded into the returned HaloState
    untouched; when omitted, a fresh all-received age of 0 is used."""

    msgs = {"u_last": U[:, -1], "u_first": U[:, 0],
            "w_last": W[-1], "w_first": W[0]}
    new_ef = {}
    if compression != "none":
        for k in msgs:
            st = C.CompressState(ef[k]) if ef is not None else None
            msgs[k], stn = C.compress_message(msgs[k], compression, st,
                                              topk_fraction)
            new_ef[k] = stn.residual if stn is not None else None
    if age is None:
        age = torch.zeros(U.shape[:2] + (4,), dtype=torch.int32)
    left, right, up, down = exchange(msgs["u_last"], msgs["u_first"],
                                     msgs["w_last"], msgs["w_first"])
    return HaloState(left, right, up, down, age), new_ef


def _local_gradients(problem, U, W, halos: HaloState, exchange, rho, lam,
                     method="segment", chunk=None, f_scale=None, gates=None):
    """∇L on the local tile, seam terms from the halos; a seam without a
    neighbour (the grid's boundary, or every seam of a 1×1 plan) is left
    out.  ``f_scale`` (minibatch rounds) multiplies only the f-part.

    ``gates`` (fault/async path only): 4 host bools in DIRECTIONS order,
    edge-exists AND halo age within ``max_staleness``.  A closed gate
    substitutes the *halo operand* with the block's own edge, so the seam
    reads x − x = 0 and a NaN-poisoned stale halo cannot leak (a masked
    product would: 0 · NaN = NaN).  With every gate open the expression
    is the ungated one, op for op."""

    gU, gW = full_gradients(problem, U, W, rho=rho, lam=lam, method=method,
                            chunk=chunk, f_scale=f_scale)
    if exchange is None:
        return gU, gW
    left_h, right_h = halos.left_u, halos.right_u
    up_h, down_h = halos.up_w, halos.down_w
    if gates is not None:
        left_h = left_h if gates[LEFT] else U[:, 0]
        right_h = right_h if gates[RIGHT] else U[:, -1]
        up_h = up_h if gates[UP] else W[0]
        down_h = down_h if gates[DOWN] else W[-1]
    # seam pair (left neighbour's last col, my first col):
    # d/dU_mine = 2ρ(mine - theirs)
    if exchange.has(LEFT):
        gU[:, 0] += 2.0 * rho * (U[:, 0] - left_h)
    if exchange.has(RIGHT):
        gU[:, -1] += 2.0 * rho * (U[:, -1] - right_h)
    if exchange.has(UP):
        gW[0] += 2.0 * rho * (W[0] - up_h)
    if exchange.has(DOWN):
        gW[-1] += 2.0 * rho * (W[-1] - down_h)
    return gU, gW


def _merge_halos(prev: HaloState, fresh: HaloState, *, faults, exists,
                 edge_index: int, rnd: int, is_refresh: bool,
                 async_rounds: bool, max_staleness: int,
                 stats: FaultStats):
    """The fault/async half of a round, decided on the host: which fresh
    halos arrived, the NaN injection, the new ages, the seam gates and
    the updated counters.  ``exists`` are the rank's four directions with
    a neighbour; ``edge_index`` is the receiver's linear rank."""

    drops = straggles = np.zeros(4, bool)
    if faults is not None and is_refresh:
        # fault events count on exchange rounds only (async skips are
        # planned, not faults)
        drops, straggles = faults.edge_events(rnd, edge_index)
    exists = np.asarray(exists, bool)
    # a straggler is a late message: this synchronous simulation reuses
    # the stale halo exactly like a drop, accounted apart
    arrived = is_refresh & ~(drops | straggles)
    inject = faults is not None and faults.nan_event(rnd)
    prev_age = prev.age[0, 0].tolist()
    merged, ages = [], []
    for d in range(4):
        v = fresh[d] if arrived[d] else prev[d]
        if inject and exists[d]:
            v = torch.full_like(v, float("nan"))
        merged.append(v)
        if arrived[d]:
            ages.append(0)
        elif async_rounds or is_refresh:
            # a missed receive ages the halo (saturating); under
            # async_rounds every skipped round does, while a planned
            # synchronous keep round (staleness k) freezes it
            ages.append(min(prev_age[d] + 1, AGE_NEVER))
        else:
            ages.append(prev_age[d])
    age = torch.tensor(ages, dtype=torch.int32).expand(prev.age.shape)
    gates = tuple(bool(exists[d]) and ages[d] <= max_staleness
                  for d in range(4))
    stats = FaultStats(
        dropped=stats.dropped + int((drops & exists).sum()),
        stale=stats.stale + int(any(exists[d] and ages[d] >= 1
                                    for d in range(4))),
        straggled=stats.straggled + int((straggles & ~drops & exists).sum()),
    )
    return HaloState(*merged, age.contiguous()), gates, stats


def make_gossip_step(
    spec_pq: tuple[int, int],
    cfg: GossipMCConfig,
    *,
    plan: MeshPlan | None = None,
    staleness: int = 1,
    compression: str = "none",
    topk_fraction: float = 0.25,
    steps_per_call: int = 1,
    layout: str = "dense",
    method: str = "segment",
    chunk: int | None = None,
    faults=None,
    max_staleness: int = 3,
    async_rounds: bool = False,
    exchange_every: int = 1,
    batch: int | None = None,
):
    """Build the gossip round: ``step(problem, carry) -> carry`` advances
    ``steps_per_call`` rounds on this rank's tile.

    ``problem`` is the rank's tile of a dense ``Problem`` or of the sparse
    store (``layout`` says which, and is checked against it); ``method``/
    ``chunk`` select the sparse gradient engine.  The reference's
    ``use_kernel`` switch has no twin: the tensors' device decides (the
    kernels on the card, their plain versions on the CPU).  The plan's
    rank grid must match the process group's.

    ``batch=<int>`` makes the round stochastic: the step becomes
    ``step(problem, f_scale, carry)`` for one round, where ``problem`` is
    the round's minibatch store (``MinibatchStream.batch_at``) and
    ``f_scale`` the ``minibatch_grad_scale`` of the *full* store (the
    rank's tile of it).  It needs the sparse layout and
    ``steps_per_call=1``.

    ``faults`` takes a ``repro_torch.faults.FaultPlan``; each exchange
    round it draws drop/straggle events keyed on ``(carry.rnd,
    receiver rank)`` and a missed edge keeps the last received halo.
    Once a direction's ``HaloState.age`` exceeds ``max_staleness``, that
    seam is gated out of the gradient.  With every event false the step
    is the ``faults=None`` step bit for bit.  Faults + compression is
    rejected: dropping a compressed message after its error-feedback
    update would corrupt the residuals.

    ``async_rounds=True`` is the non-blocking regime (DESIGN.md §15):
    exchanges fire only when ``carry.rnd % exchange_every == 0`` (the
    *absolute* round, so chunked calls and resumed fits keep one
    schedule), skipped rounds compute against the last received halos,
    and every round since a receive ages the halo.  ``exchange_every=1,
    max_staleness=0`` without ``batch`` is the synchronous step bit for
    bit."""

    p, q = spec_pq
    if exchange_every < 1:
        raise ValueError(f"exchange_every must be >= 1, got {exchange_every}")
    if async_rounds and staleness != 1:
        raise ValueError(
            "async_rounds replaces the synchronous staleness schedule with "
            "exchange_every; leave staleness=1"
        )
    if not async_rounds and exchange_every != 1:
        raise ValueError(
            "exchange_every > 1 is the asynchronous regime; set "
            "async_rounds=True (synchronous halo reuse is staleness=k)"
        )
    if batch is not None:
        if layout != "sparse":
            raise ValueError(
                "minibatch gossip (batch=) needs the sparse layout: the "
                "minibatch is a sampled sparse store"
            )
        if steps_per_call != 1:
            raise ValueError(
                "minibatch gossip consumes one sampled store per round; "
                "steps_per_call must be 1"
            )
    if faults is not None and compression != "none":
        raise ValueError(
            "faults cannot be combined with message compression: a dropped "
            "compressed message would desynchronize the error-feedback "
            "residuals (the sender already folded the residual update in)"
        )
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if compression not in ("none", "int8", "topk"):
        raise ValueError(f"unknown compression {compression!r}")
    if layout not in ("dense", "sparse"):
        raise ValueError(
            f"unknown layout {layout!r}; expected 'dense' or 'sparse'")
    plan = MeshPlan.build(p, q, plan)
    if not plan.is_single_device:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != plan.num_devices:
            raise ValueError(
                f"a {plan.row_size}x{plan.col_size} plan needs a process "
                f"group of {plan.num_devices} ranks, this one has {world}; "
                "start the ranks with repro_torch.launch.gossip"
            )
    rho, lam, a, b = cfg.rho, cfg.lam, cfg.a, cfg.b
    n_struct = 2 * (p - 1) * (q - 1)
    exchanges: dict = {}
    robust = faults is not None or async_rounds

    def local_round(problem, carry: GossipCarry, step_i: int,
                    exchange, f_scale=None) -> GossipCarry:
        state, prev = carry.state, carry.halos
        halos = prev
        ef = (carry.ef_u_last, carry.ef_u_first, carry.ef_w_last,
              carry.ef_w_first)
        if async_rounds:
            # the absolute round is the clock: chunked calls and resumed
            # fits land on the same exchange schedule
            is_refresh = carry.rnd % exchange_every == 0
        else:
            is_refresh = step_i % staleness == 0
        if exchange is not None and is_refresh:
            keys = ("u_last", "u_first", "w_last", "w_first")
            halos, ef_new = exchange_halos(
                state.U, state.W, exchange, compression,
                dict(zip(keys, ef)) if compression != "none" else None,
                topk_fraction, age=prev.age,
            )
            if compression != "none":
                ef = tuple(ef_new[k] for k in keys)
        stats, gates = carry.stats, None
        if robust:
            exists = [exchange is not None and exchange.has(d)
                      for d in range(4)]
            halos, gates, stats = _merge_halos(
                prev, halos, faults=faults, exists=exists,
                edge_index=exchange.rank if exchange is not None else 0,
                rnd=carry.rnd, is_refresh=is_refresh,
                async_rounds=async_rounds, max_staleness=max_staleness,
                stats=stats)
        # consensus damped 1/2 in deterministic full-grad mode (waves.py)
        gU, gW = _local_gradients(problem, state.U, state.W, halos,
                                  exchange, rho=rho * 0.5, lam=lam,
                                  method=method, chunk=chunk,
                                  f_scale=f_scale, gates=gates)
        lr = obj.gamma(state.t.float(), a, b)
        new_state = State(state.U - lr * gU, state.W - lr * gW,
                          state.t + n_struct)
        return GossipCarry(new_state, halos, *ef, carry.rnd + 1, stats)

    def exchange_for(problem, carry: GossipCarry):
        if (layout == "sparse") != isinstance(problem, SparseProblem):
            raise ValueError(
                f"layout={layout!r} but the problem is a "
                f"{type(problem).__name__}")
        if plan.is_single_device:
            return None
        device = carry.state.U.device
        if device not in exchanges:
            exchanges[device] = HaloExchange(plan, device)
        return exchanges[device]

    def step(problem, carry: GossipCarry) -> GossipCarry:
        exchange = exchange_for(problem, carry)
        for i in range(steps_per_call):
            carry = local_round(problem, carry, i, exchange)
        return carry

    def step_minibatch(problem, f_scale, carry: GossipCarry) -> GossipCarry:
        # one sampled store per call: the schedule feeds a fresh minibatch
        # (and the same full-store nnz/batch scale) every round
        return local_round(problem, carry, 0, exchange_for(problem, carry),
                           f_scale=f_scale)

    return step if batch is None else step_minibatch


def exchange_rounds_in(start: int, n: int, exchange_every: int = 1) -> int:
    """How many of rounds ``[start, start + n)`` exchange halos when an
    exchange fires on ``rnd % exchange_every == 0`` (exact, no rounding):
    the ``Gossip`` schedule counts ``train_gossip_halo_bytes_total`` with
    it."""

    if exchange_every == 1:
        return n
    first = -(-start // exchange_every) * exchange_every
    if first >= start + n:
        return 0
    return (start + n - 1 - first) // exchange_every + 1


def halo_bytes_per_round(plan: MeshPlan, mb: int, nb: int, r: int,
                         compression: str = "none",
                         grid: tuple[int, int] | None = None) -> dict:
    """Exact wire bytes one gossip round moves, from the plan's geometry.

    Each rank's U-edge message is its first/last local block *column*,
    ``(blocks_per_row_shard, mb, r)``, sent along its rank row; W edges
    are the dual.  Only *interior* rank pairs carry bytes — on a 1×1 plan
    the total is exactly 0.  ``grid=(R, C)`` overrides the rank grid for
    analytic accounting.  Compression is charged per message by
    ``compress.message_bytes_n``."""

    R, Cc = grid if grid is not None else (plan.row_size, plan.col_size)
    bpr = plan.p // R
    bpc = plan.q // Cc
    u_floats = bpr * mb * r                 # one U edge message, in floats
    w_floats = bpc * nb * r
    u_msg = C.message_bytes_n(u_floats, compression)
    w_msg = C.message_bytes_n(w_floats, compression)
    # 2 directions (first/last edge) x interior neighbour pairs
    u_bytes = 2 * R * (Cc - 1) * u_msg
    w_bytes = 2 * Cc * (R - 1) * w_msg
    interior = 2 * (u_msg + w_msg)          # what one interior agent sends
    return {
        "u_edge_message_bytes": u_msg,
        "w_edge_message_bytes": w_msg,
        "u_bytes": u_bytes,
        "w_bytes": w_bytes,
        "total_bytes": u_bytes + w_bytes,
        "per_interior_agent_bytes": interior,
    }


def init_carry(state: State, round0: int = 0) -> GossipCarry:
    """Zero halos and zero error feedback for ``state``, the rank's tile.

    Ages start at ``AGE_NEVER`` (nothing received yet) and the round clock
    at ``round0`` — a resumed fit passes its completed round count, so
    the ``FaultPlan`` and the async exchange clock continue where the
    checkpoint left them."""

    pl, ql, mb, r = state.U.shape
    nb = state.W.shape[2]
    dev = state.U.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    halos = HaloState(
        zeros(pl, mb, r), zeros(pl, mb, r), zeros(ql, nb, r),
        zeros(ql, nb, r),
        torch.full((pl, ql, 4), AGE_NEVER, dtype=torch.int32),
    )
    return GossipCarry(
        state, halos, zeros(pl, mb, r), zeros(pl, mb, r), zeros(ql, nb, r),
        zeros(ql, nb, r), int(round0), FaultStats(),
    )


def distributed_cost(problem: Problem | SparseProblem, state: State,
                     lam: float, plan: MeshPlan | None = None, *,
                     method: str = "segment") -> torch.Tensor:
    """Σ f + λ‖·‖² over the whole grid: the local tile's cost, summed over
    the ranks by one ``all_reduce`` (evaluation only).  ``state`` is the
    rank's tile; both layouts."""

    c = obj.total_cost(problem, state.U, state.W, lam, method=method)
    if plan is None or plan.is_single_device:
        return c
    if host_collectives(c.device):
        host = c.detach().cpu()
        dist.all_reduce(host)
        return host.to(c.device)
    dist.all_reduce(c)
    return c


def gather_state(plan: MeshPlan, state: State) -> State:
    """The global (p, q, ...) ``State`` from every rank's tile (one
    all-gather of U and one of W); the identity on a 1×1 plan."""

    if plan.is_single_device:
        return state
    device = state.U.device
    host = host_collectives(device)
    out = []
    for x in (state.U, state.W):
        x = x.detach().contiguous()
        x = x.cpu() if host else x
        parts = [torch.empty_like(x) for _ in range(plan.num_devices)]
        dist.all_gather(parts, x)
        full = x.new_empty((plan.p, plan.q) + tuple(x.shape[2:]))
        for k, part in enumerate(parts):
            full[plan.tile(k)] = part
        out.append(full.to(device))
    return State(out[0], out[1], state.t)


def gather_ints(plan: MeshPlan, values, device: torch.device) -> np.ndarray:
    """Every rank's ``values`` (a short list of ints), as a (ranks, k)
    array in rank order: one all-gather on a grid, none on a 1×1 plan.
    The ``Gossip`` schedule sums its counters with it once a chunk."""

    mine = torch.tensor([list(values)], dtype=torch.int64)
    if plan.is_single_device:
        return mine.numpy()
    if not host_collectives(device) and device.type == "cuda":
        mine = mine.to(device)
    parts = [torch.empty_like(mine) for _ in range(plan.num_devices)]
    dist.all_gather(parts, mine)
    return torch.cat(parts).cpu().numpy()
