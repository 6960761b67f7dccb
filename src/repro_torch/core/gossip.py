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

Not ported yet (ROADMAP queue 1 item 3b): ``faults=`` and
``async_rounds``/``exchange_every``.  The carry keeps the fault counters
(``FaultStats``, zeros) and the halo ages so that slice can fill them in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.config import GossipMCConfig
from repro_torch.core import compress as C
from repro_torch.core import objective as obj
from repro_torch.core.state import Problem, State
from repro_torch.core.waves import full_gradients
from repro_torch.mesh.plan import MeshPlan, current_rank
from repro_torch.sparse.store import SparseProblem

# a halo direction never received yet (the reference's faults.AGE_NEVER)
AGE_NEVER = 1_000_000
# the halo directions, in the reference's faults.DIRECTIONS order; a
# message's tag is the receiver's direction
LEFT, RIGHT, UP, DOWN = range(4)

NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1 item 3b: faults "
              "and async rounds)")


class HaloState(NamedTuple):
    """Cached neighbour edges (refreshed every ``staleness`` rounds), on
    the rank's own tile: ``pl = p / R`` block rows, ``ql = q / C`` block
    columns.  ``age`` counts missed refreshes per direction; the
    synchronous path threads it through untouched."""

    left_u: torch.Tensor   # left neighbour's last block-col U   (pl, mb, r)
    right_u: torch.Tensor  # right neighbour's first block-col U (pl, mb, r)
    up_w: torch.Tensor     # upper neighbour's last block-row W  (ql, nb, r)
    down_w: torch.Tensor   # lower neighbour's first block-row W (ql, nb, r)
    age: torch.Tensor      # rounds since last receive           (pl, ql, 4)


class FaultStats(NamedTuple):
    """Fault counters on the rank's tile (zeros until faults are ported)."""

    dropped: torch.Tensor
    stale: torch.Tensor
    straggled: torch.Tensor


class GossipCarry(NamedTuple):
    state: State               # the rank's tile of the factors
    halos: HaloState
    ef_u_last: torch.Tensor    # error-feedback residuals (compression)
    ef_u_first: torch.Tensor
    ef_w_last: torch.Tensor
    ef_w_first: torch.Tensor
    rnd: int                   # absolute gossip round
    stats: FaultStats


def host_collectives(device: torch.device) -> bool:
    """True where this rank's collectives must move host tensors: a card
    under a backend other than ``nccl`` (``gloo`` takes CPU tensors only,
    and ranks that share one card cannot run ``nccl``)."""

    return device.type == "cuda" and dist.get_backend() != "nccl"


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
        age = torch.zeros(U.shape[:2] + (4,), dtype=torch.int32,
                          device=U.device)
    left, right, up, down = exchange(msgs["u_last"], msgs["u_first"],
                                     msgs["w_last"], msgs["w_first"])
    return HaloState(left, right, up, down, age), new_ef


def _local_gradients(problem, U, W, halos: HaloState, exchange, rho, lam,
                     method="segment", chunk=None, f_scale=None):
    """∇L on the local tile, seam terms from the halos; a seam without a
    neighbour (the grid's boundary, or every seam of a 1×1 plan) is left
    out.  ``f_scale`` (minibatch rounds) multiplies only the f-part."""

    gU, gW = full_gradients(problem, U, W, rho=rho, lam=lam, method=method,
                            chunk=chunk, f_scale=f_scale)
    if exchange is None:
        return gU, gW
    # seam pair (left neighbour's last col, my first col):
    # d/dU_mine = 2ρ(mine - theirs)
    if exchange.has(LEFT):
        gU[:, 0] += 2.0 * rho * (U[:, 0] - halos.left_u)
    if exchange.has(RIGHT):
        gU[:, -1] += 2.0 * rho * (U[:, -1] - halos.right_u)
    if exchange.has(UP):
        gW[0] += 2.0 * rho * (W[0] - halos.up_w)
    if exchange.has(DOWN):
        gW[-1] += 2.0 * rho * (W[-1] - halos.down_w)
    return gU, gW


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
    ``steps_per_call=1``; halos are exchanged every round.

    ``faults`` and ``async_rounds``/``exchange_every`` are validated as
    the reference validates them, then raise ``NotImplementedError``
    (ROADMAP.md queue 1 item 3b)."""

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
    for name, on in (("faults=", faults is not None),
                     ("async_rounds=True", async_rounds)):
        if on:
            raise NotImplementedError(f"gossip with {name} {NOT_PORTED}")
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

    def local_round(problem, carry: GossipCarry, step_i: int,
                    exchange, f_scale=None) -> GossipCarry:
        state, halos = carry.state, carry.halos
        ef = (carry.ef_u_last, carry.ef_u_first, carry.ef_w_last,
              carry.ef_w_first)
        if exchange is not None and step_i % staleness == 0:
            keys = ("u_last", "u_first", "w_last", "w_first")
            halos, ef_new = exchange_halos(
                state.U, state.W, exchange, compression,
                dict(zip(keys, ef)) if compression != "none" else None,
                topk_fraction, age=halos.age,
            )
            if compression != "none":
                ef = tuple(ef_new[k] for k in keys)
        # consensus damped 1/2 in deterministic full-grad mode (waves.py)
        gU, gW = _local_gradients(problem, state.U, state.W, halos,
                                  exchange, rho=rho * 0.5, lam=lam,
                                  method=method, chunk=chunk,
                                  f_scale=f_scale)
        lr = obj.gamma(state.t.float(), a, b)
        new_state = State(state.U - lr * gU, state.W - lr * gW,
                          state.t + n_struct)
        return GossipCarry(new_state, halos, *ef, carry.rnd + 1,
                           carry.stats)

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
    at ``round0``."""

    pl, ql, mb, r = state.U.shape
    nb = state.W.shape[2]
    dev = state.U.device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    halos = HaloState(
        zeros(pl, mb, r), zeros(pl, mb, r), zeros(ql, nb, r),
        zeros(ql, nb, r),
        torch.full((pl, ql, 4), AGE_NEVER, dtype=torch.int32, device=dev),
    )
    return GossipCarry(
        state, halos, zeros(pl, mb, r), zeros(pl, mb, r), zeros(ql, nb, r),
        zeros(ql, nb, r), int(round0),
        FaultStats(*(zeros(pl, ql, dtype=torch.int32) for _ in range(3))),
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
