"""Gossip data-parallel LM training (port of ``repro.train.gossip_dp``):
the paper's consensus mechanism applied to neural-net training.

Instead of an exact all-reduce, each data-parallel worker keeps its own
model replica and, after every local step, averages parameters with its
ring neighbours (decentralized SGD, D-PSGD style: the paper's d-term
consensus, replicas drift, neighbours pull, no central reduction):

    p_i ← (1−2α)·p_i + α·p_{i−1} + α·p_{i+1}

α = 1/4 is doubly-stochastic mixing; staleness k gossips every k-th step.
Optional int8 / top-k message compression reuses ``core/compress.py``
(without error feedback, as in the JAX step).

A worker is one rank of a ``torch.distributed`` group (``launch/gossip.
run_on_grid`` with grid (n, 1)), as the JAX step's worker is one device of
the ``data`` mesh axis: the rank holds its replica and optimizer state,
not a stacked copy of all of them, and takes its contiguous slice of the
global batch, as ``P("data")`` slices it.  The returned loss is the mean
over the ranks.

The exchange goes leaf by leaf and, within a leaf, in chunks of
``CHUNK`` elements: the rank sends its message's chunk to both neighbours,
receives theirs, and mixes that chunk of its replica in place, so no
received leaf is ever held whole.  A message is compressed once, at the
sender; compression is a pure function of the message, so the receiver
gets what JAX's receiver computes from the raw one, and an int8 message
travels as its int8 codes and scale (a quarter of the bytes).  Under
``gloo`` on a card (ranks sharing one card) the chunks are staged through
pinned host buffers, as ``core.gossip.HaloExchange`` stages its halos;
under ``nccl`` they go from the card.  Counters:
``train_gossip_dp_bytes_total`` (bytes sent) and the
``train_gossip_dp_exchange_seconds`` histogram (host clock, one per
exchange).

``replicate_for_workers`` and ``consensus_error`` work on stacked trees
(a leading worker axis) as in JAX; ``rank_consensus_error`` is the same
measure across the ranks of a group.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import compress as C
from repro_torch.core.gossip import host_collectives
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.train.step import loss_and_grads, split_batch

# elements a chunk of the exchange moves (64 MiB of f32)
CHUNK = 1 << 24
_FROM_LEFT, _FROM_RIGHT = 0, 1       # message tags, by the receiver's side


def replicate_for_workers(tree, n: int):
    """n copies of every leaf stacked along a new leading worker axis."""

    return tree_map(lambda a: a.unsqueeze(0).repeat((n,) + (1,) * a.dim()),
                    tree)


def consensus_error(stacked) -> torch.Tensor:
    """max_i ‖p_i − mean(p)‖∞ across workers of a stacked tree (0 at exact
    consensus)."""

    return max(torch.max(torch.abs(a - torch.mean(a, dim=0, keepdim=True)))
               for a in tree_leaves(stacked))


def _group_info(group):
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, lambda r: r
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if group is None:
        return rank, n, lambda r: r
    return rank, n, lambda r: dist.get_global_rank(group, r)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced over the group (staged through the host where the
    backend cannot take the card's tensors)."""

    if not (dist.is_available() and dist.is_initialized()):
        return x
    staged = host_collectives(x.device, group)
    buf = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device) if staged else buf


@torch.no_grad()
def rank_consensus_error(params, group=None) -> torch.Tensor:
    """``consensus_error`` of the replicas held by the ranks of ``group``:
    every rank gets max over ranks of ‖p_i − mean p‖∞ (a collective)."""

    _, n, _ = _group_info(group)
    err = None
    for a in tree_leaves(params):
        mean = _all_reduce(a, dist.ReduceOp.SUM, group) / n
        e = torch.max(torch.abs(a - mean))
        err = e if err is None else torch.maximum(err, e)
    return _all_reduce(err, dist.ReduceOp.MAX, group)


class _Ring:
    """One rank's mixing exchange with its ring neighbours, chunk by chunk,
    with reusable (pinned, where staged) buffers."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.rank, self.n, glob = _group_info(group)
        self.left = glob((self.rank - 1) % self.n)
        self.right = glob((self.rank + 1) % self.n)
        self.staged = self.n > 1 and host_collectives(device, group)
        self.device = device
        self._bufs: dict = {}

    def _buf(self, key, numel, dtype):
        """A reusable buffer: pinned host memory where staged, else on the
        device."""

        buf = self._bufs.get((key, dtype))
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype, pin_memory=self.staged,
                              device="cpu" if self.staged else self.device)
            self._bufs[(key, dtype)] = buf
        return buf[:numel]

    def _swap(self, x):
        """Send ``x`` (a contiguous 1-D tensor) to both neighbours; the
        (left's, right's) tensors received in its place and the bytes
        sent."""

        if self.n == 1:       # both neighbours are this worker
            return x, x, 0
        if self.staged:
            x = self._buf("send", x.numel(), x.dtype).copy_(x)
        got_l = self._buf("left", x.numel(), x.dtype)
        got_r = self._buf("right", x.numel(), x.dtype)
        # my message is my right neighbour's left and my left one's right
        ops = [dist.P2POp(dist.isend, x, self.right, self.group,
                          tag=_FROM_LEFT),
               dist.P2POp(dist.isend, x, self.left, self.group,
                          tag=_FROM_RIGHT),
               dist.P2POp(dist.irecv, got_l, self.left, self.group,
                          tag=_FROM_LEFT),
               dist.P2POp(dist.irecv, got_r, self.right, self.group,
                          tag=_FROM_RIGHT)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got_l, got_r, 2 * x.numel() * x.element_size()

    def mix(self, params, alpha: float, compression: str,
            topk_fraction: float) -> int:
        """p ← (1−2α)p + α(left + right) for every leaf, in place; the
        bytes this rank sent."""

        sent = 0
        for p in tree_leaves(params):
            flat = p.view(-1)
            if compression == "int8":     # codes on the wire, scale apart
                codes, scale = C.int8_compress(p.float())
                wire = codes.view(-1)
                s_l, s_r, b = self._swap(scale.reshape(1))
                sent += b
                scales = (s_l.to(p.device), s_r.to(p.device))

                def decode(x, side):
                    return C.int8_decompress(x.to(p.device), scales[side])
            else:
                wire = flat if compression == "none" else C.compress_message(
                    p, compression, None, topk_fraction)[0].view(-1)

                def decode(x, side):
                    return x.to(p.device)
            for lo in range(0, flat.numel(), CHUNK):
                got_l, got_r, b = self._swap(wire[lo:lo + CHUNK])
                sent += b
                mixed = alpha * (decode(got_l, 0) + decode(got_r, 1))
                flat[lo:lo + CHUNK].mul_(1 - 2 * alpha).add_(
                    mixed.to(p.dtype))
        return sent


def make_gossip_dp_step(loss_fn, optimizer: Optimizer, *, group=None,
                        alpha: float = 0.25, staleness: int = 1,
                        compression: str = "none",
                        topk_fraction: float = 0.25):
    """``step(params, opt_state, batch, t) -> (params, opt_state, loss)``
    on this rank's replica (updated in place) and the global ``batch``
    (a dict of arrays whose leading dim the ranks split evenly)."""

    ring = None

    def step(params, opt_state, batch, t):
        nonlocal ring
        rank, n, _ = _group_info(group)
        local = split_batch(batch, n)[rank]
        loss, grads = loss_and_grads(loss_fn, params, [local])
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        if int(t) % staleness == 0:
            device = tree_leaves(params)[0].device
            if ring is None:
                ring = _Ring(group, device)
            t0 = time.perf_counter()
            with torch.no_grad():
                sent = ring.mix(params, alpha, compression, topk_fraction)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            obs.histogram("train_gossip_dp_exchange_seconds").observe(
                time.perf_counter() - t0)
            obs.counter("train_gossip_dp_bytes_total").inc(sent)
        loss = _all_reduce(loss, dist.ReduceOp.SUM, group) / n
        return params, opt_state, loss

    return step
