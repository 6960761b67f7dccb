"""Shared primitive layers of the dense LM (port of ``repro.models.layers``).

Params are nested dicts of tensors; every layer is ``apply(params, x,
...)``.  Initializers take an explicit ``torch.Generator``, a dtype, a
device and a ``lead`` shape: ``lead=(n,)`` draws ``n`` stacked copies at
once, the layout of the JAX package's scanned unit params.  The values
cannot match JAX's threefry draws; the distributions do.

``layer_norm`` and ``mlp_gelu`` (the tanh GELU, as ``jax.nn.gelu``
computes it by default) serve the encoder-decoder.

Tensor parallelism (Megatron-style, with explicit collectives where the
JAX package lets GSPMD insert them): a rank's ``TP`` names its group and
the leaves the sharding rules split on ``"model"`` (``TP.split``); the
layers learn whether a product is split from ``sharded`` and from nothing
else.  ``embed`` looks up a vocab-sharded table (the rows of this rank's vocab
range, zeros for the others, then an all-reduce: the JAX package's
``embed_onehot`` computes the same sum), ``unembed`` all-gathers the
vocab slices of the logits before the softcap, ``all_reduce`` sums a
row-parallel product's partial sums (``mlp_gelu`` adds its whole bias
once, after it) and takes the maxima of the masked partial softmax over
a sequence-cut KV cache (``op="max"``, ``models/attention.py``),
``rms_norm`` normalises a width split over the ranks
by the all-reduced sum of squares, ``all_gather`` joins a column-parallel
product's slices, and ``all_to_all`` carries the expert-parallel MoE's
token slots to the ranks that hold their experts and back
(``models/moe.py``).

Training on model ranks (Megatron's pair of rules, where the JAX package
lets GSPMD insert the collectives' transposes): under autograd
``all_reduce``'s sum has the identity backward, and its conjugate
``all_reduce_grad`` (the identity forward, the gradient all-reduced)
stands where a whole activation enters a product split on ``"model"``;
``vocab_parallel_cross_entropy`` takes the loss from each rank's vocab
range of the logits, which are never gathered.  ``all_gather``'s
backward, and ``FSDP``'s gather's, reduce-scatters.  ``psum`` sums both
ways, for sums whose upstream each rank holds only its share of (the
MoE router's statistics over a batch group).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Tensor-parallel group and its collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class TP:
    """One rank's tensor-parallel group: its ``torch.distributed`` process
    group, its rank and size in it, and whether its collectives move host
    copies of the card's tensors (``gloo``, the backend of ranks that share
    a card, takes CPU tensors only), and the leaves the rules split on
    ``"model"``, named by their last two path keys (``"attn.wo"``,
    ``"mlp.wo"``, ``"projector.w2"``, ``"embed"``, ``"lm_head"``; the
    experts' ``"moe.wi_gate"``, ``"moe.wi_up"``, ``"moe.wo"`` where the
    rules split them on the expert dim; Mamba2's ``"ssm.out_proj"``,
    zamba2's ``"units.w_cat"``, whisper's ``"cross_attn.wo"``,
    ``"tok_embed"``; see ``train/shard.py::model_split``).  ``kv_cache``
    is how the rank holds its attention KV caches, as the rules' cache
    specs cut them (``train/shard.py::kv_cache_layout``, the one place
    that decides it): ``"heads"`` (its KV heads, which are its own),
    ``"sequence"`` (every KV head, positions ``[rank·Lmax/size,
    (rank+1)·Lmax/size)``) or ``"whole"``.  With ``timed`` set, each
    collective synchronizes the card before and after it and adds its
    host seconds and bytes to ``stats`` (``{"all_reduce": [calls,
    seconds, bytes], "all_reduce_max": ..., "all_gather": ...,
    "reduce_scatter": ..., "all_to_all": ...}``)."""

    group: Any
    rank: int
    size: int
    staged: bool
    split: frozenset = frozenset()
    timed: bool = False
    stats: dict = dataclasses.field(default_factory=dict)
    kv_cache: str = "heads"

    KV_CACHES = ("heads", "sequence", "whole")

    def __post_init__(self) -> None:
        if self.kv_cache not in self.KV_CACHES:
            raise ValueError(f"kv_cache {self.kv_cache!r}: one of "
                             f"{self.KV_CACHES}")

    @classmethod
    def of(cls, group, device, split=frozenset(),
           kv_cache: str = "heads") -> "TP":
        return cls(group, dist.get_rank(group), dist.get_world_size(group),
                   torch.device(device).type == "cuda"
                   and dist.get_backend(group) != "nccl", frozenset(split),
                   kv_cache=kv_cache)

    @classmethod
    def dry(cls, size: int, split=frozenset(), rank: int = 0,
            kv_cache: str = "heads") -> "TP":
        """Rank ``rank`` of ``size`` with no process group, for counting on
        ``meta`` tensors (``launch/roofline_bench.py``): each collective
        moves nothing and adds its call and the bytes of its input to
        ``stats`` (``{op: [calls, 0.0, bytes]}``); its output has the
        shape the real collective's would."""

        return cls(None, rank, size, False, frozenset(split),
                   kv_cache=kv_cache)

    def _dry(self, op: str, x: torch.Tensor) -> None:
        if x.device.type != "meta":
            raise RuntimeError("a TP without a process group counts "
                               "collectives on meta tensors only")
        row = self.stats.setdefault(op, [0, 0.0, 0])
        row[0] += 1
        row[2] += x.numel() * x.element_size()

    @contextlib.contextmanager
    def _timing(self, op: str, x: torch.Tensor):
        if not self.timed:
            yield
            return
        cuda = x.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(x.device)
        row = self.stats.setdefault(op, [0, 0.0, 0])
        row[0] += 1
        row[1] += time.perf_counter() - t0
        row[2] += x.numel() * x.element_size()


def sharded(tp: TP | None, leaf: str) -> TP | None:
    """``tp`` where the rules split ``leaf`` on ``"model"``, else ``None``
    (the product is whole on every rank and needs no collective)."""

    return tp if tp is not None and leaf in tp.split else None


_REDUCE_OPS = {"sum": ("all_reduce", dist.ReduceOp.SUM),
               "max": ("all_reduce_max", dist.ReduceOp.MAX)}


def all_reduce(x, tp: TP | None, op: str = "sum", inplace: bool = False):
    """The sum (``op="max"``: the maximum) of ``x`` over the ranks of
    ``tp`` (``x`` itself without a group): the partial sums of a
    row-parallel product, the maxima of a partial softmax.  ``stats``
    counts the two ops apart (``"all_reduce"``, ``"all_reduce_max"``).
    ``inplace`` writes the result into ``x`` (contiguous), also where it
    is staged through the host, so that no second copy of ``x`` is made
    on the card (a training step's gradients).

    Under autograd (``x`` requires grad) the sum is ``_AllReduce``, whose
    backward is the identity: every rank holds the same sum, and each
    passes its gradient to its own partial sum.  It writes into a copy,
    never into ``x``, which autograd may have saved.  The maximum carries
    no gradient: it is taken of ``x`` detached (the maxima of a softmax,
    which cancel in its value)."""

    if tp is None or tp.size == 1:
        return x
    if op == "max":
        x = x.detach()
    elif torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, tp)
    return _reduce(x, tp, op, inplace)


def _reduce(x, tp: TP, op: str = "sum", inplace: bool = False,
            copy: bool = False):
    """``all_reduce``'s collective, without autograd; ``copy``: into a new
    tensor, ``x`` left as it is."""

    name, reduce_op = _REDUCE_OPS[op]
    if tp.group is None:
        tp._dry(name, x)
        return x.clone() if copy else x
    with tp._timing(name, x):
        if tp.staged:
            host = x.to("cpu", copy=True) if copy else x.cpu()
            dist.all_reduce(host, op=reduce_op, group=tp.group)
            return x.copy_(host) if inplace else host.to(x.device)
        x = x.clone(memory_format=torch.contiguous_format) if copy else \
            x.contiguous()
        dist.all_reduce(x, op=reduce_op, group=tp.group)
        return x


class _AllReduce(torch.autograd.Function):
    """The sum over ``tp`` of a row-parallel product's partial sums; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, tp):
        return _reduce(x, tp, copy=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceGrad(torch.autograd.Function):
    """``all_reduce``'s conjugate: the identity forward, and the sum of
    the ranks' gradients over ``tp`` backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.tp, copy=True), None


def all_reduce_grad(x, tp: TP | None):
    """``x`` itself, whose gradient is summed over the ranks of ``tp``
    (``all_reduce``'s conjugate).  A whole activation (the residual
    stream's norm) enters a product split on ``"model"`` through it: each
    rank's product gives the gradient of its own columns' share only, and
    the sum makes it the whole gradient on every rank, so that a leaf
    replicated on ``"model"`` (a norm, the residual before it) gets the
    same, whole gradient on every model rank.  Without autograd it is
    ``x``."""

    if tp is None or tp.size == 1 or not (torch.is_grad_enabled()
                                           and x.requires_grad):
        return x
    return _AllReduceGrad.apply(x, tp)


class _Psum(torch.autograd.Function):
    """The sum over ``tp`` both ways: forward and backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce(x, tp, copy=True)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.tp, copy=True), None


def psum(x, tp: TP | None):
    """The sum of ``x`` over the ranks of ``tp`` whose gradient is the
    sum of the ranks' gradients (JAX's ``psum`` as ``shard_map``
    transposes it without its replication check).  Where each rank's
    upstream is its own share of a loss summed over the ranks (the MoE
    router's statistics, ``models/moe.py::route``: every rank adds
    ``aux / n`` of the one aux formed from the sums), the backward's sum
    gives each rank the whole gradient of the sums; ``all_reduce``'s
    identity backward, right where every rank's upstream is already the
    whole one, would hand it ``1/n`` of it.  Without a group it is
    ``x``."""

    if tp is None or tp.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Psum.apply(x, tp)
    return _reduce(x, tp)


def all_gather(x, tp: TP | None, dim: int):
    """The ranks' ``x`` concatenated in rank order along ``dim``.

    Under autograd (``x`` requires grad) it is ``_AllGather``, whose
    backward reduce-scatters: each rank's gradient of the whole result
    summed over ``tp``, the rank's slice of the sum (op
    ``"reduce_scatter"``).  A column-parallel product gathered whole and
    read by every rank (k and v where the KV heads do not divide the
    ranks, ``models/attention.py``) so gets the gradient of every rank's
    reads.  Without autograd it is the plain gather."""

    if tp is None or tp.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, tp, dim)
    return _gather(x, tp, dim)


def _gather(x, tp: TP, dim: int):
    """``all_gather``'s collective, without autograd."""

    if tp.group is None:
        tp._dry("all_gather", x)
        return torch.cat([x] * tp.size, dim=dim)
    with tp._timing("all_gather", x):
        src = x.cpu() if tp.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(tp.size)]
        dist.all_gather(parts, src, group=tp.group)
        return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(g, tp: TP, dim: int):
    """The sum over ``tp`` of the ranks' ``g``, cut into ``tp.size``
    slices along ``dim``: the rank's slice, in a new tensor.  Under
    ``nccl`` one ``reduce_scatter_tensor``; ``gloo`` has none, so an
    all-reduce of a copy (staged through the host on a card) and the
    rank's slice of it."""

    n = g.shape[dim] // tp.size
    if tp.group is None:
        tp._dry("reduce_scatter", g)
        return g.narrow(dim, tp.rank * n, n).clone()
    with tp._timing("reduce_scatter", g):
        if dist.get_backend(tp.group) != "nccl":
            src = g.to("cpu", copy=True) if tp.staged else g.clone(
                memory_format=torch.contiguous_format)
            dist.all_reduce(src, group=tp.group)
            return src.narrow(dim, tp.rank * n, n).to(g.device, copy=True)
        rows = g.movedim(dim, 0).contiguous()
        out = rows.new_empty((n,) + rows.shape[1:])
        dist.reduce_scatter_tensor(out, rows, group=tp.group)
        return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """The ranks' column slices joined in rank order; the backward
    reduce-scatters the whole result's gradient back to the slices."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.tp, ctx.dim), None, None


def all_to_all(x, tp: TP | None):
    """Chunk ``j`` of ``x``'s leading dim (``tp.size`` long) sent to rank
    ``j``; chunk ``j`` of the result is what rank ``j`` sent here (JAX's
    ``all_to_all(x, axis, 0, 0, tiled=False)``)."""

    if tp is None or tp.size == 1:
        return x
    if x.shape[0] != tp.size:
        raise ValueError(f"all_to_all takes a leading dim of {tp.size} "
                         f"chunks, got {tuple(x.shape)}")
    if tp.group is None:
        tp._dry("all_to_all", x)
        return torch.empty_like(x)
    with tp._timing("all_to_all", x):
        src = x.cpu() if tp.staged else x.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=tp.group)
        return out.to(x.device)


@dataclasses.dataclass(eq=False)
class FSDP(TP):
    """One rank's FSDP group: the ``data`` ranks of its pod that share its
    model coordinate, each holding a ``1/size`` slice of the leaves the
    rules split on ``"data"``.  ``split`` is ``train/shard.py::
    fsdp_split``'s ``{top-level key: {path below it: dim}}``, the one
    record of which leaves a rank gathers and on which dim; ``gather``
    makes them whole.  ``timed``, ``stats`` and ``dry`` as ``TP``'s (its
    ops ``"all_gather"`` and ``"reduce_scatter"``, each recording the
    bytes of its input: the rank's shards, the whole gradients).

    Under autograd (a leaf that requires grad) the gather is a
    ``torch.autograd.Function`` whose backward reduce-scatters each whole
    leaf's gradient over the group: the sum of the ranks' gradients, the
    rank's slice of it in its shard's shape (op ``"reduce_scatter"``:
    ``reduce_scatter_tensor`` of one flat run a dtype under ``nccl``;
    ``gloo`` has no reduce-scatter, so an all-reduce of that run, staged
    through the host on a card, and the rank's row of it).  The leaves it
    takes are the parameters' own tensors (or their views), so their
    gradients reach the leaves autograd knows.

    Ranks that share one card (``staged``: ``gloo``, which moves host
    tensors) gather a unit's shards laid out as ``train/shard.py`` lays
    them out by copying them device to device from the peers' memory:
    each rank sends the CUDA IPC handle of each such buffer over the group
    once, after a synchronize, and reads the peers' shards from then on.
    A training step writes those shards in place, so after its update
    every rank synchronizes its card and the group passes a barrier
    (``train/step.py``) before any gather reads a peer's buffer again.
    Other shards on a shared card go through the host, as ``all_gather``
    does."""

    split: dict = dataclasses.field(default_factory=dict)
    peers: dict = dataclasses.field(default_factory=dict, repr=False)
    one_card: Optional[bool] = None

    @classmethod
    def of(cls, group, device, split=None) -> "FSDP":
        tp = TP.of(group, device)
        return cls(tp.group, tp.rank, tp.size, tp.staged, dict(split or {}))

    @classmethod
    def dry(cls, size: int, split=None, rank: int = 0) -> "FSDP":
        return cls(None, rank, size, False, dict(split or {}))

    def gather(self, tree: dict, key: str) -> dict:
        """``tree`` (``params[key]``, or one unit of ``params["units"]``)
        with its FSDP leaves whole: one all-gather a dtype of the leaves'
        shards as one flat run (a view where ``train/shard.py`` laid them
        out so), then each leaf's ``size`` slices joined on its dim; under
        autograd through ``_Gather``, whose backward reduce-scatters."""

        dims = self.split.get(key)
        if not dims or self.size == 1:
            return tree
        by_dtype: dict = {}
        for keys in dims:
            x = leaf_at(tree, keys)
            by_dtype.setdefault(x.dtype, []).append((keys, x))
        whole = {}
        for items in by_dtype.values():
            xs = [x for _, x in items]
            ds = tuple(dims[keys] % x.ndim for keys, x in items)
            if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
                outs = _Gather.apply(self, ds, *xs)
            else:
                outs = self._gather_leaves(xs, ds)
            whole.update(zip((keys for keys, _ in items), outs))
        return _replace(tree, whole)

    def _gather_leaves(self, xs: list, ds) -> list:
        """The shards ``xs`` whole: each joined with the ranks' on its dim
        in ``ds``, by one all-gather of their flat run."""

        parts = self._all_gather_flat(*_flat(xs))
        out, at = [], 0
        for x, d in zip(xs, ds):
            n = x.numel()
            p = parts[:, at:at + n].view((self.size,) + x.shape)
            shape = list(x.shape)
            shape[d] *= self.size
            out.append(p.movedim(0, d).reshape(shape))
            at += n
        return out

    def _scatter_grads(self, grads, shapes, ds) -> list:
        """The whole leaves' gradients ``grads`` summed over the group,
        each cut back to the rank's slice on its dim in ``ds``, in its
        shard's shape: one reduce-scatter of their flat run."""

        rows = []
        for g, shape, d in zip(grads, shapes, ds):
            cut = shape[:d] + (self.size, shape[d]) + shape[d + 1:]
            rows.append(g.reshape(cut).movedim(d, 0).reshape(self.size, -1))
        mine = self._reduce_scatter_flat(torch.cat(rows, dim=1))
        out, at = [], 0
        for shape in shapes:
            n = math.prod(shape)
            out.append(mine[at:at + n].view(shape))
            at += n
        return out

    def _reduce_scatter_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """(n,): row ``rank`` of the sum of the ranks' ``flat`` (size,
        n)."""

        return _reduce_scatter(flat, self, 0)[0]

    def _all_gather_flat(self, flat: torch.Tensor,
                         view: bool = False) -> torch.Tensor:
        """(size, n): the ranks' ``flat`` (n,) in rank order; ``view``:
        ``flat`` is a view of a buffer the rank keeps."""

        if self.group is None:
            self._dry("all_gather", flat)
            return flat.new_empty((self.size, flat.numel()))
        with self._timing("all_gather", flat):
            if self.staged and view and self._on_one_card(flat.device):
                return self._peer_copies(flat)
            src = flat.cpu() if self.staged else flat.contiguous()
            out = src.new_empty((self.size * src.numel(),))
            dist.all_gather_into_tensor(out, src, group=self.group)
            return out.view(self.size, -1).to(flat.device)

    def _on_one_card(self, device: torch.device) -> bool:
        if self.one_card is None:
            where = [None] * self.size
            dist.all_gather_object(where, device.index, group=self.group)
            self.one_card = len(set(where)) == 1
        return self.one_card

    def _peer_copies(self, flat: torch.Tensor) -> torch.Tensor:
        """The ranks' ``flat`` copied from their buffers on this card: the
        first gather from a buffer sends its IPC handle over the group."""

        from torch.multiprocessing.reductions import reduce_tensor

        storage = flat.untyped_storage()
        peers = self.peers.get(storage.data_ptr())
        if peers is None:
            torch.cuda.synchronize(flat.device)
            # the handles are made and opened outside inference mode: the
            # buffer is an ordinary tensor's
            with torch.inference_mode(False):
                whole = torch.empty(0, dtype=flat.dtype,
                                    device=flat.device).set_(
                    storage, 0, (storage.nbytes() // flat.element_size(),),
                    (1,))
                sent = [None] * self.size
                dist.all_gather_object(sent, reduce_tensor(whole),
                                       group=self.group)
                peers = [whole if r == self.rank else fn(*args)
                         for r, (fn, args) in enumerate(sent)]
            if any(p.shape != whole.shape for p in peers):
                raise RuntimeError("the FSDP ranks' buffers differ in size: "
                                   "they were not laid out alike")
            self.peers[storage.data_ptr()] = peers
        at, n = flat.storage_offset(), flat.numel()
        out = flat.new_empty((self.size, n))
        for r, peer in enumerate(peers):
            out[r].copy_(peer[at:at + n])
        return out


def leaf_at(tree, keys):
    """The leaf of nested dicts at the key path ``keys``."""

    for k in keys:
        tree = tree[k]
    return tree


def _replace(tree: dict, leaves: dict) -> dict:
    """``tree`` with the leaves at ``leaves``' key paths replaced (the
    dicts on their paths copied, the rest shared)."""

    out = dict(tree)
    heads: dict = {}
    for keys, x in leaves.items():
        if len(keys) == 1:
            out[keys[0]] = x
        else:
            heads.setdefault(keys[0], {})[keys[1:]] = x
    for k, sub in heads.items():
        out[k] = _replace(tree[k], sub)
    return out


def _flat(xs: list) -> tuple[torch.Tensor, bool]:
    """The tensors ``xs`` as one flat run, and whether it is a view: of
    their storage where they lie in it contiguously one after another
    (``train/shard.py``'s layout of a unit's FSDP shards), else a
    concatenated copy."""

    x0 = xs[0]
    if x0.device.type != "meta":
        end = x0.storage_offset()
        for x in xs:
            if (not x.is_contiguous() or x.storage_offset() != end
                    or x.untyped_storage().data_ptr()
                    != x0.untyped_storage().data_ptr()):
                break
            end += x.numel()
        else:
            return x0.as_strided((end - x0.storage_offset(),), (1,),
                                 x0.storage_offset()), True
    return torch.cat([x.reshape(-1) for x in xs]), False


class _Gather(torch.autograd.Function):
    """``FSDP._gather_leaves`` with a backward: the whole leaves'
    gradients reduce-scattered back to the shards (``_scatter_grads``).
    Gradients the loss does not reach come in as zeros, so every rank
    makes the same collectives."""

    @staticmethod
    def forward(ctx, fsdp, ds, *xs):
        ctx.fsdp, ctx.ds = fsdp, ds
        ctx.shapes = [tuple(x.shape) for x in xs]
        return tuple(fsdp._gather_leaves(list(xs), ds))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None,
                *ctx.fsdp._scatter_grads(grads, ctx.shapes, ctx.ds))


def fsdp_gather(tree: dict, fsdp: FSDP | None, key: str) -> dict:
    """``tree`` with its FSDP leaves whole (``FSDP.gather``), or itself
    without an FSDP group."""

    return tree if fsdp is None else fsdp.gather(tree, key)


def _normal(gen, shape, std, dtype, device, lead=()):
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def upcast(x):
    """x in float32, as the JAX package computes norms, rotations, softmax
    and the loss; float64 stays float64, so that a float64 evaluation (a
    gradient check) is float64 throughout."""

    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, w, eps: float = 1e-6, tp: TP | None = None):
    """RMSNorm over the last axis in float32, scaled by ``1 + w``.  Under
    ``tp`` x and w hold this rank's slice of the normalised width (Mamba2's
    gated norm over a rank's heads of ``d_inner``): the mean of squares is
    the all-reduced sum of squares over the whole width, ``tp.size`` times
    x's, never the rank's own mean."""

    xf = upcast(x)
    if tp is None:
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        var = all_reduce(xf.square().sum(dim=-1, keepdim=True), tp) / (
            xf.shape[-1] * tp.size)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + upcast(w))).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm over the last axis in float32 (population variance),
    returned in x's dtype."""

    xf = upcast(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * upcast(w) + upcast(b)
    return out.to(x.dtype)


def linear(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


# ---------------------------------------------------------------------------
# Rotary embeddings (GPT-NeoX half-rotation convention)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, H, L, D); positions: (L,) or (B, L)."""

    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., L, D/2)
    if angles.ndim == 2:                                   # (L, D/2)
        angles = angles[None, None]
    else:                                                  # (B, L, D/2)
        angles = angles[:, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = upcast(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_swiglu(params, x):
    g = F.silu(x @ params["wi_gate"])
    return (g * (x @ params["wi_up"])) @ params["wo"]


def mlp_gelu(params, x, tp: TP | None = None):
    """The tanh-GELU MLP.  Under ``tp`` (``wi``, ``bi`` split on the hidden
    width, ``wo`` row-parallel) the partial sums are all-reduced and the
    whole ``bo`` is added once, after the reduction."""

    h = F.gelu(x @ params["wi"] + params["bi"], approximate="tanh")
    return all_reduce(h @ params["wo"], tp) + params["bo"]


def init_mlp_swiglu(gen, d_model: int, d_ff: int, dtype, device,
                    lead=()) -> dict:
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "wi_gate": _normal(gen, (d_model, d_ff), s_in, dtype, device, lead),
        "wi_up": _normal(gen, (d_model, d_ff), s_in, dtype, device, lead),
        "wo": _normal(gen, (d_ff, d_model), s_ff, dtype, device, lead),
    }


def init_mlp_gelu(gen, d_model: int, d_ff: int, dtype, device,
                  lead=()) -> dict:
    lead = tuple(lead)
    return {
        "wi": _normal(gen, (d_model, d_ff), d_model ** -0.5, dtype, device,
                      lead),
        "bi": torch.zeros(lead + (d_ff,), dtype=dtype, device=device),
        "wo": _normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype, device,
                      lead),
        "bo": torch.zeros(lead + (d_model,), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, dtype, device):
    return _normal(gen, (vocab, d_model), d_model ** -0.5, dtype, device)


def embed(emb, tokens, tp: TP | None = None, sparse_grad: bool = False):
    """Rows ``tokens`` of the table.  Under ``tp`` the table holds this
    rank's range of ``tp.size`` contiguous vocab ranges: each rank writes
    the rows of its range and zeros for the rest, and the ranks
    all-reduce: every sum has one nonzero term, so the rows are exact.
    ``sparse_grad``: the lookup's gradient is sparse (its rows only), for
    a tied table whose unembedding gives it a dense one to add into, so
    that the backward holds one dense gradient of the table, not two."""

    if tp is None:
        return F.embedding(tokens, emb, sparse=sparse_grad)
    lo = tp.rank * emb.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < emb.shape[0])
    x = emb[local.clamp(0, emb.shape[0] - 1)]
    return all_reduce(torch.where(inside[..., None], x, 0.0), tp)


def unembed(x, emb_or_head, tied: bool, cap: float = 0.0,
            tp: TP | None = None):
    """Logits over the vocab, softcapped.  Under ``tp`` the table or head
    is vocab-sharded: each rank's vocab range of logits is all-gathered
    into the full (..., vocab) logits on every rank before the softcap."""

    logits = all_gather(x @ (emb_or_head.T if tied else emb_or_head), tp,
                        -1)
    return softcap(logits, cap)


def cross_entropy(logits, targets, n_valid=None):
    """Mean next-token CE in f32; targets == -1 are padding.

    The JAX package extracts the gold logit with an iota-compare masked
    reduction, which only its GSPMD partitioning needs; a gather of the
    gold logit computes the same function."""

    logits = upcast(logits)
    valid = targets >= 0
    t = torch.where(valid, targets, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    denom = valid.sum().clamp(min=1) if n_valid is None else n_valid
    return nll.sum() / denom


def vocab_parallel_cross_entropy(logits, targets, tp: TP, n_valid=None):
    """``cross_entropy`` of the ranks' logits joined on the vocab, without
    joining them: ``logits`` (..., V / n) are this rank's contiguous vocab
    range (rank ``r`` holds ``[r·V/n, (r+1)·V/n)``), softcapped already
    (the softcap is elementwise).  The maximum m of each row is the
    all-reduced maximum of the ranks' (detached: it cancels), S the
    all-reduced Σ exp(l − m), the gold logit the all-reduced pick of the
    rank that holds the target (zero on the others); the loss is
    Σ_valid (log S + m − gold) / n_valid, targets of -1 padding.  S and
    the gold logits go in one all-reduce, whose identity backward hands
    each rank the gradient of its own range."""

    logits = upcast(logits)
    n = logits.shape[-1]
    valid = targets >= 0
    local = targets.long() - tp.rank * n
    inside = valid & (local >= 0) & (local < n)
    m = all_reduce(logits.amax(dim=-1), tp, op="max")
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    s, gold = all_reduce(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(inside, picked, 0.0)]), tp)
    nll = torch.where(valid, torch.log(s) + m - gold, 0.0)
    denom = valid.sum().clamp(min=1) if n_valid is None else n_valid
    return nll.sum() / denom
