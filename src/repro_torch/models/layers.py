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
vocab slices of the logits before the softcap, and ``all_reduce`` sums a
row-parallel product's partial sums.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

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
    ``"mlp.wo"``, ``"projector.w2"``, ``"embed"``, ``"lm_head"``; see
    ``train/shard.py::model_split``).  With ``timed`` set, each collective
    synchronizes the card before and after it and adds its host seconds
    and bytes to ``stats`` (``{"all_reduce": [calls, seconds, bytes],
    "all_gather": ...}``)."""

    group: Any
    rank: int
    size: int
    staged: bool
    split: frozenset = frozenset()
    timed: bool = False
    stats: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, group, device, split=frozenset()) -> "TP":
        return cls(group, dist.get_rank(group), dist.get_world_size(group),
                   torch.device(device).type == "cuda"
                   and dist.get_backend(group) != "nccl", frozenset(split))

    @classmethod
    def dry(cls, size: int, split=frozenset(), rank: int = 0) -> "TP":
        """Rank ``rank`` of ``size`` with no process group, for counting on
        ``meta`` tensors (``launch/roofline_bench.py``): each collective
        moves nothing and adds its call and the bytes of its input to
        ``stats`` (``{op: [calls, 0.0, bytes]}``); its output has the
        shape the real collective's would."""

        return cls(None, rank, size, False, frozenset(split))

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


def all_reduce(x, tp: TP | None):
    """The sum of ``x`` over the ranks of ``tp`` (``x`` itself without a
    group): the partial sums of a row-parallel product."""

    if tp is None or tp.size == 1:
        return x
    if tp.group is None:
        tp._dry("all_reduce", x)
        return x
    with tp._timing("all_reduce", x):
        if tp.staged:
            host = x.cpu()
            dist.all_reduce(host, group=tp.group)
            return host.to(x.device)
        x = x.contiguous()
        dist.all_reduce(x, group=tp.group)
        return x


def all_gather_last(x, tp: TP | None):
    """The ranks' ``x`` concatenated in rank order along the last dim."""

    if tp is None or tp.size == 1:
        return x
    if tp.group is None:
        tp._dry("all_gather", x)
        return torch.cat([x] * tp.size, dim=-1)
    with tp._timing("all_gather", x):
        src = x.cpu() if tp.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(tp.size)]
        dist.all_gather(parts, src, group=tp.group)
        return torch.cat(parts, dim=-1).to(x.device)


def _normal(gen, shape, std, dtype, device, lead=()):
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def upcast(x):
    """x in float32, as the JAX package computes norms, rotations, softmax
    and the loss; float64 stays float64, so that a float64 evaluation (a
    gradient check) is float64 throughout."""

    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, w, eps: float = 1e-6):
    xf = upcast(x)
    var = xf.square().mean(dim=-1, keepdim=True)
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


def mlp_gelu(params, x):
    h = F.gelu(x @ params["wi"] + params["bi"], approximate="tanh")
    return h @ params["wo"] + params["bo"]


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


def embed(emb, tokens, tp: TP | None = None):
    """Rows ``tokens`` of the table.  Under ``tp`` the table holds this
    rank's range of ``tp.size`` contiguous vocab ranges: each rank writes
    the rows of its range and zeros for the rest, and the ranks
    all-reduce: every sum has one nonzero term, so the rows are exact."""

    if tp is None:
        return emb[tokens]
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

    logits = all_gather_last(x @ (emb_or_head.T if tied else emb_or_head),
                             tp)
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
