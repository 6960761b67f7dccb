"""Mamba2 (SSD, state-space duality) block (port of ``repro.models.ssm``).

Chunked SSD (Dao & Gu 2024, the "minimal" formulation): within a chunk
the recurrence is expanded into an attention-like quadratic form, across
chunks a recurrence carries the (heads x head_dim x d_state) state.
Decode is the O(1) recurrent update.  The block is in_proj -> depthwise
causal conv over (x, B, C) -> SSD -> gated RMSNorm -> out_proj, with
n_groups = 1 (B and C shared across heads) and the projections stored per
segment (``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``), as in the JAX
package, so a JAX parameter tree carries over leaf for leaf.

The JAX module's SSD is ``jnp`` einsums and a ``lax.scan``, not a Pallas
kernel, and so is this one: plain PyTorch, the three-operand einsums as
pairwise batched matmuls (none of whose intermediates is larger than the
(b, c, h, t, t) decay matrix), the scan over chunks a Python loop.
Its float32 casts are ``layers.upcast``: a float64 evaluation (float64
parameters and input) stays float64 throughout.
Dispatch is the reference's: the chunked form runs only when the length
is a multiple of the chunk and longer than one chunk, the sequential
oracle otherwise.
As in the reference, the chunked form's decay matrix comes from
differences of within-chunk cumsums of dt * A: where a chunk's decay sums
to thousands, those differences lose float32 precision and the chunked
form is less accurate than the sequential one, by the same amount in both
packages (float64 shows the two forms equal).

A prefill's ``SSMState`` keeps the dtypes the reference gives it (the
conv registers in the activations' dtype); ``init_ssm_state`` makes them
the cache dtype.  ``ssm_decode`` writes the new state into the given one
in place, in that state's dtypes, and returns it, as the port's attention
decode writes its KV cache.

Tensor parallelism (``tp``, the rank's ``models.layers.TP``): the rules
split the head-aligned leaves on ``"model"`` (``w_z``, ``w_x``,
``conv_x``, ``conv_x_b``, ``A_log``, ``D``, ``dt_bias``, ``norm``) and
``out_proj``'s rows, and keep ``w_B``, ``w_C``, ``w_dt`` and the B/C
convs whole.  A rank computes B and C whole (redundantly), takes its
heads' columns of ``x @ w_dt`` before adding its ``dt_bias``, runs the
scan unchanged on its heads (heads are independent in SSD), normalises
``y * silu(z)`` by the mean of squares over the whole ``d_inner`` (one
all-reduce of a (B, L, 1) sum) and all-reduces ``out_proj``'s partial
sums.  The widths are read from the parameters, so the same code runs
whole and on a rank.  Its state holds its heads of ``h`` and its
channels of ``conv_x``, and ``conv_B``/``conv_C`` whole
(``train/shard.py::WHOLE_CACHE``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.models import layers as L


class SSMState(NamedTuple):
    h: torch.Tensor        # (..., B, nheads, head_dim, d_state), float32
    conv_x: torch.Tensor   # (..., B, d_conv - 1, d_inner) shift register
    conv_B: torch.Tensor   # (..., B, d_conv - 1, d_state)
    conv_C: torch.Tensor   # (..., B, d_conv - 1, d_state)


def _dims(d_model: int, cfg: SSMConfig):
    return cfg.d_inner(d_model), cfg.n_heads(d_model)


def _local_dims(params):
    """(d_inner, heads) of the parameters given: the whole block's, or a
    tensor-parallel rank's share."""

    return params["w_x"].shape[-1], params["A_log"].shape[-1]


def init_ssm(gen, d_model: int, cfg: SSMConfig, dtype, device,
             lead=()) -> dict:
    d_inner, nheads = _dims(d_model, cfg)
    lead = tuple(lead)
    s = d_model ** -0.5
    sc = cfg.d_conv ** -0.5

    def rnd(shape, std):
        return L._normal(gen, shape, std, dtype, device, lead)

    def zeros(width, dt=dtype):
        return torch.zeros(lead + (width,), dtype=dt, device=device)

    def per_head(row):
        return row.to(device).expand(lead + (nheads,)).clone()

    # dt_bias: the inverse softplus of log-uniform draws in [1e-3, 1e-1]
    u = torch.rand(lead + (nheads,), generator=gen, dtype=torch.float32,
                   device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "w_z": rnd((d_model, d_inner), s),
        "w_x": rnd((d_model, d_inner), s),
        "w_B": rnd((d_model, cfg.d_state), s),
        "w_C": rnd((d_model, cfg.d_state), s),
        "w_dt": rnd((d_model, nheads), s),
        "conv_x": rnd((cfg.d_conv, d_inner), sc),
        "conv_x_b": zeros(d_inner),
        "conv_B": rnd((cfg.d_conv, cfg.d_state), sc),
        "conv_B_b": zeros(cfg.d_state),
        "conv_C": rnd((cfg.d_conv, cfg.d_state), sc),
        "conv_C_b": zeros(cfg.d_state),
        # A_log, D and dt_bias are float32 whatever the param dtype
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, nheads))),
        "D": per_head(torch.ones(nheads)),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": zeros(d_inner),
        "out_proj": rnd((d_inner, d_model), d_inner ** -0.5),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv of width K.  u: (B, L, C); w: (K, C)."""

    K, Lx = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + Lx] * w[i] for i in range(K))
    return F.silu(out + b)


def _segsum(x):
    """(..., T) -> (..., T, T): S[i, j] = sum of x[s] over j < s <= i,
    -inf above the diagonal."""

    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(T, device=x.device)
    return s.masked_fill_(i[:, None] < i[None, :], float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    x: (b, l, h, p) raw inputs (dt applied inside); dt: (b, l, h)
    softplus'd step sizes; A: (h,) negative decay rates; Bm, Cm: (b, l, n)
    shared across heads.  Returns y (b, l, h, p) and the final state
    (b, h, p, n)."""

    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = l // chunk
    xc = x.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)

    dA = dtc * A                                        # (b, c, t, h)
    dA_cum = torch.cumsum(dA, dim=2)

    # 1. intra-chunk (diagonal blocks): the quadratic form.
    # "bcst,bchst,bcthp->bcshp" as (scores * Lmat) @ (x dt)
    scores = Cc @ Bc.transpose(-1, -2)                  # (b, c, s, t)
    M = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # Lmat (b, c, h, s, t)
    M = M * scores[:, :, None]
    del scores
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)  # (b, c, h, t, p)
    y = (M @ xdt).permute(0, 1, 3, 2, 4)                # (b, c, s, h, p)
    del M, xdt

    # 2. chunk-final states: "bctn,bcth,bcthp->bchpn"
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (b,c,t,h)
    xw = xc * (dtc * decay_to_end)[..., None]           # (b, c, t, h, p)
    states = xw.permute(0, 1, 3, 4, 2) @ Bc[:, :, None]  # (b, c, h, p, n)
    del xw, decay_to_end

    # 3. inter-chunk recurrence over the chunk states (lax.scan in JAX)
    chunk_decay = torch.exp(dA.sum(dim=2))              # (b, c, h)
    hstate = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    h_prevs = []
    for i in range(c):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prevs = torch.stack(h_prevs, dim=1)               # (b, c, h, p, n)
    del states

    # 4. the carried state's contribution: "bctn,bchpn,bcth->bcthp"
    y_off = Cc[:, :, None] @ h_prevs.transpose(-1, -2)  # (b, c, h, t, p)
    y_off = y_off * torch.exp(dA_cum).permute(0, 1, 3, 2)[..., None]
    y = y + y_off.permute(0, 1, 3, 2, 4)
    return y.reshape(b, l, h, p), hstate


def ssd_reference(x, dt, A, Bm, Cm):
    """O(L) sequential oracle: one recurrence step a token."""

    b, l, h, p = x.shape
    n = Bm.shape[-1]
    hstate = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t] * A)                     # (b, h)
        hstate = (hstate * dA[..., None, None]
                  + (x[:, t] * dt[:, t, :, None])[..., None]
                  * Bm[:, t, None, None, :])
        ys.append((hstate @ Cm[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), hstate


def _proj(params, x, tp=None):
    """z, the pre-conv x/B/C projections and dt (float32, softplus'd).
    Under ``tp`` with the heads split, ``x @ w_dt`` (whole) gives every
    head's dt and the rank takes its heads' columns.

    ``F.softplus`` returns its input above 20 where ``jax.nn.softplus``
    computes log(1 + e^x); they differ there by less than 2e-9 relative,
    and dt's pre-activations lie far below 20."""

    dt = L.upcast(L.linear(x, params["w_dt"]))
    head_tp = L.sharded(tp, "ssm.dt_bias")
    if head_tp is not None:
        n = params["dt_bias"].shape[-1]
        dt = dt[..., head_tp.rank * n:(head_tp.rank + 1) * n]
    dt = F.softplus(dt + params["dt_bias"])
    return (L.linear(x, params["w_z"]), L.linear(x, params["w_x"]),
            L.linear(x, params["w_B"]), L.linear(x, params["w_C"]), dt)


def _convs(params, ux, uB, uC):
    return (_causal_conv(ux, params["conv_x"], params["conv_x_b"]),
            _causal_conv(uB, params["conv_B"], params["conv_B_b"]),
            _causal_conv(uC, params["conv_C"], params["conv_C_b"]))


def _scan_inputs(params, xs, Bm, Cm, dt, cfg: SSMConfig, nheads):
    B_, Lx, _ = xs.shape
    xh = L.upcast(xs.reshape(B_, Lx, nheads, cfg.head_dim))
    return xh, dt, -torch.exp(params["A_log"]), L.upcast(Bm), L.upcast(Cm)


def scan_inputs(params, x, cfg: SSMConfig, d_model: int):
    """The SSD's float32 inputs of one block for x (B, L, d_model), as
    ``ssm_block`` hands them to the scan: (x (B, L, h, p), dt (B, L, h),
    A (h,), Bm, Cm (B, L, n))."""

    _, ux, uB, uC, dt = _proj(params, x)
    return _scan_inputs(params, *_convs(params, ux, uB, uC), dt, cfg,
                        cfg.n_heads(d_model))


def _scan(params, xs, Bm, Cm, dt, cfg: SSMConfig, nheads, use_chunked):
    """The SSD over the conv outputs, plus the skip term: (y (B, L, h, p)
    float32, final state)."""

    xh, dt, A, Bm, Cm = _scan_inputs(params, xs, Bm, Cm, dt, cfg, nheads)
    Lx = xh.shape[1]
    if use_chunked and Lx % cfg.chunk_size == 0 and Lx > cfg.chunk_size:
        y, h = ssd_chunked(xh, dt, A, Bm, Cm, cfg.chunk_size)
    else:
        y, h = ssd_reference(xh, dt, A, Bm, Cm)
    return y + params["D"][:, None] * xh, h


def _finish(params, y, z, B_, Lx, d_inner, x_dtype, tp=None):
    y = y.reshape(B_, Lx, d_inner).to(x_dtype)
    # the gated norm at rms_norm's default eps, as the reference has it,
    # over the whole d_inner where a rank holds a slice of it
    y = L.rms_norm(y * F.silu(z), params["norm"],
                   tp=L.sharded(tp, "ssm.norm"))
    return L.all_reduce(L.linear(y, params["out_proj"]),
                        L.sharded(tp, "ssm.out_proj"))


def ssm_block(params, x, cfg: SSMConfig, d_model: int, use_chunked=True,
              tp=None):
    """Full Mamba2 block, training path.  x: (B, L, d_model)."""

    d_inner, nheads = _local_dims(params)
    B_, Lx, _ = x.shape
    z, ux, uB, uC, dt = _proj(params, x, tp)
    xs, Bm, Cm = _convs(params, ux, uB, uC)
    del ux, uB, uC
    y, _ = _scan(params, xs, Bm, Cm, dt, cfg, nheads, use_chunked)
    return _finish(params, y, z, B_, Lx, d_inner, x.dtype, tp)


def ssm_prefill(params, x, cfg: SSMConfig, d_model: int, tp=None):
    """Training-path forward + the ``SSMState`` to continue decoding at L:
    the scan's final state and the last d_conv - 1 pre-conv activations
    (zeros in front of a prompt shorter than that), in x's dtype."""

    d_inner, nheads = _local_dims(params)
    B_, Lx, _ = x.shape
    z, ux, uB, uC, dt = _proj(params, x, tp)

    def tail(u):
        # a copy, so that the state holds no view of the (B, L, C) input
        k = cfg.d_conv - 1
        keep = u[:, max(Lx - k, 0):]
        return F.pad(keep, (0, 0, k - keep.shape[1], 0)).to(x.dtype).clone()

    regs = (tail(ux), tail(uB), tail(uC))
    xs, Bm, Cm = _convs(params, ux, uB, uC)
    del ux, uB, uC
    y, h = _scan(params, xs, Bm, Cm, dt, cfg, nheads, True)
    return (_finish(params, y, z, B_, Lx, d_inner, x.dtype, tp),
            SSMState(h, *regs))


def init_ssm_state(batch, d_model: int, cfg: SSMConfig,
                   dtype=torch.float32, device=None, lead=(),
                   tp=None) -> SSMState:
    """A zero state; under ``tp`` a rank's: its heads of ``h`` and its
    channels of ``conv_x`` where the rules split them, ``conv_B`` and
    ``conv_C`` whole."""

    d_inner, nheads = _dims(d_model, cfg)
    head_tp = L.sharded(tp, "ssm.A_log")
    nheads //= head_tp.size if head_tp else 1
    chan_tp = L.sharded(tp, "ssm.conv_x")
    d_inner //= chan_tp.size if chan_tp else 1
    lead = tuple(lead) + (batch,)

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return SSMState(
        h=zeros(nheads, cfg.head_dim, cfg.d_state, dt=torch.float32),
        conv_x=zeros(cfg.d_conv - 1, d_inner),
        conv_B=zeros(cfg.d_conv - 1, cfg.d_state),
        conv_C=zeros(cfg.d_conv - 1, cfg.d_state))


def stack_states(states) -> SSMState:
    """One ``SSMState`` of the given states stacked on a new leading axis
    (a prefill's states, layer by layer)."""

    return SSMState(*(torch.stack(f) for f in zip(*states)))


def _conv_step(u_new, buf, w, b):
    """One causal-conv step against a shift register.  u_new: (B, C).
    Returns the conv output and the shifted register (in buf's dtype);
    the product runs in the promoted dtype, as JAX's einsum does."""

    window = torch.cat([buf, u_new[:, None].to(buf.dtype)], dim=1)
    ct = torch.promote_types(window.dtype, w.dtype)
    out = (window.to(ct) * w.to(ct)).sum(dim=1)
    return F.silu(out + b), window[:, 1:]


def ssm_decode(params, x, state: SSMState, cfg: SSMConfig, d_model: int,
               tp=None):
    """One-token recurrent decode.  x: (B, 1, d).  Writes the new state
    into ``state`` in place; returns (out (B, 1, d), state)."""

    d_inner, nheads = _local_dims(params)
    B_ = x.shape[0]
    z, ux, uB, uC, dt = _proj(params, x[:, 0], tp)
    xs, reg_x = _conv_step(ux, state.conv_x, params["conv_x"],
                           params["conv_x_b"])
    Bm, reg_B = _conv_step(uB, state.conv_B, params["conv_B"],
                           params["conv_B_b"])
    Cm, reg_C = _conv_step(uC, state.conv_C, params["conv_C"],
                           params["conv_C_b"])
    A = -torch.exp(params["A_log"])
    xh = L.upcast(xs.reshape(B_, nheads, cfg.head_dim))
    dA = torch.exp(dt * A)                               # (B, h)
    h_new = (state.h * dA[..., None, None]
             + (xh * dt[..., None])[..., None] * L.upcast(Bm)[:, None, None])
    y = (h_new @ L.upcast(Cm)[:, None, :, None])[..., 0]
    y = y + params["D"][:, None] * xh
    out = _finish(params, y[:, None], z[:, None], B_, 1, d_inner, x.dtype,
                  tp)
    for reg, new in zip(state, (h_new, reg_x, reg_B, reg_C)):
        reg.copy_(new)
    return out, state
