"""Device-dispatching wrapper of the flash attention kernel.

:func:`flash_attention` keeps the JAX wrapper's contract
(``repro.kernels.flash_attention.ops.flash_attention``): q (B, Hq, Lq, D),
k (B, Hkv, Lk, D), v (B, Hkv, Lk, Dv) with Hkv dividing Hq, causal,
sliding-window, softcap and ``q_offset`` variants.  A CUDA tensor launches
the hand-written kernel in ``kernels/csrc/flash_attention.cu``; a CPU
tensor runs the plain version (``ref.attention_ref``).  There is no
fallback from the card.

The kernel takes any D, Dv <= 256 and any Lq, Lk, so the TPU padding of
the JAX wrapper (D to 128 lanes, L to the tile, q rescaled by √Dp/√D) is
gone; V with its own head dim (MLA) goes in as it is.  It takes float32 or
bfloat16 tensors, contiguous, all of one dtype.  Launches are counted in
``flash_attention.launches``.

There is no backward: the JAX kernel defines no VJP, and neither does this
one.  So the wrapper refuses, on either device, to run where autograd would
record it (grad mode on and q, k or v requiring grad) instead of returning
an output with no gradient; a model that trains builds with
``Ctx(attn_impl="ref")``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """(B, Hq, Lq, Dv) attention output in q's dtype; see the module
    docstring for the shapes."""

    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, _ = k.shape
    Dv = v.shape[-1]
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hkv|Hq, got Hq={Hq} Hkv={Hkv}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward (the JAX kernel defines no "
            "VJP): run it under torch.no_grad()/inference_mode, or train "
            "with the plain attention, Ctx(attn_impl=\"ref\")")
    if not _build.on_card(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    if q.dtype not in _DTYPES:
        raise ValueError(f"q: the kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    _build.expect(k, "k", q.dtype, (B, Hkv, Lk, D))
    _build.expect(v, "v", q.dtype, (B, Hkv, Lk, Dv))
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv} outside the kernel's "
                         f"range [1, {MAX_HEAD_DIM}]")
    if min(B, Lq, Lk) < 1 or B * Hq > 65535 or window < 0:
        raise ValueError(f"unsupported shape: B={B} Hq={Hq} Lq={Lq} Lk={Lk} "
                         f"window={window}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    # 16-byte rows: the kernel copies f32 tiles with cp.async
    aligned = (q.dtype == torch.float32 and D % 4 == 0 and Dv % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    out = torch.empty((B, Hq, Lq, Dv), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Lq, Lk, D, Dv, int(bool(causal)), int(window),
            float(softcap), int(q_offset), _DTYPES[q.dtype], int(aligned),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
