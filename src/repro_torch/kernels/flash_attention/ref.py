"""Plain PyTorch version of flash attention.

Port of ``repro.kernels.flash_attention.ref.attention_ref``: causal
masking, GQA (Hq a multiple of Hkv, K/V repeated over the group),
sliding-window (local) attention and gemma2's attention-logit softcap, all
math in float32 (float64 inputs stay float64), the result cast back to
``q.dtype``.  It materializes the (B, Hq, Lq, Lk) logits.  Without
autograd the elementwise steps run in place on that one buffer, so at the
gemma2-2b prefill (B = 4, L = 8000) it holds 8.2 GB, not several copies.
When q, k or v requires grad (the training path, which has no attention
kernel) the same steps run out of place, so that autograd keeps the
values its backward reads.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0):
    """q (B, Hq, Lq, D), k (B, Hkv, Lk, D), v (B, Hkv, Lk, Dv) ->
    (B, Hq, Lq, Dv) in q's dtype.  ``window`` 0 is global; w > 0 attends to
    keys within w of the query.  ``q_offset`` is the absolute position of
    q[0] (prefill continuation)."""

    B, Hq, Lq, D = q.shape
    Lk = k.shape[2]
    group = Hq // k.shape[1]
    # float32 math; float64 stays float64 (a float64 gradient check)
    up = (lambda t: t if t.dtype == torch.float64 else t.float())
    qf = up(q)
    qf = qf / qf.new_tensor(math.sqrt(D))   # a true divide on either device
    kf = up(k).repeat_interleave(group, dim=1)
    vf = up(v).repeat_interleave(group, dim=1)
    logits = qf @ kf.transpose(-1, -2)
    qpos = torch.arange(Lq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        logits = torch.where(mask, logits, -1e30)
        return (torch.softmax(logits, dim=-1) @ vf).to(q.dtype)
    if softcap:
        logits.div_(softcap).tanh_().mul_(softcap)
    logits.masked_fill_(~mask, -1e30)
    logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
    logits.div_(logits.sum(dim=-1, keepdim=True))
    return (logits @ vf).to(q.dtype)
