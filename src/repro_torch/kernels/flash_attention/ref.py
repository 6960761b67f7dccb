"""Plain PyTorch version of flash attention.

Port of ``repro.kernels.flash_attention.ref.attention_ref``: causal
masking, GQA (Hq a multiple of Hkv, K/V repeated over the group),
sliding-window (local) attention and gemma2's attention-logit softcap, all
math in float32, the result cast back to ``q.dtype``.  It materializes the
(B, Hq, Lq, Lk) logits; the elementwise steps run in place on that one
buffer, so at the gemma2-2b prefill (B = 4, L = 8000) it holds 8.2 GB, not
several copies.
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
    qf = q.float()
    qf = qf / qf.new_tensor(math.sqrt(D))   # a true divide on either device
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = qf @ kf.transpose(-1, -2)
    if softcap:
        logits.div_(softcap).tanh_().mul_(softcap)
    qpos = torch.arange(Lq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    logits.masked_fill_(~mask, -1e30)
    logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
    logits.div_(logits.sum(dim=-1, keepdim=True))
    return (logits @ vf).to(q.dtype)
