"""Plain PyTorch versions of the int8 dequantize-score product.

Port of ``repro.kernels.quant.ref``.  Two numerically distinct paths
(``ops.dequant_score``'s ``method=`` switch):

* :func:`dequant_score_ref` — the **dequant** path: materialize the f32
  factors (``q · scale`` per row) and run the plain f32 matmul.
* :func:`fused_score_ref` — the **fused** path's plain version, twin of
  ``fused_score_xla``: the exact integer dot of the codes, then the f32
  epilogue ``acc · s_u[i] · s_w[j]`` in that order.  The hand-written
  kernel (``kernels/csrc/dequant_score.cu``) does the same arithmetic, so
  the two are compared bitwise.

The integer dot runs as a float64 matmul of the codes: every product and
partial sum is an integer below 127²·r, far inside float64's 2⁵³, so the
sum is exact in any order and on either device.  The two paths differ only
in float rounding: the fused epilogue keeps the dot exact, the dequant path
rounds every ``q · scale`` to f32 before accumulating.
"""

from __future__ import annotations

import torch


def dequant_score_ref(u_q, u_scale, w_q, w_scale):
    """(B, n) f32 scores via explicit dequantize-then-matmul."""

    u = u_q.float() * u_scale[:, None]
    w = w_q.float() * w_scale[:, None]
    return u @ w.T


def fused_score_ref(u_q, u_scale, w_q, w_scale):
    """(B, n) f32 scores: exact integer dot, then the per-row scale
    epilogue ``(float(acc) · s_u) · s_w`` — the twin of
    ``repro.kernels.quant.ref.fused_score_xla``."""

    acc = u_q.double() @ w_q.double().T             # (B, n), exact integers
    return acc.float() * u_scale[:, None] * w_scale[None, :]
