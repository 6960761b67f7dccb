"""Plain PyTorch version of the fused masked factorization gradient.

Port of ``repro.kernels.masked_factor_grad.ref``.  Given blocks X, mask
(..., M, N) and factors U (..., M, r), W (..., N, r):

    R  = mask ⊙ (X − U Wᵀ)
    f  = ‖R‖²_F
    gU = −2 R W
    gW = −2 Rᵀ U

It is the CPU path of ``ops.masked_factor_grad`` and the yardstick the CUDA
kernel is held against; the main path never calls it for a CUDA tensor.
All in float32.
"""

from __future__ import annotations


def masked_factor_grad_ref(x, mask, u, w):
    xf, mf, uf, wf = x.float(), mask.float(), u.float(), w.float()
    r = mf * (xf - uf @ wf.mT)
    loss = (r * r).sum((-2, -1))
    gu = (-2.0 * r @ wf).to(u.dtype)
    gw = (-2.0 * r.mT @ uf).to(w.dtype)
    return loss, gu, gw
