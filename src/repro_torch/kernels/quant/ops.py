"""Device-dispatching wrapper of the fused int8 dequantize-score kernel.

:func:`dequant_score` is the one entry point the serving path calls
(``serve.recommend.recommend_topk`` with a ``QuantizedRecommendIndex``).
``method`` picks the arithmetic:

* ``"fused"`` — exact int32 dot of the codes, then the scale epilogue.  A
  CUDA tensor launches the hand-written kernel in
  ``kernels/csrc/dequant_score.cu``; a CPU tensor runs the plain version
  (``ref.fused_score_ref``).  There is no fallback from the card.
* ``"dequant"`` — materialize the f32 rows and multiply (a plain matmul
  on either device, as in the JAX package).
* ``None`` — resolved from the tensors' device (``autotune``).

The kernel takes any shape, so the TPU padding of the JAX wrapper (rank to
128 lanes, batch to 32 sublanes, catalog to the item tile) and its VMEM
back-off are gone.  Launches are counted in ``dequant_score.launches``,
by batch size B in ``dequant_score.by_batch``, and by the kernel that ran
in ``dequant_score.by_kernel``: a staged kernel by its (BM, BN) tile,
``"first"`` for the first kernel, as the C entry reports its last launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant.autotune import resolve_method
from repro_torch.kernels.quant.ref import dequant_score_ref, fused_score_ref

# the int32 accumulator holds r products of at most 127² each
MAX_RANK = (2**31 - 1) // 127**2


def dequant_score(u_q, u_scale, w_q, w_scale, *, method: str | None = None):
    """(B, n) f32 scores for an int8 user batch against an int8 catalog.

    ``u_q`` (B, r) int8 with ``u_scale`` (B,) f32, ``w_q`` (n, r) int8
    with ``w_scale`` (n,) f32 — symmetric per-row quantization
    (serve/quant.py).  ``scores[i, j] = s_u[i] · s_w[j] · ⟨q_u[i], q_w[j]⟩``.
    """

    method = resolve_method(method, u_q.device)
    if method == "dequant":
        return dequant_score_ref(u_q, u_scale, w_q, w_scale)
    if not _build.on_card(u_q, u_scale, w_q, w_scale):
        return fused_score_ref(u_q, u_scale, w_q, w_scale)
    B, r = u_q.shape
    n = w_q.shape[0]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank r={r} outside the kernel's range "
                         f"[1, {MAX_RANK}]")
    if B < 1 or n < 1:
        raise ValueError(f"empty score block: B={B}, n={n}")
    _build.expect(u_q, "u_q", torch.int8, (B, r))
    _build.expect(u_scale, "u_scale", torch.float32, (B,))
    _build.expect(w_q, "w_q", torch.int8, (n, r))
    _build.expect(w_scale, "w_scale", torch.float32, (n,))
    for t, name in ((u_q, "u_q"), (u_scale, "u_scale"), (w_q, "w_q"),
                    (w_scale, "w_scale")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    out = torch.empty((B, n), dtype=torch.float32, device=u_q.device)
    lib = _build.load("dequant_score")
    # a ctypes launch goes to the calling thread's current device: make it
    # the tensors' device (the serving worker is a thread of its own)
    with torch.cuda.device(u_q.device):
        rc = lib.dequant_score(
            u_q.data_ptr(), u_scale.data_ptr(), w_q.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), B, n, r,
            torch.cuda.current_stream(u_q.device).cuda_stream)
    _build.check("dequant_score", rc)
    last = lib.dequant_score_last_kernel()
    dequant_score.launches += 1
    by_batch, by_kernel = dequant_score.by_batch, dequant_score.by_kernel
    by_batch[B] = by_batch.get(B, 0) + 1
    kernel = divmod(last, 1 << 16) if last > 0 else "first"
    by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
    return out


dequant_score.launches = 0
dequant_score.by_batch = {}
dequant_score.by_kernel = {}
