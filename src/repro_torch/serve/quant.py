"""int8 serving cache: symmetric per-row quantization of the factor index.

Port of ``repro.serve.quant``.  Every user and item row of the
``RecommendIndex`` is ``4r`` bytes of f32; this module shrinks it to
``r + 4`` bytes (int8 codes + one f32 scale), and the scoring product
reads a quarter of the factor bytes per request.

Scheme — **symmetric per-row**, so that scoring stays one fused kernel
(``kernels/quant``):

    s_row = max|row| / 127           (0-rows get s = 1, q = 0)
    q     = round(row / s) ∈ [−127, 127]   (int8)
    row'  = q · s,  |row − row'| ≤ s/2 elementwise

    scores[i, j] = s_u[i] · s_w[j] · ⟨q_u[i], q_w[j]⟩

``torch.round`` rounds half to even like ``jnp.round``, and both divisions
are correctly rounded f32 divisions on either device, so the codes and
scales equal the JAX package's bit for bit.  ``quantize_index`` sets the
``serve_index_bytes{dtype=...}`` gauges (f32 source vs int8 result) in the
``repro_torch.obs`` registry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs


def quantize_rows(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: (codes int8, scales f32).

    ``x`` is (rows, r) float; each row quantizes against its own absmax
    so reconstruction error is ≤ scale/2 = max|row|/254 elementwise.
    All-zero rows get scale 1 (never 0: scales multiply into the score
    epilogue) and codes 0."""

    x = torch.as_tensor(x).float()
    amax = x.abs().amax(dim=1)
    # a tensor divisor, not a Python number: on the card PyTorch turns
    # division by a host scalar into a multiply by its rounded reciprocal,
    # which differs from amax / 127 in the last bit
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


class QuantizedRecommendIndex(NamedTuple):
    """Immutable int8 serving state (on the factors' device).

    The quantized twin of ``RecommendIndex``: factor codes + per-row
    scales; the seen-item table is untouched by quantization."""

    u_q: torch.Tensor       # (m, r) int8 — user factor codes
    u_scale: torch.Tensor   # (m,) float32 — per-user scales
    w_q: torch.Tensor       # (n, r) int8 — item factor codes
    w_scale: torch.Tensor   # (n,) float32 — per-item scales
    seen: torch.Tensor      # (m, S) int32 — items to exclude; pad value == n

    @property
    def num_users(self) -> int:
        return self.u_q.shape[0]

    @property
    def num_items(self) -> int:
        return self.w_q.shape[0]

    @property
    def rank(self) -> int:
        return self.u_q.shape[1]

    def dequantize(self):
        """f32 ``RecommendIndex`` reconstructed from codes × scales."""

        from repro_torch.serve.recommend import RecommendIndex

        return RecommendIndex(self.u_q.float() * self.u_scale[:, None],
                              self.w_q.float() * self.w_scale[:, None],
                              self.seen)

    def refresh(self, fit_result) -> "QuantizedRecommendIndex":
        """Rebuild from a (re)fit, **re-quantizing on the swap**.  The
        factor shapes must match (expected-vs-got message as the f32
        ``RecommendIndex.refresh``)."""

        new = fit_result.to_recommend_index()
        expected = (tuple(self.u_q.shape), tuple(self.w_q.shape))
        got = (tuple(new.u.shape), tuple(new.w.shape))
        if expected != got:
            raise ValueError(
                f"refresh changes the factor shapes: expected "
                f"u{expected[0]} x w{expected[1]} (int8 layout), got "
                f"u{got[0]} x w{got[1]}; a re-shaped problem needs a new "
                f"quantize_index(build_index(...)), not a refresh"
            )
        return quantize_index(new)


def index_nbytes(index) -> int:
    """Device bytes of an index's factor payload (codes/factors + scales;
    the seen table is the same in both layouts and left out, so the
    f32-vs-int8 ratio measures exactly what quantization changes)."""

    if isinstance(index, QuantizedRecommendIndex):
        tensors = (index.u_q, index.u_scale, index.w_q, index.w_scale)
    else:
        tensors = (index.u, index.w)
    return int(sum(t.numel() * t.element_size() for t in tensors))


def quantize_index(index) -> QuantizedRecommendIndex:
    """Quantize a ``RecommendIndex`` to the int8 serving layout, on its
    device, and set ``serve_index_bytes{dtype=f32}`` (the source) and
    ``serve_index_bytes{dtype=int8}`` (the result)."""

    if isinstance(index, QuantizedRecommendIndex):
        return index
    u_q, u_scale = quantize_rows(index.u)
    w_q, w_scale = quantize_rows(index.w)
    qidx = QuantizedRecommendIndex(u_q, u_scale, w_q, w_scale, index.seen)
    obs.gauge("serve_index_bytes", dtype="f32").set(index_nbytes(index))
    obs.gauge("serve_index_bytes", dtype="int8").set(index_nbytes(qidx))
    return qidx
