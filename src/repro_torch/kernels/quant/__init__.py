"""Fused int8 dequantize-score kernel of the serving path.

``ops.dequant_score`` is the public entry point; ``csrc/dequant_score.cu``
holds the CUDA kernel, ``ref.py`` the two plain paths (exact fused twin and
dequantize-then-matmul), ``autotune.py`` the per-device ``method=None``
resolver.  Quantization itself lives with the index (``serve/quant.py``).
"""

from repro_torch.kernels.quant.autotune import (FALLBACK_METHOD, METHODS,
                                                resolve_method)
from repro_torch.kernels.quant.ops import dequant_score
from repro_torch.kernels.quant.ref import dequant_score_ref, fused_score_ref

__all__ = [
    "FALLBACK_METHOD",
    "METHODS",
    "dequant_score",
    "dequant_score_ref",
    "fused_score_ref",
    "resolve_method",
]
