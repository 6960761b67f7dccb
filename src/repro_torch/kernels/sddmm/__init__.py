from repro_torch.kernels.sddmm.ops import sddmm_factor_grad, sddmm_segment_grad
from repro_torch.kernels.sddmm.ref import sddmm_factor_grad_ref, sddmm_residuals
from repro_torch.kernels.sddmm.segment import (
    SEG_CHUNK,
    sddmm_segment_grad_ref,
    segment_reduce,
)

__all__ = [
    "SEG_CHUNK",
    "sddmm_factor_grad",
    "sddmm_factor_grad_ref",
    "sddmm_residuals",
    "sddmm_segment_grad",
    "sddmm_segment_grad_ref",
    "segment_reduce",
]
