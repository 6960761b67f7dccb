from repro_torch.kernels.masked_factor_grad.ops import masked_factor_grad
from repro_torch.kernels.masked_factor_grad.ref import masked_factor_grad_ref

__all__ = ["masked_factor_grad", "masked_factor_grad_ref"]
