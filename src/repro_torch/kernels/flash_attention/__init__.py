"""Flash attention of the LM prefill.

``ops.flash_attention`` is the public entry point; ``csrc/flash_attention.cu``
holds the CUDA kernel and ``ref.py`` its plain version.  The JAX package's
XLA flash scan (``kernels/flash_attention/xla.py``) has no twin here: it
exists for HLO cost probes and for backends without Mosaic, and the port
has neither.
"""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "flash_attention"]
