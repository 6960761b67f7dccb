"""``repro_torch`` — the PyTorch / CUDA port of ``repro``'s gossip
matrix-completion fit and its top-k serving.

Subpackages mirror ``repro`` one for one (``core/``, ``sparse/``,
``kernels/``, ``mc/``, ``serve/``, ``serving/``), so every module's
reference twin sits
at the same relative path.  The port imports ``torch`` and ``numpy`` only,
never ``jax`` and nothing of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  On a CUDA tensor every f-gradient and the int8 serving score
go through a hand-written kernel (``kernels/csrc``); on a CPU tensor the
kernel's plain PyTorch version runs instead.

Numerics: TF32 is switched off for matmuls and convolutions.  The paper's
objective is a float32 least-squares fit, and the reference computes every
product in full float32; TF32 keeps about three decimal digits, which would
break the 1e-5 sparse-vs-dense agreement the store is held to and the
parity tests against ``repro``.  Only the plain versions and serving's
f32 score matmul reach cuBLAS; the hand-written gradient kernels are
float32 throughout, and the int8 score kernel accumulates exactly in int32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
