"""``repro_torch`` — the PyTorch / CUDA port of ``repro``'s gossip
matrix-completion fit, its top-k serving, and the LM harness's dense
serving path (prefill and cached greedy decode).

Subpackages mirror ``repro`` one for one (``core/``, ``sparse/``,
``kernels/``, ``mc/``, ``serve/``, ``serving/``, ``config/``,
``configs/``, ``models/``, ``launch/``), so every module's reference twin
sits at the same relative path.  The port imports ``torch`` and ``numpy`` only,
never ``jax`` and nothing of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  On a CUDA tensor every f-gradient, the int8 serving score
and the LM prefill's attention go through a hand-written kernel
(``kernels/csrc``); on a CPU tensor the kernel's plain PyTorch version
runs instead.

Numerics: TF32 is switched off for matmuls and convolutions.  The paper's
objective is a float32 least-squares fit, and the reference computes every
product in full float32; TF32 keeps about three decimal digits, which would
break the 1e-5 sparse-vs-dense agreement the store is held to and the
parity tests against ``repro``.  The plain versions, serving's f32 score
matmul and the LM's projections and MLPs (float32 parameters, as the JAX
package runs them) reach cuBLAS; the hand-written gradient and attention
kernels are float32 throughout, and the int8 score kernel accumulates
exactly in int32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
