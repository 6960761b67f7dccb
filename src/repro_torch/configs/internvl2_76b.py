"""internvl2-76b — InternViT (a stub) + an 80-layer LM backbone
[arXiv:2404.16821; OpenGVLab/InternVL2-Llama3-76B].

The vision tower is a stub in the JAX package, and so here: callers hand
in (B, 256, 1024) patch embeddings (one 448-px tile after InternViT's
pixel shuffle), which a two-layer GELU MLP projects to d_model and puts
before the text tokens.  The LM is Llama-3-70B's shape: 80 layers of
d_model 8192, 64 query heads of 128 over 8 KV heads, SwiGLU of width
28672, a vocabulary of 128,256 and an untied ``lm_head``.
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    num_patch_tokens=256,          # stub InternViT patch embeddings
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512, num_patch_tokens=8,
        param_dtype="float32",
    )
