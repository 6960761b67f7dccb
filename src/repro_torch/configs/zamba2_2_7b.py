"""zamba2-2.7b — Mamba2 backbone + a shared attention block
[arXiv:2411.15242; Zyphra/Zamba2-2.7B].

54 Mamba2 layers of d_model 2560 (80 heads of 64, d_state 64) and one
shared transformer block (32 heads of 80, SwiGLU of width 10240) invoked
before every 6 of them: 9 invocations, each with its own LoRA deltas on
q/k/v and its own concat projection.  The published model alternates two
shared blocks; the JAX model (and so the port) has one (ROADMAP.md §3,
differences by design).
"""

import dataclasses

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,                    # shared-block MLP width
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    shared_attn_every=6,           # one shared block per 6 mamba layers
    supports_long_context=True,    # SSM state + periodic shared attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=16),
        shared_attn_every=2, param_dtype="float32",
    )
