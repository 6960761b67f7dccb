"""granite-moe-3b-a800m — 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base].

The numbers (32 layers, d_model 1536, 40 experts top-8 of width 512,
24 query and 8 KV heads of 64, vocab 49155, tied embeddings) are those of
ibm-granite/granite-3.0-3b-a800m-base; the JAX package's docstring cites
the 1b-a400m model.  The published config also scales the embedding, the
residual branches, the attention logits and the output logits by
multipliers; the JAX model applies none of them, and neither does the
port (ROADMAP.md §3, differences by design).
"""

import dataclasses

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                      # per-expert hidden dim
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=40, num_experts_per_tok=8, expert_d_ff=512),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=512,
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2, expert_d_ff=32),
        param_dtype="float32",
    )
