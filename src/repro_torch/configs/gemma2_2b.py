"""gemma2-2b — local/global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    sliding_window=4096,
    local_global_pattern=2,        # local, global, local, global, ...
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    mlp_act="gelu",                # gemma2 uses gelu-gated; see DESIGN.md
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, sliding_window=16,
        param_dtype="float32",
    )
