"""qwen1.5-32b — QKV bias, full-head KV (assigned kv=40)
[hf:Qwen/Qwen1.5-0.5B; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=8,
        head_dim=16, d_ff=256, vocab_size=512, param_dtype="float32",
    )
