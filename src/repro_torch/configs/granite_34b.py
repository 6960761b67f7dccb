"""granite-34b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=1,
        head_dim=16, d_ff=256, vocab_size=512, param_dtype="float32",
    )
