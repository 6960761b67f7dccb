"""internlm2-20b — dense GQA transformer [arXiv:2403.17297; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    head_dim=128,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512, param_dtype="float32",
    )
