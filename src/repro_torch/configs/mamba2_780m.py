"""mamba2-780m — attention-free SSD (state-space duality)
[arXiv:2405.21060; state-spaces/mamba2-780m].

48 Mamba2 layers of d_model 1536 (d_inner 3072: 48 heads of 64), d_state
128, a causal conv of width 4 and chunks of 256, as in the JAX package's
config.  The model launches no TPU kernel: its SSD scan is plain tensor
code there and here.
"""

import dataclasses

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    supports_long_context=True,    # O(1)-state decode
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=16),
        param_dtype="float32",
    )
