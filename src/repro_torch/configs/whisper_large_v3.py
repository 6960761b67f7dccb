"""whisper-large-v3 — encoder-decoder audio backbone, conv front end a
stub [arXiv:2212.04356; openai/whisper-large-v3].

32 bidirectional encoder layers over 1500 frames (30 s of audio after the
two stride-2 convolutions, which the JAX package stubs: its callers hand
in (B, 1500, 1280) frame embeddings) and 32 causal decoder layers with
cross-attention, d_model 1280, 20 heads of 64, GELU MLPs of width 5120,
LayerNorms with biases, and the unembedding tied to the token embedding.
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,                 # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    encoder_layers=32,
    encoder_seq_len=1500,          # 30 s of audio after the (stub) conv front end
    qkv_bias=True,
    mlp_act="gelu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512, encoder_layers=2,
        encoder_seq_len=30, param_dtype="float32",
    )
