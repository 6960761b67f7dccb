"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 64 routed top-6, 2 shared
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].

Layer 0 has a dense MLP of width 10944; the other 26 are MoE.  The
published model uses YaRN rope scaling and does not renormalise its top-6
weights; the JAX model uses plain rope and renormalises, and the port
computes what the JAX model computes (ROADMAP.md §3, differences by
design).
"""

import dataclasses

from repro_torch.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                    # layer-0 dense MLP width
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, num_experts_per_tok=6,
                  num_shared_experts=2, expert_d_ff=1408),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                      num_shared_experts=1, expert_d_ff=32),
        mla=MLAConfig(kv_lora_rank=32, qk_rope_head_dim=8,
                      qk_nope_head_dim=16, v_head_dim=16),
        param_dtype="float32",
    )
