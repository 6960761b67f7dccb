"""Configurations: the paper's workload (a copy of
``repro.config.GossipMCConfig``) and the LM harness's ``ModelConfig``,
``ShapeConfig``/``SHAPES``/``get_shape``, ``TrainConfig`` and the
``--arch`` registry (copies of ``repro.config``), and ``MeshConfig``, the
JAX package's axis fields without its gradient-sync, compression and
remat knobs, which nothing in the port reads.

``get_model_config`` and ``get_smoke_config`` load
``repro_torch.configs.<arch>`` for every arch of ``ARCHS``: the four
dense archs, the two MoE archs with ``MoEConfig`` and ``MLAConfig``,
mamba2-780m and zamba2-2.7b with ``SSMConfig``, whisper-large-v3 and
internvl2-76b.  The analytic parameter counts (``param_count``,
``matmul_param_count``, ``active_param_count``) live in
``repro_torch.models.api``, as in the JAX package; they count the
``init`` of a model built on the ``meta`` device.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class GossipMCConfig:
    """The paper's own workload (matrix completion through gossip)."""

    m: int = 500
    n: int = 500
    p: int = 4                         # grid rows
    q: int = 4                         # grid cols
    rank: int = 5
    rho: float = 1e3                   # consensus weight (paper Table 1)
    lam: float = 1e-9                  # regularization λ
    a: float = 5.0e-4                  # step size γ_t = a / (1 + b t)
    b: float = 5.0e-7
    density: float = 0.2               # observed fraction
    mode: str = "wave"                 # sequential | wave | full
    seed: int = 0

    def __post_init__(self) -> None:
        # catch bad configs at construction with the fix spelled out, not
        # deep inside blockify / the step functions
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got rank={self.rank}")
        if self.p <= 0 or self.q <= 0:
            raise ValueError(
                f"grid must have positive dimensions, got {self.p}x{self.q}"
            )
        if self.p > self.m or self.q > self.n:
            raise ValueError(
                f"grid {self.p}x{self.q} has more blocks than the {self.m}x"
                f"{self.n} matrix has rows/cols; shrink p/q (need p <= m and "
                "q <= n)"
            )
        if not 0.0 < self.density <= 1.0:
            raise ValueError(
                f"density must be in (0, 1], got {self.density}"
            )
        if self.a <= 0 or self.b < 0:
            raise ValueError(
                f"step-size schedule needs a > 0 and b >= 0 "
                f"(gamma_t = a/(1+bt)), got a={self.a}, b={self.b}"
            )
        if self.rho < 0 or self.lam < 0:
            raise ValueError(
                f"rho and lam must be non-negative, got rho={self.rho}, "
                f"lam={self.lam}"
            )
        if self.mode not in ("sequential", "wave", "full", "gossip"):
            raise ValueError(
                f"unknown mode {self.mode!r}; expected 'sequential', 'wave', "
                "'full' or 'gossip'"
            )


# ---------------------------------------------------------------------------
# LM harness (copies of repro.config; see the module docstring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0               # routed experts
    num_experts_per_tok: int = 0       # top-k
    num_shared_experts: int = 0        # DeepSeek-style always-on experts
    expert_d_ff: int = 0               # per-expert hidden dim
    router_aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0               # 0 = full-rank queries (v2-lite)
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    # attention variants
    qkv_bias: bool = False             # qwen1.5
    logit_softcap: float = 0.0         # gemma2 final-logit softcap
    attn_softcap: float = 0.0          # gemma2 attention-logit softcap
    sliding_window: int = 0            # gemma2 local layers
    local_global_pattern: int = 0      # every k-th layer is global (gemma2: 2)
    rope_theta: float = 10000.0
    # norm / mlp
    mlp_act: str = "silu"              # silu (SwiGLU) | gelu; not read: every
                                       # dense MLP is SwiGLU, as in repro
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0         # hybrid: one shared block per k SSMs
    # encoder-decoder (whisper) and VLM (internvl2)
    encoder_layers: int = 0
    encoder_seq_len: int = 1500
    num_patch_tokens: int = 0
    # numerics: compute runs in param_dtype; dtype is not read (as in repro)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / distribution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The rank grid's axes, as the JAX package's mesh names them: ``pod``
    and ``data`` (data parallel, ``data`` also FSDP when ``fsdp``) and
    ``model`` (tensor parallel); ``pod`` only on a multi-pod mesh.  The
    port serves on ``pod x data x model`` ranks (``repro_torch.train.
    shard``, ``launch/lm_engine.py``)."""

    multi_pod: bool = False
    pod: int = 1
    data: int = 16
    model: int = 16
    fsdp: bool = True                  # shard params over the data axis too

    @property
    def num_devices(self) -> int:
        return self.pod * self.data * self.model


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    optimizer: str = "adamw"           # adamw | sgd | paper_sgd
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatch: int = 0                # 0 = no gradient accumulation
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    max_grad_norm: float = 1.0

ARCHS: Sequence[str] = (
    "internlm2-20b",
    "granite-34b",
    "gemma2-2b",
    "qwen1.5-32b",
    "mamba2-780m",
    "internvl2-76b",
    "zamba2-2.7b",
    "whisper-large-v3",
    "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b",
)


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_model_config(arch: str, **overrides: Any) -> ModelConfig:
    """Load ``repro_torch/configs/<arch>.py`` and return its CONFIG."""

    cfg: ModelConfig = _module(arch).CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""

    return _module(arch).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
