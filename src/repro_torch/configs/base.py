"""Configuration system for repro_torch.

A copy, field for field, of the JAX package's ``configs/base.py``
(``ModelConfig``, ``MoEConfig``, ``SSMConfig`` and the registry), so the
port reads the same configurations without importing that package.
Configs are plain dataclasses (no framework dependency) so they can be
hashed, serialized and diffed; the tests hold ``dataclasses.asdict`` of
each copy equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # number of token groups used by the capacity-based dispatch.  0 means
    # "one group per data shard", resolved against the mesh at lowering time.
    n_groups: int = 0
    # target tokens per dispatch group (smaller -> smaller dispatch/combine
    # tensors and fewer dispatch FLOPs, at more capacity-drop variance)
    group_tokens: int = 2048
    aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 1e-3
    # "tp"  : experts' ffn dim sharded over the model axis (tensor parallel)
    # "ep"  : expert dim sharded over the model axis (expert parallel)
    expert_sharding: str = "tp"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters."""
    state_dim: int = 0          # N (ssm_state)
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256       # SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 0.1
    # dtype of the full-size intra-chunk tensors (states stay f32);
    # "bfloat16" halves the SSD HBM traffic at bf16 storage precision
    intra_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0      # gemma3 global layers; 0 -> rope_theta
    sliding_window: int = 0             # 0 -> full attention
    local_global_ratio: int = 0         # gemma3: N local layers per 1 global
    attn_logit_softcap: float = 0.0     # grok/gemma-style soft capping
    # --- mixture of experts -------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    # --- state space --------------------------------------------------------
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # --- hybrid (zamba2): a shared attention block every k ssm blocks -------
    shared_attn_every: int = 0
    # --- encoder/decoder (whisper) ------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0                # precomputed frame count (stub frontend)
    # --- vision (llama-3.2): gated cross-attn every k layers -----------------
    cross_attn_every: int = 0
    vision_tokens: int = 0              # precomputed patch-embedding count
    # --- misc ----------------------------------------------------------------
    act: str = "silu"                   # silu | gelu
    mlp_gated: bool = True              # SwiGLU/GeGLU vs plain 2-matrix MLP
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_position_embeddings: int = 1_048_576
    # --- numerics ------------------------------------------------------------
    param_dtype: str = "float32"        # master parameter dtype
    compute_dtype: str = "bfloat16"
    # vocabulary-chunked cross entropy (0 = disabled); bounds logits memory.
    vocab_chunk: int = 0
    # optimizer selection for this scale ("adamw" | "adafactor")
    optimizer: str = "adamw"
    # remat policy for the scanned layer ("full" | "dots" | "none")
    remat: str = "full"
    # nested remat: split the layer scan into this many checkpointed
    # groups (0 = flat scan). sqrt(n_layers)-ish gives minimal memory.
    remat_group: int = 0
    # attention implementation.  In the port both "blocked" and "pallas"
    # run the hand-written flash kernel (repro_torch.kernels), and
    # "naive" the full-score reference.
    attention_impl: str = "blocked"
    attention_block_k: int = 512

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs that run the long_500k shape."""
        if self.family in ("ssm", "hybrid"):
            return True
        # sliding-window-dominant (gemma3 5:1 local:global)
        return self.local_global_ratio > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry

_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    reduced: ModelConfig    # CPU-smoke-test variant of the same family


def register(config: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    if config.name in _REGISTRY:
        raise ValueError(f"duplicate arch {config.name!r}")
    _REGISTRY[config.name] = ArchEntry(config=config, reduced=reduced)
    return config


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    entry = _REGISTRY[name]
    return entry.reduced if reduced else entry.config


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    """Import every config module exactly once (they self-register).
    The port carries the architectures its slices serve so far."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        mamba2_370m,
        qwen1_5_4b,
        qwen2_7b,
        zamba2_1_2b,
    )
