"""mamba2-370m  [ssm]

48L d_model=1024 (attn-free) d_ff=0 vocab=50280, ssm_state=128 — SSD
(state-space duality) [arXiv:2405.21060; unverified].

Pure Mamba2: d_inner = 2*d_model = 2048, 32 SSD heads of head_dim 64,
conv width 4, chunked SSD scan.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2,
                      conv_width=4, chunk_size=256),
        tie_embeddings=True,
        act="silu",
        vocab_chunk=16384,
        remat_group=8,
    ),
    reduced=ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                      conv_width=4, chunk_size=32),
        tie_embeddings=True,
        act="silu",
    ),
)
