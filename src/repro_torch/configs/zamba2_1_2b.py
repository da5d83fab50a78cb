"""zamba2-1.2b  [hybrid]

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64 —
Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

38 Mamba2 blocks; a single *shared-weight* attention+MLP transformer block
is applied after every 6th Mamba block (Zamba2's shared block pattern).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2,
                      conv_width=4, chunk_size=256),
        shared_attn_every=6,
        tie_embeddings=True,
        act="gelu",
    ),
    reduced=ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                      conv_width=4, chunk_size=32),
        shared_attn_every=2,
        tie_embeddings=True,
        act="gelu",
    ),
)
