"""qwen2-7b  [dense]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — GQA, QKV bias
[arXiv:2407.10671; hf].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        act="silu",
        vocab_chunk=16384,
        remat_group=7,
    ),
    reduced=ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        qkv_bias=True,
        act="silu",
    ),
)
