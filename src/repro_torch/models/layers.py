"""Common model primitives in PyTorch: norms, RoPE, attention, MLPs,
embeddings.  Port of the JAX package's ``models/layers.py``.

Conventions (as in the reference)
---------------------------------
* Parameters are nested dicts of tensors; layer stacks carry a leading
  ``n_layers`` axis, which the port walks with a Python loop.
* Compute runs in ``cfg.compute_dtype`` (bf16 by default); softmax and
  norm statistics run in f32.  Where JAX asks for an f32 result of a
  low-precision product (``preferred_element_type``), the port upcasts
  the operands, which gives the same exact products and f32 sums.
* Attention is GQA-general and keeps the model layout (B, S, H, D).
  Prefill attention goes to the hand-written flash kernel
  (``repro_torch.kernels``); decode (Sq == 1, or a per-sequence
  ``k_valid``) is the full-score ``naive_attention``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# dtype helpers

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initializers (seeded torch.Generator; numbers differ from jax.random)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def dense_init(gen, shape, dtype, device, fan_in: Optional[int] = None):
    """Scaled-normal init; fan_in defaults to the second-to-last dim."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return _normal(gen, shape, fan_in ** -0.5, dtype, device)


def embed_init(gen, shape, dtype, device):
    return _normal(gen, shape, 1.0, dtype, device)


# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics and full-size math in the input dtype,
    in the reference's op order (square in x's dtype, f32 mean, rsqrt
    cast to x's dtype, ``(1 + w)`` cast to x's dtype)."""
    var = torch.square(x).to(torch.float32).mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x * scale) * (1.0 + weight).to(x.dtype)


def rms_norm_init(d: int, device, lead: tuple = ()) -> torch.Tensor:
    # stored as (weight - 1) so zeros == identity (gemma convention)
    return torch.zeros((*lead, d), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# rotary position embeddings


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for given integer positions; shapes (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable (..., S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# attention parameters


def attention_init(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    """``lead`` prefixes every shape (the layer axis of a stack)."""
    d, h, kvh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (*lead, d, h, hd), dt, device, fan_in=d),
        "wk": dense_init(gen, (*lead, d, kvh, hd), dt, device, fan_in=d),
        "wv": dense_init(gen, (*lead, d, kvh, hd), dt, device, fan_in=d),
        "wo": dense_init(gen, (*lead, h, hd, d), dt, device, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, kvh, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, kvh, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, device, lead)
        p["k_norm"] = rms_norm_init(hd, device, lead)
    return p


def project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                kv_x: Optional[torch.Tensor] = None):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S_kv,KVH,hd)."""
    cdt = dtype_of(cfg.compute_dtype)
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x.to(cdt), p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", kv_x.to(cdt), p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", kv_x.to(cdt), p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def project_out(p: dict, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", o.to(cdt), p["wo"].to(cdt))


# ---------------------------------------------------------------------------
# attention

NEG_INF = -1e30


def _chunk_bias(q_pos, k_pos, causal: bool, window) -> torch.Tensor:
    """Additive mask bias (..., S_q, S_k) from position vectors."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dq >= dk)
    if window is not None:
        ok = ok & (dq - dk < window)
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def naive_attention(q, k, v, *, causal: bool, window=None,
                    softcap: float = 0.0, q_offset=0,
                    k_valid=None) -> torch.Tensor:
    """Reference full-score attention.  Also the decode path (Sq == 1),
    where the score matrix is (B, H, 1, Sk) and therefore small.

    ``q_offset``: an int, or a (B,) tensor of per-sequence positions.
    ``k_valid``: optional (B,) number of valid cache positions per sequence.
    """
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D) * (D ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    # q_pos: (Bq, Sq) where Bq is 1 (shared offset) or B (per-seq decode pos)
    offset = torch.as_tensor(q_offset, device=q.device).reshape(-1)
    q_pos = offset[:, None] + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    bias = _chunk_bias(q_pos, k_pos[None], causal, window)   # (Bq, Sq, Sk)
    s = s + bias[:, :, None, None, :]
    if k_valid is not None:
        valid = k_pos[None, :] < k_valid[:, None]            # (B, Sk)
        s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def attention(cfg: ModelConfig, q, k, v, *, causal, window=None,
              softcap: float = 0.0, q_offset=0, k_valid=None):
    """Dispatch on cfg.attention_impl and query length.

    "pallas" and "blocked" both go to the hand-written flash kernel (the
    reference's "blocked" is the XLA lowering of the same online-softmax
    function); on CPU tensors the kernel's wrapper runs its plain version.
    """
    if q.shape[1] == 1 or cfg.attention_impl == "naive" or k_valid is not None:
        return naive_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               k_valid=k_valid)
    if cfg.attention_impl not in ("pallas", "blocked"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if not isinstance(q_offset, int) or q_offset != 0:
        raise NotImplementedError("the flash kernel takes no q_offset; it "
                                  "comes with the training slice")
    from repro_torch.kernels import ops as kops
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)


# ---------------------------------------------------------------------------
# MLP (gated: SwiGLU / GeGLU)


def mlp_init(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {
        "w1": dense_init(gen, (*lead, d, ff), dt, device, fan_in=d),   # gate
        "w2": dense_init(gen, (*lead, ff, d), dt, device, fan_in=ff),  # down
    }
    if cfg.mlp_gated:
        p["w3"] = dense_init(gen, (*lead, d, ff), dt, device, fan_in=d)  # up
    return p


def activation(name: str):
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    act = activation(cfg.act)
    x = x.to(cdt)
    h = act(x @ p["w1"].to(cdt))
    if cfg.mlp_gated:
        h = h * (x @ p["w3"].to(cdt))
    return h @ p["w2"].to(cdt)


# ---------------------------------------------------------------------------
# embeddings / unembedding


def embedding_init(gen, cfg: ModelConfig, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    p = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                  device, fan_in=cfg.d_model)
    return p


def embed_tokens(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    x = F.embedding(tokens, p["embed"]).to(cdt)
    if cfg.family == "dense" and cfg.qk_norm:   # gemma scales embeddings
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
    return x


def unembed_matrix(p: dict, cfg: ModelConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return p["embed"].to(cdt).T
    return p["unembed"].to(cdt)
