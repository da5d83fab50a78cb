"""Decoder-only dense transformer stack (llama/qwen family) in PyTorch.
Port of the dense part of the JAX package's ``models/transformer.py``.

Layer parameters are stacked with a leading ``n_layers`` axis, as in the
reference; where JAX scans over that axis, the port loops over it in
Python and takes each layer's parameters as views.

Modes:
  train   — full-sequence forward, no caches.
  prefill — full-sequence forward, returns KV caches (post-RoPE keys).
  decode  — single-token step against KV caches at per-sequence positions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    attention,
    attention_init,
    mlp_apply,
    mlp_init,
    project_out,
    project_qkv,
    rms_norm,
    rms_norm_init,
    rope_table,
)

# ---------------------------------------------------------------------------
# init


def self_layer_init(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    """One self-attention layer (zamba2's shared block), or with ``lead``
    a stack of them, each parameter on leading axes of that shape."""
    if cfg.moe.n_experts > 0:
        raise NotImplementedError("the moe family is not ported yet")
    return {
        "ln1": rms_norm_init(cfg.d_model, device, lead),
        "attn": attention_init(gen, cfg, device, lead),
        "ln2": rms_norm_init(cfg.d_model, device, lead),
        "mlp": mlp_init(gen, cfg, device, lead),
    }


def stack_init(gen, cfg: ModelConfig, n: int, device) -> dict:
    """``n`` self-attention layers, each parameter stacked on a leading
    axis of size ``n`` (the reference vmaps a per-layer init)."""
    return self_layer_init(gen, cfg, device, lead=(n,))


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters, as views into the stacked tensors."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def is_global_flags(cfg: ModelConfig, n: int) -> torch.Tensor:
    """gemma3-style local:global pattern; all-global when ratio == 0."""
    if cfg.local_global_ratio <= 0:
        return torch.ones((n,), dtype=torch.bool)
    period = cfg.local_global_ratio + 1
    return (torch.arange(n) + 1) % period == 0


# ---------------------------------------------------------------------------
# rope helpers (dual-theta for gemma3 local/global)


def _rope_pair(cfg: ModelConfig, positions: torch.Tensor):
    hd = cfg.resolved_head_dim
    local = rope_table(positions, hd, cfg.rope_theta or 10_000.0)
    if cfg.rope_theta_global:
        glob = rope_table(positions, hd, cfg.rope_theta_global)
    else:
        glob = local
    return local, glob


def _select_rope(local, glob, is_global: bool):
    return glob if is_global else local


# ---------------------------------------------------------------------------
# single-layer bodies


def _window_for(cfg: ModelConfig, is_global: bool, s_k: int):
    if cfg.sliding_window <= 0:
        return None
    return s_k + 1 if is_global else cfg.sliding_window


def _ffn(p: dict, cfg: ModelConfig, h: torch.Tensor):
    if cfg.moe.n_experts > 0:
        raise NotImplementedError("the moe family is not ported yet")
    return mlp_apply(p["mlp"], cfg, h), None


def self_layer_train(p, cfg: ModelConfig, x, rope_lg, is_global: bool,
                     collect_kv: bool):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(p["attn"], cfg, h)
    cos, sin = _select_rope(*rope_lg, is_global)
    if cfg.rope_theta:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    win = _window_for(cfg, is_global, k.shape[1])
    o = attention(cfg, q, k, v, causal=True, window=win,
                  softcap=cfg.attn_logit_softcap)
    x = x + project_out(p["attn"], cfg, o)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    ff, aux = _ffn(p, cfg, h2)
    kv = (k, v) if collect_kv else None
    return x + ff, kv, aux


def self_layer_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos,
                      rope_lg, is_global: bool, layer: int):
    """x: (B,1,d); pos: (B,) write positions.

    cache_k/v are the FULL stacked (L, B, S, KVH, hd) caches, written at
    ``layer``.  Where JAX donates the cache and lets XLA alias the update,
    the port writes the new keys and values into the caches in place: the
    caller's tensors are updated and returned."""
    B = x.shape[0]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(p["attn"], cfg, h)
    cos, sin = _select_rope(*rope_lg, is_global)   # (B, 1, hd/2)
    if cfg.rope_theta:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    ck, cv = cache_k[layer], cache_v[layer]
    ck[bidx, pos] = k[:, 0].to(ck.dtype)
    cv[bidx, pos] = v[:, 0].to(cv.dtype)
    win = _window_for(cfg, is_global, ck.shape[1])
    o = attention(cfg, q, ck, cv, causal=False, window=win,
                  softcap=cfg.attn_logit_softcap, q_offset=pos,
                  k_valid=pos + 1)
    x = x + project_out(p["attn"], cfg, o)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    ff, aux = _ffn(p, cfg, h2)
    return x + ff, cache_k, cache_v, aux


# ---------------------------------------------------------------------------
# aux outputs (moe losses; zeros for the dense family)

_AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")


def _aux_zero(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in _AUX_KEYS}


# ---------------------------------------------------------------------------
# dense stack


def dense_stack_init(gen, cfg: ModelConfig, device) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family is not ported yet")
    return {"layers": stack_init(gen, cfg, cfg.n_layers, device),
            "ln_f": rms_norm_init(cfg.d_model, device)}


def dense_forward(params, cfg: ModelConfig, x, *, collect_kv: bool = False):
    """Train/prefill forward for the dense family.

    Returns (hidden, aux, kvs) where kvs is ((L,B,S,KVH,hd) keys, values)
    when ``collect_kv``, else None."""
    S = x.shape[1]
    rope_lg = _rope_pair(cfg, torch.arange(S, device=x.device))
    flags = is_global_flags(cfg, cfg.n_layers).tolist()
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, kv, _ = self_layer_train(layer_params(params["layers"], i), cfg,
                                    x, rope_lg, flags[i], collect_kv)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, _aux_zero(x.device), kvs


def dense_decode(params, cfg: ModelConfig, x, cache, pos):
    """cache: {"k": (L,B,S,KVH,hd), "v": ...}, updated in place; pos: (B,)."""
    rope_lg = _rope_pair(cfg, pos[:, None])      # (B,1,hd/2) tables
    flags = is_global_flags(cfg, cfg.n_layers).tolist()
    ck, cv = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        x, ck, cv, _ = self_layer_decode(layer_params(params["layers"], i),
                                         cfg, x, ck, cv, pos, rope_lg,
                                         flags[i], layer=i)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, {"k": ck, "v": cv}, _aux_zero(x.device)
