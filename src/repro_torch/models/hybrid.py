"""Zamba2-style hybrid in PyTorch: a Mamba2 backbone with a single
*shared-weight* attention+MLP transformer block applied after every k-th
Mamba block.  Port of the JAX package's ``models/hybrid.py``.

The layer stack is split into groups of ``shared_attn_every`` Mamba
blocks, each followed by one application of the shared block.  The shared
block's weights are the same at every site; its KV caches are per-site
(stacked on a site axis).  Prefill attention goes through the flash
kernel (``layers.attention``); decode attention is ``naive_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_rope,
    attention,
    mlp_apply,
    project_out,
    project_qkv,
    rms_norm,
    rms_norm_init,
    rope_table,
)
from repro_torch.models.transformer import (
    layer_params,
    self_layer_init,
    self_layer_train,
)


def n_shared_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def group_slices(cfg: ModelConfig):
    """[(start, size, shared_after)] covering all n_layers."""
    k = cfg.shared_attn_every
    out = []
    start = 0
    while start < cfg.n_layers:
        size = min(k, cfg.n_layers - start)
        out.append((start, size, size == k))
        start += size
    return out


def hybrid_stack_init(gen, cfg: ModelConfig, device) -> dict:
    return {
        "mamba": ssm_lib.mamba_init(gen, cfg, device, lead=(cfg.n_layers,)),
        "shared": self_layer_init(gen, cfg, device),
        "ln_f": rms_norm_init(cfg.d_model, device),
    }


def hybrid_forward(params, cfg: ModelConfig, x, *,
                   collect_state: bool = False):
    """Train/prefill forward.  Returns (x, aux, caches) where caches (when
    ``collect_state``) hold per-layer mamba states and per-site shared-
    attention KV."""
    S = x.shape[1]
    rope = rope_table(torch.arange(S, device=x.device),
                      cfg.resolved_head_dim, cfg.rope_theta)
    conv_states, ssm_states, shared_k, shared_v = [], [], [], []
    for (start, size, shared_after) in group_slices(cfg):
        for i in range(start, start + size):
            p = layer_params(params["mamba"], i)
            if collect_state:
                y, (cs, hs) = ssm_lib.mamba_prefill(p, cfg, x)
                conv_states.append(cs)
                ssm_states.append(hs)
            else:
                y = ssm_lib.mamba_forward(p, cfg, x)
            x = x + y
        if shared_after:
            x, kv, _ = self_layer_train(params["shared"], cfg, x,
                                        (rope, rope), True, collect_state)
            if collect_state:
                shared_k.append(kv[0])
                shared_v.append(kv[1])

    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if not collect_state:
        return x, {}, None
    cache = {
        "conv": torch.stack(conv_states),
        "ssm": torch.stack(ssm_states),
        "shared_k": torch.stack(shared_k),
        "shared_v": torch.stack(shared_v),
    }
    return x, {}, cache


def hybrid_decode(params, cfg: ModelConfig, x, cache, pos):
    """x: (B,1,d).  cache: conv (L,B,W-1,Ch), ssm (L,B,nh,N,P), shared_k/v
    (sites,B,S,KVH,hd).  Every state and the new keys and values are
    written into the cache in place (the reference donates it); the
    returned dict holds the same tensors."""
    rope = rope_table(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    bidx = torch.arange(x.shape[0], device=x.device)
    site = 0
    for (start, size, shared_after) in group_slices(cfg):
        for i in range(start, start + size):
            y, _, _ = ssm_lib.mamba_decode_step(
                layer_params(params["mamba"], i), cfg, x, cache["conv"][i],
                cache["ssm"][i])
            x = x + y
        if shared_after:
            p = params["shared"]
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = project_qkv(p["attn"], cfg, h)
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
            ck, cv = cache["shared_k"][site], cache["shared_v"][site]
            ck[bidx, pos] = k[:, 0].to(ck.dtype)
            cv[bidx, pos] = v[:, 0].to(cv.dtype)
            o = attention(cfg, q, ck, cv, causal=False, q_offset=pos,
                          k_valid=pos + 1)
            x = x + project_out(p["attn"], cfg, o)
            m = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_apply(p["mlp"], cfg, m)
            site += 1

    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, cache, {}
