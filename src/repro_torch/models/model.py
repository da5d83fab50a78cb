"""Model facade: init / forward / prefill / decode for the dense, ssm
and hybrid families.  Port of that dispatch of the JAX package's
``models/model.py``.

Batch dict keys:
  tokens        (B, S) integers (tensor or array) — always present

Every entry point takes ``device=None``, which means the CUDA card
(``repro_torch.device``); the CPU runs only when a caller passes
``device="cpu"``.  ``forward``, ``prefill`` and ``decode_step`` check
that the parameters lie on that device.  Serving callers wrap these
calls in ``torch.inference_mode()`` (``repro_torch.serve.engine`` does).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.layers import (
    dtype_of,
    embed_tokens,
    embedding_init,
    rms_norm,
    rms_norm_init,
    unembed_matrix,
)
from repro_torch.models.transformer import layer_params

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet "
            f"(have {', '.join(PORTED_FAMILIES)})")


# ---------------------------------------------------------------------------
# init


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on the device,
    in the reference's tree layout (stacked layers).  The numbers differ
    from ``jax.random``'s; tests move JAX parameters over with
    ``repro_torch.bridge.from_jax`` instead."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {"embedding": embedding_init(gen, cfg, dev)}
    if cfg.family == "dense":
        p["stack"] = tf_lib.dense_stack_init(gen, cfg, dev)
    elif cfg.family == "ssm":
        p["stack"] = {"layers": ssm_lib.mamba_init(gen, cfg, dev,
                                                   lead=(cfg.n_layers,)),
                      "ln_f": rms_norm_init(cfg.d_model, dev)}
    else:
        p["stack"] = hybrid_lib.hybrid_stack_init(gen, cfg, dev)
    return p


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# forward (train / prefill)


def _params_device(params, device: DeviceLike) -> torch.device:
    """The device the call runs on: ``device`` (None -> CUDA), which must
    be where the parameters lie."""
    dev = resolve_device(device)
    held = params["embedding"]["embed"].device
    if held.type != dev.type:
        raise ValueError(f"params lie on {held}, the call runs on {dev}")
    return held


def _ssm_forward(params, cfg: ModelConfig, x, collect_state: bool):
    """The ssm stack; the reference's ``remat_group`` only regroups its
    scan for training memory and does not change the function."""
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        if collect_state:
            y, (cs, hs) = ssm_lib.mamba_prefill(p, cfg, x)
            convs.append(cs)
            ssms.append(hs)
        else:
            y = ssm_lib.mamba_forward(p, cfg, x)
        x = x + y
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache = None
    if collect_state:
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
    return x, {}, cache


def forward(params, cfg: ModelConfig, batch: dict, *,
            collect_kv: bool = False, device: DeviceLike = None):
    """Returns (hidden (B,S,d), aux dict, caches-or-None)."""
    _check_family(cfg)
    dev = _params_device(params, device)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = embed_tokens(params["embedding"], cfg, tokens)
    stack = params["stack"]
    if cfg.family == "ssm":
        return _ssm_forward(stack, cfg, x, collect_kv)
    if cfg.family == "hybrid":
        return hybrid_lib.hybrid_forward(stack, cfg, x,
                                         collect_state=collect_kv)
    return tf_lib.dense_forward(stack, cfg, x, collect_kv=collect_kv)


def _logits(hidden_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """(B, d) x (d, V) -> (B, V) float32, as JAX's ``preferred_element_type``
    f32 einsum: exact products of the compute-dtype operands, f32 sums."""
    return hidden_last.float() @ unembed.float()


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> dict:
    """Zero-initialized decode cache: dense (L, B, max_len, KVH, hd) keys
    and values; ssm per-layer conv (L, B, W-1, Ch) and SSM (L, B, nh, N,
    P) f32 states; hybrid those plus per-site shared-attention keys and
    values (sites, B, max_len, KVH, hd).  Compute dtype but for the SSM
    states."""
    _check_family(cfg)
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    L, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.family == "dense":
        shape = (L, batch, max_len, KVH, hd)
        return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                "v": torch.zeros(shape, dtype=cdt, device=dev)}
    d_inner, nh, P, N = ssm_lib.dims(cfg)
    W = cfg.ssm.conv_width
    cache = {
        "conv": torch.zeros((L, batch, W - 1, d_inner + 2 * N), dtype=cdt,
                            device=dev),
        "ssm": torch.zeros((L, batch, nh, N, P), dtype=torch.float32,
                           device=dev),
    }
    if cfg.family == "hybrid":
        shape = (hybrid_lib.n_shared_sites(cfg), batch, max_len, KVH, hd)
        cache["shared_k"] = torch.zeros(shape, dtype=cdt, device=dev)
        cache["shared_v"] = torch.zeros(shape, dtype=cdt, device=dev)
    return cache


def _pad_seq(a: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    pad = to - a.shape[axis]
    if pad <= 0:
        return a
    widths = [0, 0] * (a.ndim - axis - 1) + [0, pad]   # F.pad: last dim first
    return F.pad(a, widths)


def prefill(params, cfg: ModelConfig, batch: dict,
            pad_to: Optional[int] = None, *, device: DeviceLike = None):
    """Full-sequence forward building decode caches.  Returns
    (cache, last_logits (B, V) f32, next_pos (B,))."""
    hidden, _, cache = forward(params, cfg, batch, collect_kv=True,
                               device=device)
    B, S = batch["tokens"].shape
    if cfg.family == "dense":
        cache = {"k": cache[0], "v": cache[1]}
    if pad_to:
        seq_keys = ("k", "v", "shared_k", "shared_v")     # (.., B, S, ..)
        cache = {k: _pad_seq(v, 2, pad_to) if k in seq_keys else v
                 for k, v in cache.items()}
    logits = _logits(hidden[:, -1, :], unembed_matrix(params["embedding"], cfg))
    pos = torch.full((B,), S, dtype=torch.long, device=hidden.device)
    return cache, logits, pos


# ---------------------------------------------------------------------------
# decode


def decode_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, device: DeviceLike = None):
    """tokens: (B, 1) integers, pos: (B,) integer write positions (the
    ssm family's state has no positions and ignores them).

    Returns (logits (B, V) f32, cache).  The cache is updated in place
    (the reference donates it); the returned dict holds the same tensors."""
    _check_family(cfg)
    dev = _params_device(params, device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    x = embed_tokens(params["embedding"], cfg, tokens)
    stack = params["stack"]
    if cfg.family == "ssm":
        h = x
        for i in range(cfg.n_layers):
            y, _, _ = ssm_lib.mamba_decode_step(
                layer_params(stack["layers"], i), cfg, h, cache["conv"][i],
                cache["ssm"][i])
            h = h + y
        h = rms_norm(h, stack["ln_f"], cfg.norm_eps)
    elif cfg.family == "hybrid":
        h, cache, _ = hybrid_lib.hybrid_decode(stack, cfg, x, cache, pos)
    else:
        h, cache, _ = tf_lib.dense_decode(stack, cfg, x, cache, pos)
    logits = _logits(h[:, -1, :], unembed_matrix(params["embedding"], cfg))
    return logits, cache
