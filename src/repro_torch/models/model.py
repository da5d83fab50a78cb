"""Model facade: init / forward / prefill / decode for the dense family.
Port of the dense dispatch of the JAX package's ``models/model.py``.

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
from repro_torch.models import transformer as tf_lib
from repro_torch.models.layers import (
    dtype_of,
    embed_tokens,
    embedding_init,
    unembed_matrix,
)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (dense only)")


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
    return {"embedding": embedding_init(gen, cfg, dev),
            "stack": tf_lib.dense_stack_init(gen, cfg, dev)}


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


def forward(params, cfg: ModelConfig, batch: dict, *,
            collect_kv: bool = False, device: DeviceLike = None):
    """Returns (hidden (B,S,d), aux dict, caches-or-None)."""
    _check_family(cfg)
    dev = _params_device(params, device)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = embed_tokens(params["embedding"], cfg, tokens)
    return tf_lib.dense_forward(params["stack"], cfg, x,
                                collect_kv=collect_kv)


def _logits(hidden_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """(B, d) x (d, V) -> (B, V) float32, as JAX's ``preferred_element_type``
    f32 einsum: exact products of the compute-dtype operands, f32 sums."""
    return hidden_last.float() @ unembed.float()


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> dict:
    """Zero-initialized decode cache, (L, B, max_len, KVH, hd) keys and
    values in the compute dtype."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=dev),
            "v": torch.zeros(shape, dtype=cdt, device=dev)}


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
    hidden, _, kvs = forward(params, cfg, batch, collect_kv=True,
                             device=device)
    B, S = batch["tokens"].shape
    cache = {"k": kvs[0], "v": kvs[1]}
    if pad_to:
        cache = {k: _pad_seq(v, 2, pad_to) for k, v in cache.items()}
    logits = _logits(hidden[:, -1, :], unembed_matrix(params["embedding"], cfg))
    pos = torch.full((B,), S, dtype=torch.long, device=hidden.device)
    return cache, logits, pos


# ---------------------------------------------------------------------------
# decode


def decode_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, device: DeviceLike = None):
    """tokens: (B, 1) integers, pos: (B,) integer write positions.

    Returns (logits (B, V) f32, cache).  The cache is updated in place
    (the reference donates it); the returned dict holds the same tensors."""
    _check_family(cfg)
    dev = _params_device(params, device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    x = embed_tokens(params["embedding"], cfg, tokens)
    h, cache, _ = tf_lib.dense_decode(params["stack"], cfg, x, cache, pos)
    logits = _logits(h[:, -1, :], unembed_matrix(params["embedding"], cfg))
    return logits, cache
