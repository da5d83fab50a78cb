"""Mamba2 blocks via SSD (state-space duality, arXiv:2405.21060), in
PyTorch.  Port of the JAX package's ``models/ssm.py``.

Discrete recurrence per head (state N, head dim P):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)      h: (N, P)
    y_t = C_t · h_t + D * x_t

Prefill and training use the chunked SSD algorithm: the intra-chunk work
runs in the hand-written CUDA chunk kernel (``repro_torch.kernels``,
through ``kernels.ops.ssd``), the inter-chunk recurrence in torch.  The
step-by-step ``reference_scan`` is the oracle, and a single-token
``mamba_decode_step`` serves decoding.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    dense_init,
    dtype_of,
    rms_norm,
    rms_norm_init,
)


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.state_dim


def mamba_init(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    """One Mamba2 block, or with ``lead`` a stack of them.  ``dt_bias``
    comes from ``np.random.RandomState(0)``, the same for every layer, as
    in the reference."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nh, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    dt = dtype_of(cfg.param_dtype)
    # packed input projection: [z (d_inner), xBC (d_inner + 2N), dt (nh)]
    d_proj = 2 * d_inner + 2 * N + nh
    dt_init = np.exp(
        np.random.RandomState(0).uniform(
            np.log(s.dt_min), np.log(s.dt_max), size=(nh,)).astype("float32"))
    dt_bias = torch.from_numpy(np.log(np.expm1(dt_init)).astype(np.float32))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (*lead, d, d_proj), dt, device, fan_in=d),
        "conv_w": dense_init(gen, (*lead, s.conv_width, conv_ch), dt, device,
                             fan_in=s.conv_width),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=device),
        "A_log": torch.zeros((*lead, nh), **f32),     # A = -exp(A_log) = -1
        "D": torch.ones((*lead, nh), **f32),
        "dt_bias": dt_bias.to(device).expand(*lead, nh).clone(),
        "norm": rms_norm_init(d_inner, device, lead),
        "out_proj": dense_init(gen, (*lead, d_inner, d), dt, device,
                               fan_in=d_inner),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, nh, P, N = dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt_raw


def causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xBC: (B, S, Ch), w: (W, Ch).

    If ``state`` (B, W-1, Ch) is given it is prepended (decode streaming);
    returns (out, new_state).  The taps are summed in the reference's
    order (shifted inputs times w[0], w[1], ...)."""
    W = w.shape[0]
    if state is not None:
        xpad = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    else:
        xpad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(xpad[:, i:i + xBC.shape[1], :] * w[i][None, None, :]
              for i in range(W))
    out = out + b[None, None, :]
    new_state = xpad[:, -(W - 1):, :] if W > 1 else None
    return F.silu(out), new_state


def _preprocess(p: dict, cfg: ModelConfig, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Shared front half: in_proj + conv + head split + dt/A.  ``xh``,
    ``Bmat`` and ``Cmat`` are views into the conv output where the dtypes
    allow (the SSD kernel reads them strided)."""
    cdt = dtype_of(cfg.compute_dtype)
    d_inner, nh, P, N = dims(cfg)
    zxbcdt = x.to(cdt) @ p["in_proj"].to(cdt)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    xBC, new_conv = causal_conv(xBC, p["conv_w"].to(cdt),
                                p["conv_b"].to(cdt), conv_state)
    xs = xBC[..., :d_inner]
    Bmat = xBC[..., d_inner:d_inner + N].to(torch.float32)
    Cmat = xBC[..., d_inner + N:].to(torch.float32)
    B_, S_ = x.shape[0], x.shape[1]
    xh = xs.reshape(B_, S_, nh, P)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])     # (B,S,nh)
    A = -torch.exp(p["A_log"])                                     # (nh,)
    return z, xh, Bmat, Cmat, dt, A, new_conv


def _finish(p: dict, cfg: ModelConfig, y_heads: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    B_, S_ = z.shape[0], z.shape[1]
    d_inner = z.shape[-1]
    y = y_heads.reshape(B_, S_, d_inner).to(cdt)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(cdt)


def ssd_chunked(xh, Bmat, Cmat, dt, A, D, chunk: int,
                h_init: Optional[torch.Tensor] = None,
                intra_dtype=torch.float32):
    """Chunked SSD scan through the SSD chunk kernel (``kernels.ops.ssd``).

    xh: (B, S, nh, P); Bmat/Cmat: (B, S, N); dt: (B, S, nh); A: (nh,).
    Returns (y (B,S,nh,P) in ``intra_dtype``, h_final (B, nh, N, P) f32).
    As in the reference, x is rounded to a narrower ``intra_dtype`` first
    (the kernel upcasts it on load, so f32 needs no copy).  The kernel
    computes in f32 and ``y`` is cast at the end, where the reference keeps
    its intra-chunk products in ``intra_dtype``: with bf16 the two differ
    by bf16 rounding."""
    if torch.finfo(intra_dtype).bits < torch.finfo(xh.dtype).bits:
        xh = xh.to(intra_dtype)
    y, h_final = kops.ssd(xh, Bmat, Cmat, dt, A, D, chunk, h_init=h_init)
    return y.to(intra_dtype), h_final


def reference_scan(xh, Bmat, Cmat, dt, A, D,
                   h_init: Optional[torch.Tensor] = None):
    """Step-by-step oracle recurrence (tests, and ``impl="scan"``)."""
    B_, S, nh, P = xh.shape
    N = Bmat.shape[-1]
    h = (torch.zeros((B_, nh, N, P), dtype=torch.float32, device=xh.device)
         if h_init is None else h_init.float())
    ys = []
    for t in range(S):
        x_t, b_t, c_t, dt_t = xh[:, t].float(), Bmat[:, t], Cmat[:, t], \
            dt[:, t]
        a_t = torch.exp(dt_t * A[None, :])                     # (B,nh)
        upd = torch.einsum("bn,bhp,bh->bhnp", b_t, x_t, dt_t)
        h = h * a_t[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c_t, h)
                  + D[None, :, None] * x_t)
    return torch.stack(ys, dim=1), h


def mamba_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  impl: str = "chunked") -> torch.Tensor:
    """Full-sequence mamba block. x: (B, S, d) -> (B, S, d).  ``impl``
    "chunked" goes through the SSD kernel; anything else runs the
    step-by-step ``reference_scan``, as in the reference."""
    z, xh, Bmat, Cmat, dt, A, _ = _preprocess(p, cfg, x)
    if impl == "chunked":
        y, _ = ssd_chunked(xh, Bmat, Cmat, dt, A, p["D"], cfg.ssm.chunk_size,
                           intra_dtype=dtype_of(cfg.ssm.intra_dtype))
    else:
        y, _ = reference_scan(xh, Bmat, Cmat, dt, A, p["D"])
    return _finish(p, cfg, y, z)


def mamba_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Forward that also returns (conv_state, ssm_state) for decoding."""
    z, xh, Bmat, Cmat, dt, A, conv_state = _preprocess(p, cfg, x)
    y, h_final = ssd_chunked(xh, Bmat, Cmat, dt, A, p["D"],
                             cfg.ssm.chunk_size,
                             intra_dtype=dtype_of(cfg.ssm.intra_dtype))
    return _finish(p, cfg, y, z), (conv_state, h_final.float())


def mamba_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x: (B, 1, d); states from prefill.  Returns (y, conv_state,
    ssm_state).  Where the reference donates the cache and returns new
    states, the port writes the new conv and SSM states into the given
    tensors in place and returns them."""
    z, xh, Bmat, Cmat, dt, A, new_conv = _preprocess(p, cfg, x, conv_state)
    x_t = xh[:, 0].float()                                # (B,nh,P)
    b_t, c_t, dt_t = Bmat[:, 0], Cmat[:, 0], dt[:, 0]
    a_t = torch.exp(dt_t * A[None, :])
    upd = torch.einsum("bn,bhp,bh->bhnp", b_t, x_t, dt_t)
    h = ssm_state * a_t[..., None, None] + upd
    y_t = torch.einsum("bn,bhnp->bhp", c_t, h) + \
        p["D"][None, :, None] * x_t
    y = _finish(p, cfg, y_t[:, None], z)
    conv_state.copy_(new_conv)
    ssm_state.copy_(h)
    return y, conv_state, ssm_state
