"""Mamba2 SSD: the wrapper of the hand-written CUDA chunk kernel, and the
full scan around it.

Port of the JAX package's ``kernels/ssd_scan.py`` (``ssd_chunk_pallas``,
``ssd_scan``); the kernel itself is ``csrc/ssd_chunk.cu``.  On a CUDA
tensor ``ssd_chunk_fwd`` launches the kernel or raises; on a CPU tensor it
runs the plain version, ``ref.ssd_chunk_ref``.  ``ssd_chunk_fwd.launches``
counts kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_ref

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE_DIM = 256, 64, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, B, C, dt, cum) -> None:
    if x.dim() != 5 or any(t.dim() != 4 for t in (B, C, dt, cum)):
        raise ValueError("ssd_chunk_fwd takes x (b, nc, L, nh, P), B and C "
                         "(b, nc, L, N), dt and cum (b, nc, L, nh)")
    b, nc, L, nh, _ = x.shape
    if B.shape != C.shape or tuple(B.shape[:3]) != (b, nc, L):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if dt.shape != cum.shape or tuple(dt.shape) != (b, nc, L, nh):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, cum {tuple(cum.shape)}")
    if x.numel() == 0 or B.shape[-1] == 0:
        raise ValueError("empty input")
    if {t.device for t in (B, C, dt, cum)} != {x.device}:
        raise ValueError("the inputs lie on different devices")


def ssd_chunk_fwd(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dt: torch.Tensor, cum: torch.Tensor):
    """Intra-chunk SSD for every (batch, chunk, head).

    x: (b, nc, L, nh, P) f32/bf16; B, C: (b, nc, L, N) f32; dt, cum:
    (b, nc, L, nh) f32.  Returns (y_intra (b, nc, L, nh, P) f32, states
    (b, nc, nh, N, P) f32), new contiguous tensors.  Inputs may be any
    strided views.  The kernel takes L <= 256, P <= 64 and N <= 128, with P
    and N multiples of 4."""
    _check(x, B, C, dt, cum)
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, B, C, dt, cum)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 x, not {x.dtype}")
    if any(t.dtype != torch.float32 for t in (B, C, dt, cum)):
        raise TypeError("the kernel takes float32 B, C, dt and cum")
    b, nc, L, nh, P = x.shape
    N = B.shape[-1]
    if not (L <= MAX_CHUNK and P <= MAX_HEAD_DIM and N <= MAX_STATE_DIM
            and P % 4 == 0 and N % 4 == 0):
        raise ValueError(f"the kernel takes L <= {MAX_CHUNK}, P <= "
                         f"{MAX_HEAD_DIM} and N <= {MAX_STATE_DIM}, P and N "
                         f"multiples of 4; got L={L}, P={P}, N={N}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, B, C, dt, cum)):
        raise NotImplementedError("the SSD kernel has no backward yet; it "
                                  "comes with the training slice")
    lib = _build.library("ssd_chunk")
    y = torch.empty((b, nc, L, nh, P), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, nh, N, P), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_ssd_chunk_fwd(
            x.device.index, _DTYPE_CODES[x.dtype], x.data_ptr(),
            B.data_ptr(), C.data_ptr(), dt.data_ptr(), cum.data_ptr(),
            y.data_ptr(), states.data_ptr(),
            b, nc, L, nh, P, N, *x.stride(), *B.stride(), *C.stride(),
            *dt.stride(), *cum.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_fwd: CUDA error {rc} at launch")
    ssd_chunk_fwd.launches += 1
    return y, states


ssd_chunk_fwd.launches = 0


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor, chunk: int,
             h_init: Optional[torch.Tensor] = None):
    """Full SSD: the chunk kernel, then the inter-chunk recurrence in torch.

    x: (b, S, nh, P); B, C: (b, S, N) f32; dt: (b, S, nh); A, D: (nh,);
    ``h_init``: optional (b, nh, N, P) starting state.  Returns (y (b, S,
    nh, P) f32, h_final (b, nh, N, P) f32)."""
    b, S, nh, P = x.shape
    N = B.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, f"S={S} % chunk={L}"
    nc = S // L

    xc = x.reshape(b, nc, L, nh, P)
    Bc = B.reshape(b, nc, L, N)
    Cc = C.reshape(b, nc, L, N)
    dtc = dt.reshape(b, nc, L, nh).float()
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)

    y_intra, states = ssd_chunk_fwd(xc, Bc, Cc, dtc, cum)

    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b, nc, nh)
    h = (torch.zeros((b, nh, N, P), dtype=torch.float32, device=x.device)
         if h_init is None else h_init.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                      # (b,nc,nh,N,P)

    y_inter = torch.einsum("bcln,bchnp->bclhp", Cc.float(), h_prev) \
        * torch.exp(cum)[..., None]
    y = y_intra + y_inter + D[None, None, None, :, None] * xc.float()
    return y.reshape(b, S, nh, P), h
