"""Model-layout wrappers around the port's kernels.

The model keeps attention tensors as (B, S, H, D); the kernel takes
(B, H, S, D).  The kernel reads strided views, so the transposes here
copy nothing.  Launches are counted on the wrappers that launch the
kernels, ``flash_attention.flash_attention_fwd`` and
``ssd_scan.ssd_chunk_fwd``.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ssd_scan import ssd_scan


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap: float = 0.0):
    """Model-layout wrapper: q (B, Sq, H, D); k/v (B, Sk, KVH, D)."""
    win = int(window) if window else 0
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=win,
                              softcap=softcap)
    return out.transpose(1, 2)


def ssd(x, B, C, dt, A, D, chunk: int = 256, *, h_init=None):
    """Mamba2 SSD over full sequences (see kernels/ssd_scan.py); returns
    (y (b, S, nh, P) f32, h_final (b, nh, N, P) f32).  ``h_init`` is an
    optional starting state, as the reference's model-side
    ``ssd_chunked`` takes."""
    return ssd_scan(x, B, C, dt, A, D, chunk, h_init=h_init)
