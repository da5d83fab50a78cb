"""Plain PyTorch versions of the port's kernels (the allclose references).

``attention_ref`` is the plain version of the flash-attention kernel
(``repro_torch/kernels/csrc/flash_attention.cu``) and ``ssd_chunk_ref``
that of the SSD chunk kernel (``csrc/ssd_chunk.cu``): each is the CPU
path of its kernel's wrapper and what ``chip_smoke.py`` holds the kernel
against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) -> (B, H, Sq, D).

    Scores, softmax and P·V run in float32 whatever the input dtype; the
    result is cast back to q's dtype.  Masked scores are the finite
    ``NEG_INF``, so a row with no valid key averages V over all keys."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (q_pos >= k_pos)
    if window > 0:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ssd_chunk_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dt: torch.Tensor, cum: torch.Tensor):
    """Mamba2 SSD intra-chunk work for every (batch, chunk, head), in f32.

    x: (b, nc, L, nh, P) f32/bf16; B, C: (b, nc, L, N); dt, cum:
    (b, nc, L, nh), cum the in-chunk cumulative sum of dt·A.  Returns
    (y_intra (b, nc, L, nh, P) f32, states (b, nc, nh, N, P) f32):
      M[i, j] = (C_i · B_j) · exp(cum_i − cum_j) · dt_j for j ≤ i, else 0
      y_intra = M · x;  states = (B · exp(cum_L − cum) · dt)ᵀ · x
    The mask is a ``where``, not a product: above the diagonal
    exp(cum_i − cum_j) grows without bound and may be inf."""
    xf, Bf, Cf = x.float(), B.float(), C.float()
    dt, cum = dt.float(), cum.float()
    L = x.shape[2]
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)                 # (b,nc,L,L)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    M = CB[..., None] * decay * dt[:, :, None, :, :]            # (b,nc,i,j,nh)
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    M = torch.where(lower[:, :, None], M, torch.zeros((), device=x.device))
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xf)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt                  # (b,nc,L,nh)
    Bw = Bf[:, :, :, None, :] * w[..., None]                     # (b,nc,L,nh,N)
    states = torch.einsum("bcjhn,bcjhp->bchnp", Bw, xf)
    return y, states
