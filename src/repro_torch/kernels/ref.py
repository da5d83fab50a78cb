"""Plain PyTorch versions of the port's kernels (the allclose references).

``attention_ref`` is the plain version of the flash-attention kernel
(``repro_torch/kernels/csrc/flash_attention.cu``): the CPU path of
``flash_attention_fwd`` and what ``chip_smoke.py`` holds the kernel
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
