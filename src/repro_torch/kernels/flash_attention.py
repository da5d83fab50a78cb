"""Flash-attention forward: the wrapper of the hand-written CUDA kernel.

Port of the JAX package's ``kernels/flash_attention.py``
(``flash_attention_pallas``); the kernel itself is
``csrc/flash_attention.cu``.  On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version,
``ref.attention_ref``.  ``flash_attention_fwd.launches`` counts kernel
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes 4-d (B, H, S, D) tensors")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads over {k.shape[1]} KV heads")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    if {t.device for t in (q, k, v)} != {q.device}:
        raise ValueError("q, k and v lie on different devices")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError("q, k and v differ in dtype")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D).  Returns (B, H, Sq, D).

    ``window`` <= 0 means full attention.  Inputs may be strided views as
    long as the head dim is dense; the output is a new contiguous tensor.
    """
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim must be dense (stride 1)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the flash kernel has no backward yet; it "
                                  "comes with the training slice")
    lib = _build.library("flash_attention")
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_flash_attention_fwd(
            q.device.index, _DTYPE_CODES[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KVH, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), int(window), float(softcap),
            D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {rc} at launch")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
