"""Flash-attention forward: the wrapper of the hand-written CUDA kernels.

Port of the JAX package's ``kernels/flash_attention.py``
(``flash_attention_pallas``); the kernels are in
``csrc/flash_attention.cu``.  On a CUDA tensor the wrapper launches a
kernel or raises; on a CPU tensor it runs the plain version,
``ref.attention_ref``.  Which kernel runs is ``kernel_route(dtype, D)``:
bf16 at head dim 64 or 128 goes to the Hopper kernel on the tensor cores
(wgmma fed by TMA), everything else to the float32 SIMT kernel.
``flash_attention_fwd.launches`` counts all kernel launches and
``flash_attention_fwd.wgmma_launches`` those of the wgmma kernel, so a run
can show which path went through which kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"simt": 0, "wgmma": 1}


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head dim): "wgmma" or "simt".

    float32 stays on the SIMT kernel at every head dim (a bf16 or TF32
    product cannot meet the float32 bar), and so does bf16 at head dims
    below 64, which do not fill a 128-byte swizzled row."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, not {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


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


def _check_tma(t: torch.Tensor) -> None:
    """TMA reads a tensor whose base is 16-byte aligned and whose strides
    (of dims longer than 1) are multiples of 16 bytes."""
    if t.data_ptr() % 16 or any(
            n > 1 and st * t.element_size() % 16
            for n, st in zip(t.shape[:3], t.stride()[:3])):
        raise ValueError("the wgmma kernel reads q, k and v by TMA: each "
                         "needs a 16-byte aligned base and strides of "
                         "multiples of 16 bytes, not "
                         f"{t.data_ptr() % 16} and {t.stride()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D).  Returns (B, H, Sq, D).

    ``window`` <= 0 means full attention.  Inputs may be strided views as
    long as the head dim is dense (and, for the wgmma kernel, TMA's
    alignment holds); the output is a new contiguous tensor.
    """
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    route = kernel_route(q.dtype, D)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim must be dense (stride 1)")
    if route == "wgmma":
        for t in (q, k, v):
            _check_tma(t)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the flash kernel has no backward yet; it "
                                  "comes with the training slice")
    lib = _build.library("flash_attention")
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_flash_attention_fwd(
            q.device.index, _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            KVH, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], int(causal), int(window),
            float(softcap), D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd ({route}): CUDA error {rc} "
                           "at launch")
    flash_attention_fwd.launches += 1
    if route == "wgmma":
        flash_attention_fwd.wgmma_launches += 1
    return o


flash_attention_fwd.launches = 0
flash_attention_fwd.wgmma_launches = 0
