"""The flash-attention wrapper's plain (CPU) version against the Pallas
kernel in interpret mode, on the JAX kernel tests' cases and bars, and the
wrapper's choice of kernel and its checks.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (_check_tma,
                                                 flash_attention_fwd,
                                                 kernel_route)

# tests/test_kernels_pallas.py FLASH_CASES
FLASH_CASES = [
    # B, Sq, Sk, H, KVH, D, causal, window, softcap, dtype
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 64, 64, 4, 4, 32, True, 0, 0.0, "float32"),
    (1, 100, 144, 4, 4, 64, True, 32, 0.0, "bfloat16"),   # ragged + window
    (2, 64, 256, 8, 2, 128, False, 0, 0.0, "float32"),    # cross attn
    (1, 128, 128, 2, 1, 64, True, 0, 30.0, "float32"),    # softcap
    (1, 32, 32, 4, 2, 64, True, 8, 0.0, "bfloat16"),      # tiny blocks
    # the wgmma kernel's edges: qwen2-7b's grouping G = 7 at D = 128 with
    # Sq = Sk not a multiple of its 128-row tiles; zamba2-1.2b's MHA at
    # D = 64 with window and softcap
    (1, 200, 200, 7, 1, 128, True, 0, 0.0, "bfloat16"),
    (1, 160, 160, 4, 4, 64, True, 48, 30.0, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _max_err(j, t):
    return float(np.max(np.abs(np.asarray(j.astype(jnp.float32))
                                - t.float().numpy())))


@pytest.mark.parametrize(
    "B,Sq,Sk,H,KVH,D,causal,window,softcap,dtype", FLASH_CASES)
def test_plain_flash_matches_pallas_interpret(B, Sq, Sk, H, KVH, D, causal,
                                              window, softcap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D)], dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  softcap=softcap, block_q=64, block_k=64,
                                  interpret=True)
    launches = flash_attention_fwd.launches
    got = flash_attention_fwd(tq, tk, tv, causal=causal, window=window,
                              softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, D)
    assert flash_attention_fwd.launches == launches   # CPU: no kernel launch
    err = _max_err(want, got)
    assert err < TOL[dtype], f"err={err}"


def test_model_layout_wrapper_matches_reference_ops():
    """ops.flash_attention takes (B, S, H, D) as the reference's does."""
    B, S, H, KVH, D = 2, 40, 4, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, [(B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)], "float32")
    want = jax_ops.flash_attention(jq, jk, jv, causal=True, window=12)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=12)
    assert got.shape == (B, S, H, D)
    assert _max_err(want, got) < 2e-5


@pytest.mark.parametrize("bad", ["shape", "heads", "window", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = v = torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "shape":
        k = torch.zeros(1, 2, 8, 32)
    elif bad == "heads":
        k = v = torch.zeros(1, 3, 8, 16)
    elif bad == "window":
        kw = {"window": -1}
    else:   # a CUDA-less device that is not the CPU: never the plain path
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, **kw)


@pytest.mark.parametrize("dtype,D,route", [
    *[(torch.float32, D, "simt") for D in (8, 16, 32, 64, 128)],
    *[(torch.bfloat16, D, "simt") for D in (8, 16, 32)],
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
])
def test_kernel_route_by_dtype_and_head_dim(dtype, D, route):
    """bf16 at the serving head dims takes the tensor cores; float32 (whose
    bar a bf16 or TF32 product cannot meet) and small head dims do not."""
    assert kernel_route(dtype, D) == route


@pytest.mark.parametrize("dtype,D,error", [
    (torch.bfloat16, 96, ValueError),
    (torch.float32, 256, ValueError),
    (torch.float16, 64, TypeError),
])
def test_kernel_route_refuses_what_no_kernel_takes(dtype, D, error):
    with pytest.raises(error):
        kernel_route(dtype, D)


@pytest.mark.parametrize("layout", ["model", "misaligned_base",
                                    "misaligned_stride"])
def test_tma_check_takes_aligned_views_only(layout):
    """The wgmma kernel reads q, k and v by TMA: 16-byte aligned base,
    strides of dims longer than 1 in multiples of 16 bytes."""
    if layout == "model":       # (B, S, H, D) -> (B, H, S, D) view
        _check_tma(torch.zeros(2, 40, 4, 64, dtype=torch.bfloat16)
                   .transpose(1, 2))
        return
    if layout == "misaligned_base":
        t = torch.zeros(4 * 16 * 64 + 1, dtype=torch.bfloat16)[1:]
        t = t.view(1, 4, 16, 64)
    else:                       # a row of 68 elements is 136 bytes
        t = torch.zeros(1, 16, 4, 68, dtype=torch.bfloat16)[..., :64]
        t = t.transpose(1, 2)
    with pytest.raises(ValueError):
        _check_tma(t)
