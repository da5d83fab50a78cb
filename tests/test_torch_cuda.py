"""Card-only tests of the port: the CUDA flash-attention kernels (the
float32 SIMT kernel and the bf16 wgmma kernel) and the SSD chunk kernel
against their plain versions, their refusals, and the reduced models'
launch counts.  They skip where no CUDA GPU is present.  This file imports no JAX, so on a machine
without it run it without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

CASES = [
    # B, Sq, Sk, H, KVH, D, causal, window, softcap, dtype
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 64, 64, 4, 4, 32, True, 0, 0.0, "float32"),
    (1, 100, 144, 4, 4, 64, True, 32, 0.0, "bfloat16"),
    (2, 64, 256, 8, 2, 128, False, 0, 0.0, "float32"),
    (1, 128, 128, 2, 1, 64, True, 0, 30.0, "float32"),
    (1, 32, 32, 4, 2, 64, True, 8, 0.0, "bfloat16"),
    (2, 48, 48, 8, 2, 8, True, 0, 0.0, "float32"),
    (2, 48, 48, 4, 4, 16, True, 0, 0.0, "float32"),
    (1, 300, 40, 4, 2, 64, True, 16, 0.0, "float32"),   # rows with no key
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _qkv(case, device, seed=0):
    B, Sq, Sk, H, KVH, D, *_, dtype = case
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(*s, device=device, generator=gen).to(dt)
            for s in ((B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D))]


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(cuda, case):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_ref
    causal, window, softcap, dtype = case[6:]
    q, k, v = _qkv(case, cuda)
    before = flash_attention_fwd.launches
    out = flash_attention_fwd(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


# bf16 at head dims 64 and 128: the wgmma kernel's cases, with ragged,
# windowed, softcapped, grouped and no-valid-key rows
WGMMA_CASES = [
    # B, Sq, Sk, H, KVH, D, causal, window, softcap
    (1, 100, 144, 4, 4, 64, True, 32, 0.0),     # ragged + window
    (1, 32, 32, 4, 2, 64, True, 8, 0.0),
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (2, 64, 256, 8, 2, 128, False, 0, 0.0),     # cross attention
    (1, 128, 128, 2, 1, 64, True, 0, 30.0),     # softcap
    (1, 300, 40, 4, 2, 64, True, 16, 0.0),      # rows with no valid key
    (1, 300, 40, 4, 2, 128, True, 16, 0.0),
    (1, 200, 200, 28, 4, 128, True, 0, 0.0),    # G = 7, Sq not a tile multiple
    (2, 333, 517, 8, 8, 128, False, 100, 20.0),
    (2, 333, 517, 8, 8, 64, True, 100, 0.0),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_kernel_matches_plain_version_on_model_layout(cuda, case):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     kernel_route)
    from repro_torch.kernels.ref import attention_ref
    B, Sq, Sk, H, KVH, D, causal, window, softcap = case
    assert kernel_route(torch.bfloat16, D) == "wgmma"
    gen = torch.Generator(device=cuda).manual_seed(2)
    # views of (B, S, heads, D) tensors, as the model passes them
    q, k, v = (torch.randn(B, S, n, D, device=cuda, generator=gen)
               .bfloat16().transpose(1, 2)
               for S, n in ((Sq, H), (Sk, KVH), (Sk, KVH)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (flash_attention_fwd.launches, flash_attention_fwd.wgmma_launches)
    out = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_fwd.wgmma_launches) \
        == (before[0] + 1, before[1] + 1)
    want = attention_ref(q, k, v, **kw)
    assert float((out.float() - want.float()).abs().max()) < TOL["bfloat16"]


def test_kernel_reads_strided_model_layout(cuda):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 70, 8, 64, device=cuda, generator=gen)
    k = torch.randn(2, 70, 2, 64, device=cuda, generator=gen)
    v = torch.randn(2, 70, 2, 64, device=cuda, generator=gen)
    got = ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    assert float((got - want).abs().max()) < 2e-5


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "dense_head_dim",
                                 "requires_grad", "misaligned_bf16",
                                 "bf16_stride"])
def test_kernel_raises_instead_of_falling_back(cuda, bad):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q = torch.zeros(1, 4, 16, 64, device=cuda)
    k = v = torch.zeros(1, 2, 16, 64, device=cuda)
    if bad == "head_dim":
        q, k, v = q[..., :24].contiguous(), k[..., :24].contiguous(), \
            v[..., :24].contiguous()
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "dense_head_dim":
        q = torch.zeros(1, 4, 16, 128, device=cuda)[..., ::2]
    elif bad == "misaligned_bf16":     # TMA needs a 16-byte aligned base
        q = torch.zeros(4 * 16 * 64 + 1, device=cuda,
                        dtype=torch.bfloat16)[1:].view(1, 4, 16, 64)
        k, v = k.bfloat16(), v.bfloat16()
    elif bad == "bf16_stride":         # and strides of 16-byte multiples
        q = torch.zeros(1, 16, 4, 68, device=cuda,
                        dtype=torch.bfloat16)[..., :64].transpose(1, 2)
        k, v = k.bfloat16(), v.bfloat16()
    else:       # no backward kernel yet
        q = q.requires_grad_()
    launches = flash_attention_fwd.launches
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == launches


# arch, prompt length, flash launches and SSD launches per reduced prefill
PREFILL_LAUNCHES = [
    ("qwen2-7b", 40, 3, 0),
    ("qwen1.5-4b", 40, 3, 0),
    ("mamba2-370m", 64, 0, 4),     # one SSD launch per Mamba2 layer
    ("zamba2-1.2b", 64, 2, 4),     # and one flash launch per shared site
]


@pytest.mark.parametrize("arch,S,n_flash,n_ssd", PREFILL_LAUNCHES,
                         ids=[c[0] for c in PREFILL_LAUNCHES])
def test_reduced_prefill_launches_once_per_layer_and_matches_cpu(
        cuda, arch, S, n_flash, n_ssd):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_fwd
    from repro_torch.models import init_params, prefill
    cfg = get_config(arch, reduced=True).replace(compute_dtype="float32")
    p_cpu = init_params(cfg, 0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(0))
    flash, ssd = flash_attention_fwd.launches, ssd_chunk_fwd.launches
    with torch.inference_mode():
        _, logits, _ = prefill(to(p_cpu, cuda), cfg, {"tokens": toks})
        assert flash_attention_fwd.launches == flash + n_flash
        assert ssd_chunk_fwd.launches == ssd + n_ssd
        _, want, _ = prefill(p_cpu, cfg, {"tokens": toks}, device="cpu")
    rel = float((logits.cpu() - want).abs().max()) / float(want.abs().max())
    assert rel < 1e-4


# tests/test_kernels_pallas.py SSD_CASES, the reduced configs' shape and
# the two full-width prefill shapes (b, S, nh, P, N, chunk, x dtype)
SSD_CASES = [
    (2, 128, 4, 16, 8, 32, "float32"),
    (1, 256, 2, 32, 16, 64, "float32"),
    (1, 96, 3, 8, 4, 32, "float32"),
    (2, 64, 4, 16, 8, 64, "bfloat16"),
    (2, 16, 8, 16, 16, 32, "float32"),           # reduced, S < chunk
    (1, 512, 32, 64, 128, 256, "bfloat16"),      # mamba2-370m
    (1, 512, 64, 64, 64, 256, "bfloat16"),       # zamba2-1.2b
]
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _ssd_model_layout(case, device, seed=0):
    """x, B and C as the model hands them over: strided views into one
    (b, S, nh*P + 2N) conv output (x in its dtype, B and C in f32)."""
    b, S, nh, P, N, chunk, dtype = case
    L = min(chunk, S)
    nc = S // L
    gen = torch.Generator(device=device).manual_seed(seed)
    xbc = torch.randn(b, S, nh * P + 2 * N, device=device, generator=gen)
    xbc[..., nh * P:] *= 0.5
    x = xbc.to(getattr(torch, dtype))[..., :nh * P]
    B, C = xbc[..., nh * P:nh * P + N], xbc[..., nh * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, nh, device=device, generator=gen) - 1.0)
    dtc = dt.reshape(b, nc, L, nh)
    cum = torch.cumsum(-dtc, dim=2)
    return (x.reshape(b, nc, L, nh, P), B.reshape(b, nc, L, N),
            C.reshape(b, nc, L, N), dtc, cum)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_version_on_model_layout(cuda, case):
    from repro_torch.kernels.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_fwd
    x, B, C, dt, cum = _ssd_model_layout(case, cuda)
    assert not x.is_contiguous() and not B.is_contiguous()
    before = ssd_chunk_fwd.launches
    y, states = ssd_chunk_fwd(x, B, C, dt, cum)
    torch.cuda.synchronize()
    assert ssd_chunk_fwd.launches == before + 1
    want_y, want_states = ssd_chunk_ref(x, B, C, dt, cum)
    assert float((y - want_y).abs().max()) < SSD_TOL[case[-1]]
    assert float((states - want_states).abs().max()) < SSD_TOL[case[-1]]


@pytest.mark.parametrize("bad", ["chunk", "head_dim", "state_dim", "dtype",
                                 "B_dtype", "requires_grad"])
def test_ssd_kernel_raises_instead_of_falling_back(cuda, bad):
    from repro_torch.kernels.ssd_scan import ssd_chunk_fwd
    b, nc, L, nh, P, N = 1, 2, 32, 2, 16, 8
    if bad == "chunk":
        L = 512
    elif bad == "head_dim":
        P = 128
    elif bad == "state_dim":
        N = 6
    x = torch.zeros(b, nc, L, nh, P, device=cuda)
    B = C = torch.zeros(b, nc, L, N, device=cuda)
    dt = cum = torch.zeros(b, nc, L, nh, device=cuda)
    if bad == "dtype":
        x = x.half()
    elif bad == "B_dtype":
        B = B.double()
    elif bad == "requires_grad":
        x = x.requires_grad_()
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        ssd_chunk_fwd(x, B, C, dt, cum)
