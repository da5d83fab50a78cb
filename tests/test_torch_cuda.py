"""Card-only tests of the port: the CUDA flash kernel against its plain
version, its refusals, and the reduced models' launch counts.  They skip
where no CUDA GPU is present.  This file imports no JAX, so on a machine
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
                                 "requires_grad"])
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
    else:       # no backward kernel yet
        q = q.requires_grad_()
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen1.5-4b"])
def test_reduced_prefill_launches_once_per_layer_and_matches_cpu(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import init_params, prefill
    cfg = get_config(arch, reduced=True).replace(compute_dtype="float32")
    p_cpu = init_params(cfg, 0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(0))
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        _, logits, _ = prefill(to(p_cpu, cuda), cfg, {"tokens": toks})
        assert flash_attention_fwd.launches == before + cfg.n_layers
        _, want, _ = prefill(p_cpu, cfg, {"tokens": toks}, device="cpu")
    rel = float((logits.cpu() - want).abs().max()) / float(want.abs().max())
    assert rel < 1e-4
