"""The port's SSD kernel wrapper (plain CPU route) and Mamba2 block against
the JAX package, on the same numpy-seeded inputs.

Bars: the SSD's own, 1e-3 in f32 and 2e-2 with bf16 x (as
tests/test_kernels_pallas.py); the block's layers 1e-5 in f32.  The CUDA
kernel itself runs only on the card: tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import ssm as J
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_scan import ssd_chunk_fwd
from repro_torch.models import ssm as T

# tests/test_kernels_pallas.py SSD_CASES
SSD_CASES = [
    # b, S, nh, P, N, chunk, dtype
    (2, 128, 4, 16, 8, 32, "float32"),
    (1, 256, 2, 32, 16, 64, "float32"),
    (1, 96, 3, 8, 4, 32, "float32"),       # S % chunk == 0, odd dims
    (2, 64, 4, 16, 8, 64, "bfloat16"),
]
TOL = {"float32": 1e-3, "bfloat16": 2e-2}
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _ssd_inputs(seed, b, S, nh, P, N):
    """x, B, C, dt, A, D as in the reference's SSD test, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, nh, P)).astype(np.float32)
    B = (rng.standard_normal((b, S, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, S, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, nh)) - 1.0)) \
        .astype(np.float32)
    A = -np.exp(np.zeros(nh, np.float32))
    D = np.ones(nh, np.float32)
    return x, B, C, dt, A, D


def _pair(a, dtype="float32"):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def _err(j, t):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.detach().float().numpy()
    assert j.shape == t.shape
    return float(np.max(np.abs(j - t)))


@pytest.mark.parametrize("b,S,nh,P,N,chunk,dtype", SSD_CASES)
def test_ssd_chunk_ref_matches_pallas_interpret(b, S, nh, P, N, chunk, dtype):
    x, B, C, dt, A, _ = _ssd_inputs(0, b, S, nh, P, N)
    L = min(chunk, S)
    nc = S // L
    dtc = dt.reshape(b, nc, L, nh)
    cum = np.cumsum(dtc * A, axis=2, dtype=np.float32)
    jx, tx = _pair(x.reshape(b, nc, L, nh, P), dtype)
    args = [_pair(a) for a in (B.reshape(b, nc, L, N), C.reshape(b, nc, L, N),
                               dtc, cum)]
    jy, js = ssd_chunk_pallas(jx, *[a[0] for a in args], interpret=True)
    launches = ssd_chunk_fwd.launches
    ty, ts = ssd_chunk_fwd(tx, *[a[1] for a in args])
    assert ssd_chunk_fwd.launches == launches          # CPU: no kernel launch
    assert ty.dtype == ts.dtype == torch.float32
    assert _err(jy, ty) < TOL[dtype] and _err(js, ts) < TOL[dtype]
    # the plain version is the wrapper's CPU route, exactly
    ry, rs = ssd_chunk_ref(tx, *[a[1] for a in args])
    assert torch.equal(ry, ty) and torch.equal(rs, ts)


@pytest.mark.parametrize("b,S,nh,P,N,chunk,dtype", SSD_CASES)
def test_ops_ssd_matches_reference_ops_and_oracle(b, S, nh, P, N, chunk,
                                                  dtype):
    x, B, C, dt, A, D = _ssd_inputs(1, b, S, nh, P, N)
    jx, tx = _pair(x, dtype)
    rest = [_pair(a) for a in (B, C, dt, A, D)]
    jy, jh = jax_ops.ssd(jx, *[a[0] for a in rest], chunk=chunk)
    ry, rh = jax_ref.ssd_ref(jx, *[a[0] for a in rest])
    ty, th = ops.ssd(tx, *[a[1] for a in rest], chunk=chunk)
    assert ty.shape == (b, S, nh, P) and th.shape == (b, nh, N, P)
    for want_y, want_h in ((jy, jh), (ry, rh)):
        assert _err(want_y, ty) < TOL[dtype]
        assert _err(want_h, th) < TOL[dtype]


@pytest.mark.parametrize("h_init,intra", [(False, "float32"),
                                          (True, "float32"),
                                          (True, "bfloat16")])
def test_ssd_chunked_matches_reference(h_init, intra):
    b, S, nh, P, N = 2, 128, 4, 16, 8
    x, B, C, dt, A, D = _ssd_inputs(2, b, S, nh, P, N)
    # the reference rounds three bf16 terms of y where the port rounds
    # once: a quarter-scale x keeps |y| < 2, where a bf16 ulp is 2^-7
    x = x * 0.25
    h0 = (np.random.default_rng(3).standard_normal((b, nh, N, P)) * 0.25) \
        .astype(np.float32)
    pairs = [_pair(a) for a in (x, B, C, dt, A, D)]
    jh0, th0 = _pair(h0) if h_init else (None, None)
    jy, jh = J.ssd_chunked(*[a[0] for a in pairs], 32, h_init=jh0,
                           intra_dtype=getattr(jnp, intra))
    ty, th = T.ssd_chunked(*[a[1] for a in pairs], 32, h_init=th0,
                           intra_dtype=getattr(torch, intra))
    assert ty.dtype == getattr(torch, intra) and th.dtype == torch.float32
    assert _err(jy, ty) < TOL[intra]
    assert _err(jh, th) < 1e-3
    # one inter-chunk recurrence: the chunked scan against the port's oracle
    # on the same x (rounded to intra_dtype, as ssd_chunked rounds it)
    jx = pairs[0][0].astype(getattr(jnp, intra))
    tx = pairs[0][1].to(getattr(torch, intra))
    sy, sh = T.reference_scan(tx, *[a[1] for a in pairs[1:]], h_init=th0)
    _, jsh = J.reference_scan(jx, *[a[0] for a in pairs[1:]], h_init=jh0)
    assert _err(jsh, sh) < 1e-5
    assert float((ty.float() - sy).abs().max()) < TOL[intra]
    assert float((th - sh).abs().max()) < 1e-3


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(12) * 0.1).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state \
        else None
    jo, jst = J.causal_conv(*[jnp.asarray(a) for a in (x, w, bias)],
                            None if st is None else jnp.asarray(st))
    to, tst = T.causal_conv(*[torch.from_numpy(a) for a in (x, w, bias)],
                            None if st is None else torch.from_numpy(st))
    assert _err(jo, to) < 1e-5 and _err(jst, tst) < 1e-5


def _layer(arch, **kw):
    """One bridged Mamba2 block of the reduced config."""
    cfg = get_config(arch, reduced=True).replace(**F32, **kw)
    jcfg = jax_get_config(arch, reduced=True).replace(**F32, **kw)
    jp = J.mamba_init(jax.random.PRNGKey(5), jcfg)
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_mamba_prefill_and_decode_step(arch):
    cfg, jcfg, jp, tp = _layer(arch)
    x = (np.random.default_rng(6).standard_normal((2, 64, cfg.d_model))
         .astype(np.float32))
    jy, (jconv, jssm) = J.mamba_prefill(jp, jcfg, jnp.asarray(x))
    ty, (tconv, tssm) = T.mamba_prefill(tp, cfg, torch.from_numpy(x))
    assert _err(jy, ty) < 1e-5
    assert _err(jconv, tconv) < 1e-5 and _err(jssm, tssm) < 1e-5
    step = (np.random.default_rng(7).standard_normal((2, 1, cfg.d_model))
            .astype(np.float32))
    jd, jc2, js2 = J.mamba_decode_step(jp, jcfg, jnp.asarray(step), jconv,
                                       jssm)
    conv, ssm = tconv.clone(), tssm.clone()
    td, tc2, ts2 = T.mamba_decode_step(tp, cfg, torch.from_numpy(step), conv,
                                       ssm)
    assert tc2 is conv and ts2 is ssm                  # written in place
    assert _err(jd, td) < 1e-5
    assert _err(jc2, conv) < 1e-5 and _err(js2, ssm) < 1e-5


@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_mamba_forward_matches_reference(impl):
    cfg, jcfg, jp, tp = _layer("mamba2-370m")
    x = (np.random.default_rng(8).standard_normal((2, 32, cfg.d_model))
         .astype(np.float32))
    jy = J.mamba_forward(jp, jcfg, jnp.asarray(x), impl=impl)
    ty = T.mamba_forward(tp, cfg, torch.from_numpy(x), impl=impl)
    assert _err(jy, ty) < 1e-5
    # the kernel route against the step-by-step scan, in the port
    other = "scan" if impl == "chunked" else "chunked"
    assert float((ty - T.mamba_forward(tp, cfg, torch.from_numpy(x),
                                       impl=other)).abs().max()) < 1e-3


def test_ssd_chunked_keeps_the_reference_chunk_assertion():
    x, B, C, dt, A, D = (torch.from_numpy(a) for a in
                         _ssd_inputs(9, 1, 48, 2, 8, 4))
    with pytest.raises(AssertionError):
        T.ssd_chunked(x, B, C, dt, A, D, 32)


@pytest.mark.parametrize("bad", ["rank", "B_shape", "dt_shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 2, 8, 3, 4)
    B = C = torch.zeros(1, 2, 8, 4)
    dt = cum = torch.zeros(1, 2, 8, 3)
    if bad == "rank":
        x = x[0]
    elif bad == "B_shape":
        B = torch.zeros(1, 2, 7, 4)
    elif bad == "dt_shape":
        dt = torch.zeros(1, 2, 8, 2)
    else:   # a CUDA-less device that is not the CPU: never the plain path
        x, B, C, dt, cum = (t.to("meta") for t in (x, B, C, dt, cum))
    with pytest.raises(ValueError):
        ssd_chunk_fwd(x, B, C, dt, cum)
