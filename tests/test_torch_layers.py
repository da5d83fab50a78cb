"""Each ported layers.py function against its JAX counterpart, in f32,
on the same numpy-seeded inputs (bar 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as J
from repro_torch.configs import get_config
from repro_torch.models import layers as T

TOL = 1e-5


def _cfgs(arch="qwen2-7b", **kw):
    kw = dict(compute_dtype="float32", param_dtype="float32", **kw)
    return (get_config(arch, reduced=True).replace(**kw),
            jax_get_config(arch, reduced=True).replace(**kw))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert j.shape == t.shape
    err = float(np.max(np.abs(j - t)))
    assert err < tol, f"max abs err {err}"


def _tree(rng, shapes):
    arrays = {k: _rand(rng, *s, scale=0.2) for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


def test_dtype_of():
    for name in ("float32", "bfloat16", "float16"):
        assert T.dtype_of(name) == getattr(torch, name)
        assert J.dtype_of(name) == getattr(jnp, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64, scale=0.1)
    j = J.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w), 1e-5)
    t = T.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(w), 1e-5)
    assert t.dtype == getattr(torch, dtype)
    # same op order: in bf16 the two agree to the last bit but for one
    # rounding of the f32 statistics (bf16 ulp at |x| < 4 is 2^-6)
    _close(j.astype(jnp.float32), t, TOL if dtype == "float32" else 2 ** -6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_table_and_apply_rope(theta):
    rng = np.random.default_rng(1)
    pos = np.arange(12, dtype=np.int32)
    jc, js = J.rope_table(jnp.asarray(pos), 16, theta)
    tc, ts = T.rope_table(torch.from_numpy(pos), 16, theta)
    _close(jc, tc)
    _close(js, ts)
    x = _rand(rng, 2, 12, 3, 16)
    _close(J.apply_rope(jnp.asarray(x), jc, js),
           T.apply_rope(torch.from_numpy(x), tc, ts))
    # per-sequence decode tables: positions (B, 1)
    bpos = np.array([[3], [7]], np.int32)
    jc, js = J.rope_table(jnp.asarray(bpos), 16, theta)
    tc, ts = T.rope_table(torch.from_numpy(bpos), 16, theta)
    x = _rand(rng, 2, 1, 3, 16)
    _close(J.apply_rope(jnp.asarray(x), jc, js),
           T.apply_rope(torch.from_numpy(x), tc, ts))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_and_out(qk_norm):
    tcfg, jcfg = _cfgs(qk_norm=qk_norm)
    d, h, kvh, hd = 64, 8, 2, 8
    shapes = {"wq": (d, h, hd), "wk": (d, kvh, hd), "wv": (d, kvh, hd),
              "wo": (h, hd, d), "bq": (h, hd), "bk": (kvh, hd),
              "bv": (kvh, hd)}
    if qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    rng = np.random.default_rng(2)
    jp, tp = _tree(rng, shapes)
    x = _rand(rng, 2, 6, d)
    jq, jk, jv = J.project_qkv(jp, jcfg, jnp.asarray(x))
    tq, tk, tv = T.project_qkv(tp, tcfg, torch.from_numpy(x))
    for a, b in ((jq, tq), (jk, tk), (jv, tv)):
        _close(a, b)
    o = _rand(rng, 2, 6, h, hd)
    _close(J.project_out(jp, jcfg, jnp.asarray(o)),
           T.project_out(tp, tcfg, torch.from_numpy(o)))


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (5, 0.0), (None, 20.0)])
def test_naive_attention_per_sequence_decode(window, softcap):
    """The decode form: Sq == 1, per-sequence q_offset and k_valid."""
    rng = np.random.default_rng(3)
    B, Sk, H, KVH, D = 3, 16, 4, 2, 8
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, Sk, KVH, D), \
        _rand(rng, B, Sk, KVH, D)
    pos = np.array([2, 9, 15], np.int32)
    j = J.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, window=window, softcap=softcap,
                          q_offset=jnp.asarray(pos),
                          k_valid=jnp.asarray(pos + 1))
    t = T.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=False, window=window,
                          softcap=softcap, q_offset=torch.from_numpy(pos),
                          k_valid=torch.from_numpy(pos + 1))
    _close(j, t)


def test_naive_attention_full_sequence_with_offset():
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 10, 4, 8), _rand(rng, 2, 14, 2, 8), \
        _rand(rng, 2, 14, 2, 8)
    j = J.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=6, q_offset=4)
    t = T.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=6,
                          q_offset=4)
    _close(j, t)


@pytest.mark.parametrize("impl", ["blocked", "pallas", "naive"])
def test_attention_dispatcher(impl):
    """Prefill shapes go to the flash wrapper ("blocked", "pallas") or the
    naive path; on CPU tensors the wrapper runs its plain version."""
    tcfg, jcfg = _cfgs(attention_impl=impl)
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 2, 24, 8, 8), _rand(rng, 2, 24, 2, 8), \
        _rand(rng, 2, 24, 2, 8)
    j = J.attention(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True)
    t = T.attention(tcfg, torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True)
    _close(j, t)


@pytest.mark.parametrize("impl,window,softcap", [("blocked", 7, 0.0),
                                                 ("blocked", None, 20.0),
                                                 ("pallas", 5, 30.0)])
def test_attention_dispatcher_window_softcap(impl, window, softcap):
    """Sliding-window and softcapped prefill through the flash wrapper's
    plain version, against the reference's blocked and Pallas routes."""
    tcfg, jcfg = _cfgs(attention_impl=impl)
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 2, 20, 4, 16), _rand(rng, 2, 20, 2, 16), \
        _rand(rng, 2, 20, 2, 16)
    j = J.attention(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, window=window, softcap=softcap)
    t = T.attention(tcfg, torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True, window=window,
                    softcap=softcap)
    _close(j, t)


def test_attention_dispatcher_rejects_unknown_impl():
    tcfg, _ = _cfgs(attention_impl="ring")
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError):
        T.attention(tcfg, x, x[:, :, :2], x[:, :, :2], causal=True)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_mlp_apply(act, gated):
    tcfg, jcfg = _cfgs(act=act, mlp_gated=gated)
    shapes = {"w1": (64, 160), "w2": (160, 64)}
    if gated:
        shapes["w3"] = (64, 160)
    rng = np.random.default_rng(7)
    jp, tp = _tree(rng, shapes)
    x = _rand(rng, 2, 5, 64)
    _close(J.mlp_apply(jp, jcfg, jnp.asarray(x)),
           T.mlp_apply(tp, tcfg, torch.from_numpy(x)))


@pytest.mark.parametrize("tie,qk_norm", [(False, False), (True, True)])
def test_embed_and_unembed(tie, qk_norm):
    tcfg, jcfg = _cfgs(tie_embeddings=tie, qk_norm=qk_norm)
    shapes = {"embed": (256, 64)}
    if not tie:
        shapes["unembed"] = (64, 256)
    rng = np.random.default_rng(8)
    jp, tp = _tree(rng, shapes)
    toks = rng.integers(0, 256, (2, 7)).astype(np.int32)
    _close(J.embed_tokens(jp, jcfg, jnp.asarray(toks)),
           T.embed_tokens(tp, tcfg, torch.from_numpy(toks).long()))
    _close(J.unembed_matrix(jp, jcfg), T.unembed_matrix(tp, tcfg))
