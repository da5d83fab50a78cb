"""The port's dense, ssm and hybrid models against the JAX package on
bridged parameters: hidden states, prefill logits and caches, decode
logits (f32, relative error < 1e-4), and prefill + decode against forward
(< 2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.transformer import is_global_flags as jax_is_global_flags
from repro.train.checkpoint import _tree_paths
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    param_count,
    prefill,
)
from repro_torch.models.layers import unembed_matrix
from repro_torch.models.transformer import is_global_flags

ARCHS = ["qwen2-7b", "qwen1.5-4b", "mamba2-370m", "zamba2-1.2b"]
F32 = dict(compute_dtype="float32", param_dtype="float32")


def tree_paths(tree, prefix=""):
    """Flat {"a/b/c": leaf} view of nested dicts (checkpoint key names)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(tree_paths(v, name) if isinstance(v, dict) else {name: v})
    return out


def _rel(j, t):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert j.shape == t.shape
    return float(np.max(np.abs(j - t))) / max(float(np.max(np.abs(j))), 1e-6)


def _setup(arch, **kw):
    cfg = get_config(arch, reduced=True).replace(**kw)
    jcfg = jax_get_config(arch, reduced=True).replace(**kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    cfg, jcfg, jparams, params = _setup(arch, **F32)
    toks = _tokens(cfg, 2, 16)
    jh, jaux, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    h, aux, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                        device="cpu")
    assert h.shape == (2, 16, cfg.d_model) and h.dtype == torch.float32
    # dense: the moe loss keys, as zeros; ssm and hybrid: none
    assert set(aux) == set(jaux)
    assert _rel(jh, h) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, jcfg, jparams, params = _setup(arch, **F32)
    toks = _tokens(cfg, 2, 17)
    jcache, jlogits, jpos = jax_prefill(jparams, jcfg,
                                        {"tokens": jnp.asarray(toks[:, :16])},
                                        pad_to=24)
    cache, logits, pos = prefill(params, cfg,
                                 {"tokens": torch.from_numpy(toks[:, :16])},
                                 pad_to=24, device="cpu")
    assert logits.dtype == torch.float32
    assert _rel(jlogits, logits) < 1e-4
    assert sorted(cache) == sorted(jcache)
    for key in jcache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        assert _rel(jcache[key], cache[key]) < 1e-4, key
    assert pos.tolist() == np.asarray(jpos).tolist()
    jd, jcache2 = jax_decode_step(jparams, jcfg, jcache,
                                  jnp.asarray(toks[:, 16:]), jpos)
    held = dict(cache)
    d, cache2 = decode_step(params, cfg, cache, torch.from_numpy(toks[:, 16:]),
                            pos, device="cpu")
    assert _rel(jd, d) < 1e-4
    for key in jcache2:
        assert cache2[key] is held[key], key        # updated in place
        assert _rel(jcache2[key], cache2[key]) < 1e-4, key


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_bf16_compute_near_reference(arch):
    """Default bf16 compute: both frameworks round at the same points but
    sum in another order; bar 5e-2 relative on the logits."""
    cfg, jcfg, jparams, params = _setup(arch)
    toks = _tokens(cfg, 2, 16)
    _, jlogits, _ = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    _, logits, _ = prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                           device="cpu")
    assert _rel(jlogits, logits) < 5e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """prefill(S) + decode(token S) equals forward at position S (the
    reference's test_prefill_decode_matches_forward, on the port)."""
    cfg = get_config(arch, reduced=True).replace(**F32)
    params = init_params(cfg, 0, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S + 1))
    with torch.inference_mode():
        cache, _, pos = prefill(params, cfg, {"tokens": toks[:, :S]},
                                pad_to=S + 8, device="cpu")
        logits, cache = decode_step(params, cfg, cache, toks[:, S:S + 1], pos,
                                    device="cpu")
        h, _, _ = forward(params, cfg, {"tokens": toks}, device="cpu")
        ref = h[:, -1, :] @ unembed_matrix(params["embedding"], cfg)
    rel = float((logits - ref).abs().max()) / max(float(ref.abs().max()), 1e-6)
    assert rel < 2e-3, f"{arch}: rel={rel}"


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_step_decode_from_zero_cache(arch):
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, 0, device="cpu")
    cache = init_cache(cfg, 2, 32, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.long)
    pos = torch.zeros((2,), dtype=torch.long)
    for _ in range(3):
        logits, cache = decode_step(params, cfg, cache, tok, pos,
                                    device="cpu")
        assert logits.shape == (2, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        tok, pos = logits.argmax(-1)[:, None], pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    cfg = get_config(arch, reduced=True)
    jcfg = jax_get_config(arch, reduced=True)
    ref = {name: leaf for name, leaf in
           _tree_paths(jax.eval_shape(lambda: jax_init_params(
               jcfg, jax.random.PRNGKey(0))))}
    mine = tree_paths(init_params(cfg, 0, device="cpu"))
    assert sorted(mine) == sorted(ref)
    for name, leaf in mine.items():
        assert tuple(leaf.shape) == ref[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(ref[name].dtype)
    assert param_count(init_params(cfg, 0, device="cpu")) == sum(
        int(np.prod(x.shape)) for x in ref.values())


def test_bridge_round_trip_keeps_keys_shapes_and_dtypes():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)}
    tree = jax.tree.map(np.asarray, tree)
    back = to_numpy(from_jax(tree, device="cpu"))
    assert tree_paths(back).keys() == {"a/w", "b"}
    for name, leaf in tree_paths(tree).items():
        got = tree_paths(back)[name]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert np.array_equal(got.astype(np.float32), leaf.astype(np.float32))


def test_is_global_flags_matches_reference():
    for ratio in (0, 5):
        cfg = get_config("qwen2-7b").replace(local_global_ratio=ratio)
        jcfg = jax_get_config("qwen2-7b").replace(local_global_ratio=ratio)
        assert is_global_flags(cfg, 12).tolist() == np.asarray(
            jax_is_global_flags(jcfg, 12)).tolist()
