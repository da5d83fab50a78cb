"""The port's zamba2-style hybrid stack against the JAX package on bridged
parameters (f32): group layout, ``hybrid_forward`` with and without the
decode states, and ``hybrid_decode`` writing the cache in place."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import hybrid as J
from repro.models.model import init_cache as jax_init_cache
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.models import hybrid as T
from repro_torch.models import init_cache

F32 = dict(compute_dtype="float32", param_dtype="float32")


def _setup(**kw):
    cfg = get_config("zamba2-1.2b", reduced=True).replace(**F32, **kw)
    jcfg = jax_get_config("zamba2-1.2b", reduced=True).replace(**F32, **kw)
    jp = J.hybrid_stack_init(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _rel(j, t):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert j.shape == t.shape
    return float(np.max(np.abs(j - t))) / max(float(np.max(np.abs(j))), 1e-6)


@pytest.mark.parametrize("n_layers,every", [(4, 2), (5, 2), (38, 6)])
def test_group_slices_and_sites_match_reference(n_layers, every):
    cfg = get_config("zamba2-1.2b").replace(n_layers=n_layers,
                                            shared_attn_every=every)
    jcfg = jax_get_config("zamba2-1.2b").replace(n_layers=n_layers,
                                                 shared_attn_every=every)
    assert T.group_slices(cfg) == J.group_slices(jcfg)
    assert T.n_shared_sites(cfg) == J.n_shared_sites(jcfg)


@pytest.mark.parametrize("collect_state", [False, True])
def test_hybrid_forward_matches_reference(collect_state):
    cfg, jcfg, jp, tp = _setup()
    x = (np.random.default_rng(1).standard_normal((2, 32, cfg.d_model))
         .astype(np.float32))
    jh, jaux, jcache = J.hybrid_forward(jp, jcfg, jnp.asarray(x),
                                        collect_state=collect_state)
    th, aux, cache = T.hybrid_forward(tp, cfg, torch.from_numpy(x),
                                      collect_state=collect_state)
    assert aux == {} == jaux
    assert _rel(jh, th) < 1e-4
    if not collect_state:
        assert cache is None is jcache
        return
    assert sorted(cache) == sorted(jcache)
    for key in jcache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        assert _rel(jcache[key], cache[key]) < 1e-4, key


def test_hybrid_decode_matches_reference_and_writes_in_place():
    cfg, jcfg, jp, tp = _setup()
    B, max_len = 2, 12
    rng = np.random.default_rng(2)
    pos = np.array([3, 7], np.int32)
    jcache = jax_init_cache(jcfg, B, max_len)
    # a populated cache: random states and keys/values, the same on both
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                             * 0.5) for k, v in jcache.items()}
    cache = init_cache(cfg, B, max_len, device="cpu")
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        cache[k].copy_(torch.from_numpy(np.array(jcache[k])))
    held = dict(cache)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jh, jnew, _ = J.hybrid_decode(jp, jcfg, jnp.asarray(x), jcache,
                                  jnp.asarray(pos))
    th, new, aux = T.hybrid_decode(tp, cfg, torch.from_numpy(x), cache,
                                   torch.from_numpy(pos).long())
    assert aux == {}
    assert _rel(jh, th) < 1e-4
    for k in jnew:
        assert new[k] is held[k], k                    # updated in place
        assert _rel(jnew[k], new[k]) < 1e-4, k
