"""The port's copied configs equal the JAX package's, field for field."""
import dataclasses

import pytest

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro_torch.configs import base as torch_base
from repro_torch.configs import get_config, list_archs


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen1.5-4b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_config_copy_matches_reference(arch, reduced):
    mine = get_config(arch, reduced=reduced)
    ref = jax_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize("name", ["ModelConfig", "MoEConfig", "SSMConfig"])
def test_dataclass_fields_match_reference(name):
    def fields(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else f.default_factory()
                 if f.default_factory is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]
    mine, ref = getattr(torch_base, name), getattr(jax_base, name)
    assert [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d)
            for n, d in fields(mine)] == \
        [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d)
         for n, d in fields(ref)]


def test_registry_holds_the_ported_archs():
    assert list_archs() == ["mamba2-370m", "qwen1.5-4b", "qwen2-7b",
                            "zamba2-1.2b"]
    with pytest.raises(KeyError):
        get_config("gemma3-4b")
