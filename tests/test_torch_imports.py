"""The port stands alone: no JAX and nothing of the JAX package, and its
entry points run on the card unless the CPU is asked for."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.bridge", "repro_torch.configs",
           "repro_torch.device", "repro_torch.kernels",
           "repro_torch.kernels.ops", "repro_torch.kernels.ssd_scan",
           "repro_torch.models", "repro_torch.models.ssm",
           "repro_torch.models.hybrid", "repro_torch.serve",
           "repro_torch.launch.serve"]


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def test_import_loads_no_jax_and_no_reference_module():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')"
              " or m.startswith(('jax.', 'repro.')))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"])
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from repro_torch.bridge import from_jax
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("qwen2-7b", reduced=True)
    toks = np.zeros((1, 4), np.int64)
    return {
        "prefill": lambda: prefill(init_params(cfg, 0, device="cpu"), cfg,
                                   {"tokens": toks}),
        "decode_step": lambda: decode_step(
            init_params(cfg, 0, device="cpu"), cfg,
            init_cache(cfg, 1, 8, device="cpu"), toks[:, :1], np.zeros(1)),
        "init_params": lambda: init_params(cfg, 0),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "ServeEngine": lambda: ServeEngine(
            cfg, init_params(cfg, 0, device="cpu")),
        "from_jax": lambda: from_jax({"w": np.zeros(2)}),
        "launch.serve": lambda: serve_cli.main(["--arch", "qwen2-7b",
                                                "--reduced"]),
    }


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "prefill",
                                   "decode_step", "ServeEngine", "from_jax",
                                   "launch.serve"])
def test_entry_point_without_gpu_raises(no_gpu, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[entry]()
