"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``).  The library's name
carries a hash of its source, so an edited kernel is rebuilt and a
built one is reused.  Nothing here runs at import: the CPU tests import
every module, and a CPU machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# argument types of each library's C entry points
_SIGNATURES = {
    "flash_attention": {
        "repro_flash_attention_fwd": (
            [_I, _I, _I, _P, _P, _P, _P] + [_I] * 6 + [_L] * 12
            + [_I, _I, _F, _F, _P]),
    },
    "ssd_chunk": {
        "repro_ssd_chunk_fwd": ([_I, _I] + [_P] * 7 + [_I] * 6 + [_L] * 21
                                + [_P]),
    },
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless a library of the same source is
    built.  Returns (library path, seconds spent compiling)."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)    # atomic: concurrent builders each publish whole
    return lib, seconds


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded, typed library of ``csrc/<name>.cu`` (built if needed)."""
    path, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
