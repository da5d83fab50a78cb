"""Move parameter trees between the JAX package and the port.

The JAX side hands over its tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), so this module needs no
JAX.  Keys, shapes and dtypes carry over unchanged; a leaf's ``/`` path
(``stack/layers/attn/wq``) is the name the reference's checkpoints use.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax(tree, device: DeviceLike = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on the
    device (``None`` means CUDA)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)


def to_numpy(tree):
    """The inverse of ``from_jax``: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return _to_array(tree)

