"""PyTorch + CUDA port of the ``repro`` compute half, for NVIDIA Hopper.

The JAX package under ``src/repro`` is the reference; this package
imports neither it nor ``jax``.  Slice 1 serves the dense family
(``repro_torch.models``, ``repro_torch.serve``) with a hand-written CUDA
flash-attention kernel (``repro_torch.kernels``).
"""
