"""PyTorch + CUDA port of the ``repro`` compute half, for NVIDIA Hopper.

The JAX package under ``src/repro`` is the reference; this package
imports neither it nor ``jax``.  It serves the dense, ssm and hybrid
families (``repro_torch.models``, ``repro_torch.serve``) with hand-written
CUDA flash-attention and Mamba2 SSD chunk kernels (``repro_torch.kernels``).
"""
