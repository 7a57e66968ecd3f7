"""Ops of the port; CUDA kernels live in ``csrc/`` and build on first use."""
