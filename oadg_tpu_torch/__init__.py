"""PyTorch / CUDA port of ``oadg_tpu`` for NVIDIA Hopper (H100).

The JAX package ``oadg_tpu`` is the reference; this package mirrors its tree
and module names. It imports ``torch`` and numpy, never JAX or ``oadg_tpu``.
Importing it loads nothing else: submodules are imported where used.
"""
