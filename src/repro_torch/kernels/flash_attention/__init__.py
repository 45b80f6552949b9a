"""Attention kernels: ``kernel.py`` (the CUDA flash kernel's wrapper),
``chunked.py`` (the CUDA two-pass kernel's wrapper), ``ops.py``
((B, S, H, D) layout wrappers), ``ref.py`` (their plain PyTorch
version)."""
