"""Mamba2 SSD chunked scan: ``kernel.py`` (``ssd_cuda``, the CUDA
kernel's wrapper and the public entry) and ``ref.py`` (plain PyTorch
version, the naive sequential recurrence)."""
