"""Mamba2 SSD chunked scan: ``kernel.py`` (``ssd_cuda``, the CUDA
kernel's wrapper), ``ops.py`` (``ssd``, the public entry from zero state)
and ``ref.py`` (plain PyTorch version, the naive sequential recurrence)."""
