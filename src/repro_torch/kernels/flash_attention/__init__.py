"""Flash attention: ``kernel.py`` (the CUDA kernel's wrapper), ``ops.py``
((B, S, H, D) layout wrapper), ``ref.py`` (plain PyTorch version)."""
