"""PyTorch/CUDA port of the ``repro`` serving and training paths.

Module names follow ``repro`` so each counterpart is easy to find. The
port imports ``torch`` and numpy only. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; prefill attention runs in a
hand-written CUDA kernel (``kernels/flash_attention``), which training
differentiates through ``kernels/autograd.py``.
"""
