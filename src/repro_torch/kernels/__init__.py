"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; ``build.py`` compiles them from the sources in ``csrc/``."""
