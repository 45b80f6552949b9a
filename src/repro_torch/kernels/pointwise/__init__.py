"""The sequence forward's pointwise ops: ``kernel.py`` (the CUDA kernels'
wrappers: RMSNorm, the residual add with RMSNorm, RoPE on q and k, SwiGLU's
gate); their plain versions are ``models/layers.py``'s."""
