"""zamba2-7b: the JAX package's zamba2 variant, not Zyphra's block — 81L
hybrid, Mamba2 blocks (ssm_state=64, one B/C group, no conv bias) with one
shared attention + SwiGLU block (32H over the 3584-wide stream, head dim
112, with its residual) applied every 6 layers; d_ff=14336 vocab=32000.
The published model is ``zamba2-7b-instruct``
(``configs/zamba2_7b_instruct.py``). [arXiv:2411.15242; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    name="zamba2-7b", kind="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    shared_attn_every=6,
)
SMOKE = ModelConfig(
    name="zamba2-7b-smoke", kind="hybrid", n_layers=7, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    shared_attn_every=3,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
