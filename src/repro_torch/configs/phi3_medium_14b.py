"""phi3-medium-14b: 40L d=5120 40H (kv=10) d_ff=17920 vocab=100352 —
RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = ModelConfig(
    name="phi3-medium-14b", kind="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352,
)
SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", kind="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
