"""stablelm-3b: 32L d=2560 32H (kv=32, MHA) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = ModelConfig(
    name="stablelm-3b", kind="dense", n_layers=32, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=6912, vocab=50304,
)
SMOKE = ModelConfig(
    name="stablelm-3b-smoke", kind="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
