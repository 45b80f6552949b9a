"""gemma3-1b: 26L d=1152 4H (kv=1) d_ff=6912 vocab=262144; 5:1 local:global
sliding window (1024). [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma3-1b", kind="dense", n_layers=26, d_model=1152, n_heads=4,
    n_kv_heads=1, d_ff=6912, vocab=262144, head_dim=256,
    window=1024, global_every=6,
)
SMOKE = ModelConfig(
    name="gemma3-1b-smoke", kind="dense", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=256, head_dim=16, window=16,
    global_every=3,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
