"""gemma3-12b: 48L d=3840 16H (kv=8) d_ff=15360 vocab=262144; 5:1
local:global sliding window (1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma3-12b", kind="dense", n_layers=48, d_model=3840, n_heads=16,
    n_kv_heads=8, d_ff=15360, vocab=262144, head_dim=256,
    window=1024, global_every=6,
)
SMOKE = ModelConfig(
    name="gemma3-12b-smoke", kind="dense", n_layers=7, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, window=16,
    global_every=3,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
