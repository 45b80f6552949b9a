"""internvl2-26b: 48L d=6144 48H (kv=8) d_ff=16384 vocab=92553 — InternViT
frontend is a stub; input_specs provides precomputed patch embeddings.
[arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = ModelConfig(
    name="internvl2-26b", kind="vlm", n_layers=48, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=16384, vocab=92553, n_patches=256,
)
SMOKE = ModelConfig(
    name="internvl2-26b-smoke", kind="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_patches=8,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
