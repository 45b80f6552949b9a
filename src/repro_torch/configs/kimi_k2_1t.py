"""kimi-k2-1t-a32b: 61L d=7168 64H (kv=8) expert d_ff=2048 vocab=163840,
MoE 384e top-8 — trillion-param MoE. [arXiv:2501.kimi2; unverified]"""
from repro_torch.models.config import ModelConfig, MoEConfig, register

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", kind="moe", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
)
SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke", kind="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=64, vocab=256,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=64),
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
