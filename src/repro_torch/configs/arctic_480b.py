"""arctic-480b: 35L d=7168 56H (kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
+ dense residual. [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, register

CONFIG = ModelConfig(
    name="arctic-480b", kind="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=4864, vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
)
SMOKE = ModelConfig(
    name="arctic-480b-smoke", kind="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, dense_residual=True),
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
