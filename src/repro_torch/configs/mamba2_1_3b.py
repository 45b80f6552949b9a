"""mamba2-1.3b: 48L d=2048 attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    name="mamba2-1.3b", kind="ssm", n_layers=48, d_model=2048, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, head_dim=64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
)
SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", kind="ssm", n_layers=3, d_model=64, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=256, head_dim=16,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
