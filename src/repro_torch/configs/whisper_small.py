"""whisper-small: enc-dec 12L d=768 12H d_ff=3072 vocab=51865; conv audio
frontend is a stub — input_specs provides precomputed frame embeddings
(B, 1500, d). [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-small", kind="audio", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=51865, head_dim=64,
    n_enc_layers=12, enc_len=1500,
)
SMOKE = ModelConfig(
    name="whisper-small-smoke", kind="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
    n_enc_layers=2, enc_len=30,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
