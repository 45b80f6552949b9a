"""granite-4.0-h-small: IBM's Granite 4.0-H Small, 32B total with 9B active
(hf:ibm-granite/granite-4.0-h-small config.json, ``granitemoehybrid``) — 40
layers at d=4096: 36 Mamba2 layers (128 heads x 64, d_state 128 in one
group, conv 4 with bias, expand 2, chunk 256) and 4 GQA attention layers at
ids 5, 15, 25 and 35 (32 / 8 heads x 128, no positional encoding, softmax
scale ``attention_multiplier`` 1/128); every layer's FFN a MoE of 72 SwiGLU
experts of width 768, top-10 (softmax over the top-10 logits), dropless,
beside one shared SwiGLU expert of width 1536 on the same normed input.
The embedding is multiplied by 12, each branch by 0.22 before its residual
add, the tied head's logits divided by 16; RMSNorm eps 1e-5, vocab
100352."""
from repro_torch.models.config import (ModelConfig, MoEConfig, SSMConfig,
                                       register)

ATTENTION_IDS = (5, 15, 25, 35)
CONFIG = ModelConfig(
    name="granite-4.0-h-small", kind="hybrid", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=1536, vocab=100352,
    moe=MoEConfig(n_experts=72, top_k=10, d_ff_expert=768,
                  dense_residual=True, dropless=True),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256, n_groups=1, conv_bias=True),
    layer_types=tuple("attention" if i in ATTENTION_IDS else "mamba"
                      for i in range(40)),
    rope=False, softmax_scale=1 / 128, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5,
)
# one whole period of the pattern at a small size: attention at layer 2
# between Mamba2 layers, a MoE of 8 experts top-3 with its shared expert in
# every layer, one B/C group of d_state 16, the published multipliers
SMOKE = ModelConfig(
    name="granite-4.0-h-small-smoke", kind="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=48, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=3, d_ff_expert=32, dense_residual=True,
                  dropless=True),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16,
                  n_groups=1, conv_bias=True),
    layer_types=("mamba", "mamba", "attention", "mamba", "mamba"),
    rope=False, softmax_scale=1 / 16, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5,
    param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
