"""zamba2-7b-instruct: Zyphra's published hybrid (hf:Zyphra/Zamba2-7B-Instruct
config.json; arXiv:2411.15242) — 81 Mamba2 layers (d=3584, 112 heads x 64,
d_state 64 in 2 groups, conv 4 with bias, chunk 256) and two shared blocks
applied before the 13 layers of ``hybrid_layer_ids``, alternately: attention
over concat(x, token embedding) (7168 wide, 32 heads x 224, RoPE theta
10000, softmax scale (224 / 2)^-1/2), a GeGLU MLP (d_ff 14336) with a
rank-128 adapter and a 3584 x 3584 linear per application; RMSNorm eps
1e-5, vocab 32000, tied head."""
from repro_torch.models.config import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    name="zamba2-7b-instruct", kind="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=224, d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=256,
                  n_groups=2, conv_bias=True),
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_mem_blocks=2, attn_in=7168, adapter_rank=128, norm_eps=1e-5,
)
# every kind of part at a small size: two blocks, three unevenly spaced
# applications (block 0, 1, 0), two B/C groups, head dim 2 d / heads, an
# adapter
SMOKE = ModelConfig(
    name="zamba2-7b-instruct-smoke", kind="hybrid", n_layers=8, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=128, vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16,
                  n_groups=2, conv_bias=True),
    hybrid_layer_ids=(1, 3, 6), n_mem_blocks=2, attn_in=128, adapter_rank=8,
    norm_eps=1e-5, param_dtype="float32", compute_dtype="float32",
)
register(CONFIG, SMOKE)
