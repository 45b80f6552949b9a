"""Operations and bytes of one engine decode step of Zyphra's Zamba2 (the
``zamba2-7b-instruct`` configuration), worked out from its ``as_run``
shapes alone: the yardstick of ``mfu.zamba2-serve``.

As ``work.decode_step_work`` counts a dense step, every count is of what
the inputs need: the weights read once, each live lane's recurrent state
(the fp32 SSM state and the conv's last inputs of every layer) read and
written once, and each live lane's K/V read up to its own position, one
new row written, in each application of a shared block.
"""
from __future__ import annotations

from bench.work import BF16, padded_vocab

FP32 = 4
# the SSM update's operations per state element: the decay's product, the
# outer product dt x B and its sum, and C's contraction (a product and a
# sum)
SSM_FLOPS_PER_ELEMENT = 5


def _ssm(dims: dict) -> tuple[int, int, int]:
    """(d_inner, heads, the conv's channels) of one Mamba2 layer."""
    s, d = dims["ssm"], dims["d_model"]
    di = s["expand"] * d
    return di, di // s["head_dim"], di + 2 * s["n_groups"] * s["d_state"]


def mamba_params(dims: dict) -> int:
    """Weights of one Mamba2 layer's products: in_proj and out_proj."""
    d = dims["d_model"]
    di, h, conv = _ssm(dims)
    return d * (di + conv + h) + di * d


def mamba_other(dims: dict) -> int:
    """Its other weights: the conv and its bias, dt_bias, A_log, D, the
    gated norm's and the layer norm's scales."""
    d = dims["d_model"]
    di, h, conv = _ssm(dims)
    return (dims["ssm"]["conv_width"] + 1) * conv + 3 * h + di + d


def block_params(dims: dict) -> int:
    """Weights of one shared block's products: q, k, v over the attention
    input, o back to d, and the gate, up and down products."""
    a, d = dims["attn_in"], dims["d_model"]
    hq, hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    return a * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * dims["d_ff"]


def app_params(dims: dict) -> int:
    """Weights of one application's products: its adapter and its
    linear."""
    d, r = dims["d_model"], dims["adapter_rank"]
    return d * r + 2 * r * dims["d_ff"] + d * d


def weight_bytes(dims: dict) -> int:
    """Bytes of every weight, read once, in bf16: the tied table (the
    greedy head reads it whole), every layer, both blocks (with their
    norms) and every application's leaves."""
    d, apps = dims["d_model"], len(dims["hybrid_layer_ids"])
    n = padded_vocab(dims) * d + d \
        + dims["n_layers"] * (mamba_params(dims) + mamba_other(dims)) \
        + dims["n_mem_blocks"] * (block_params(dims) + dims["attn_in"] + d) \
        + apps * app_params(dims)
    return BF16 * n


def state_bytes(dims: dict) -> int:
    """One lane's recurrent state over every layer: the fp32 SSM state
    (heads x head_dim x d_state) and the conv's last width - 1 inputs."""
    s = dims["ssm"]
    _, h, conv = _ssm(dims)
    return dims["n_layers"] * (FP32 * h * s["head_dim"] * s["d_state"]
                               + BF16 * (s["conv_width"] - 1) * conv)


def decode_step_work(dims: dict, lanes: int, keys: int
                     ) -> tuple[float, float]:
    """(flops, bytes) of one decode step over ``lanes`` live lanes whose
    attention sees ``keys`` cached positions in all (the sum over the
    lanes of each one's position + 1). Flops: 2 per weight and lane of
    every product each lane runs (a block's weights once an application),
    4 hd per (head, key) pair in each application, the SSM update's own,
    and the greedy head. Bytes: the weights once, each lane's state read
    and written, each lane's K/V to its own position read and one row
    written in each application."""
    s, d = dims["ssm"], dims["d_model"]
    _, h, _ = _ssm(dims)
    apps = len(dims["hybrid_layer_ids"])
    hq, hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    per_lane = dims["n_layers"] * mamba_params(dims) \
        + apps * (block_params(dims) + app_params(dims)) \
        + padded_vocab(dims) * d
    ssm = dims["n_layers"] * SSM_FLOPS_PER_ELEMENT * h * s["head_dim"] \
        * s["d_state"]
    flops = lanes * (2 * per_lane + ssm) + apps * 4 * hq * hd * keys
    kv_row = 2 * hkv * hd * BF16
    nbytes = weight_bytes(dims) + 2 * lanes * state_bytes(dims) \
        + apps * (keys + lanes) * kv_row
    return float(flops), float(nbytes)
