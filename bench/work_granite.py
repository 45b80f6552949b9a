"""Operations and bytes of one engine decode step of IBM's Granite 4.0-H
(the ``granite-4.0-h-small`` configuration), worked out from its
``as_run`` shapes alone: the yardstick of ``mfu.granite-serve``.

As ``work.decode_step_work`` counts a dense step, every count is of what
the inputs need: every weight read once, every expert's included (at 32
live lanes routing 10 of 72 experts each, all but 0.8 % of the experts are
chosen by some lane in a layer, so a step reads nearly all of them), each
live lane's recurrent state (the fp32 SSM state and the conv's last
inputs of every Mamba2 layer) read and written once, and each live lane's
K/V read up to its own position, one new row written, in every attention
layer. The operations are those of the live lanes' real assignments: 2 a
weight a lane for the products each lane runs, its top-k experts' and
not the others'.
"""
from __future__ import annotations

from bench.work import BF16, padded_vocab
from bench.work_zamba2 import (FP32, SSM_FLOPS_PER_ELEMENT, _ssm,
                               mamba_other, mamba_params)


def layer_counts(dims: dict) -> tuple[int, int]:
    """(Mamba2 layers, attention layers) of the pattern."""
    n_attn = dims["layer_types"].count("attention")
    return dims["n_layers"] - n_attn, n_attn


def attn_params(dims: dict) -> int:
    """Weights of one attention layer's products: q, k, v and o."""
    d, hq, hkv, hd = dims["d_model"], dims["n_heads"], dims["n_kv_heads"], \
        dims["head_dim"]
    return d * (hq + 2 * hkv) * hd + hq * hd * d


def expert_params(dims: dict) -> int:
    """Weights of one expert's SwiGLU: gate, up and down."""
    return 3 * dims["d_model"] * dims["moe"]["d_ff_expert"]


def ffn_params(dims: dict) -> int:
    """Weights of one layer's FFN products, every expert's: the router,
    the experts and the shared expert (a SwiGLU of width d_ff)."""
    d, m = dims["d_model"], dims["moe"]
    return d * m["n_experts"] + m["n_experts"] * expert_params(dims) \
        + 3 * d * dims["d_ff"]


def weight_bytes(dims: dict) -> int:
    """Bytes of every weight, read once, in bf16: the tied table (the
    greedy head reads it whole), the final norm, every Mamba2 layer, every
    attention layer with its norm, and every layer's FFN with its norm."""
    d = dims["d_model"]
    n_ssm, n_attn = layer_counts(dims)
    n = padded_vocab(dims) * d + d \
        + n_ssm * (mamba_params(dims) + mamba_other(dims)) \
        + n_attn * (attn_params(dims) + d) \
        + dims["n_layers"] * (ffn_params(dims) + d)
    return BF16 * n


def state_bytes(dims: dict) -> int:
    """One lane's recurrent state over every Mamba2 layer: the fp32 SSM
    state (heads x head_dim x d_state) and the conv's last width - 1
    inputs."""
    s = dims["ssm"]
    _, h, conv = _ssm(dims)
    n_ssm, _ = layer_counts(dims)
    return n_ssm * (FP32 * h * s["head_dim"] * s["d_state"]
                    + BF16 * (s["conv_width"] - 1) * conv)


def decode_step_work(dims: dict, lanes: int, keys: int
                     ) -> tuple[float, float]:
    """(flops, bytes) of one decode step over ``lanes`` live lanes whose
    attention sees ``keys`` cached positions in all (the sum over the
    lanes of each one's position + 1). Flops: 2 per weight and lane of
    every product each lane runs (the router, its top-k experts, the
    shared expert, its mixers, the greedy head), 4 hd per (query head,
    key) pair in each attention layer, and the SSM update's own. Bytes:
    the weights once, each lane's state read and written, each lane's K/V
    to its own position read and one row written in each attention
    layer."""
    s, d, m = dims["ssm"], dims["d_model"], dims["moe"]
    _, h, _ = _ssm(dims)
    n_ssm, n_attn = layer_counts(dims)
    hq, hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    ffn = d * m["n_experts"] + m["top_k"] * expert_params(dims) \
        + 3 * d * dims["d_ff"]
    per_lane = n_ssm * mamba_params(dims) + n_attn * attn_params(dims) \
        + dims["n_layers"] * ffn + padded_vocab(dims) * d
    ssm = n_ssm * SSM_FLOPS_PER_ELEMENT * h * s["head_dim"] * s["d_state"]
    flops = lanes * (2 * per_lane + ssm) + n_attn * 4 * hq * hd * keys
    kv_row = 2 * hkv * hd * BF16
    nbytes = weight_bytes(dims) + 2 * lanes * state_bytes(dims) \
        + n_attn * (keys + lanes) * kv_row
    return float(flops), float(nbytes)
