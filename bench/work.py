"""Operations and bytes that the benchmark's cells need, worked out from
shapes alone: the yardstick that the roofline and mfu metrics divide by.

``dims`` is a configuration file's ``as_run`` group (see ``configs/``).
Every count is of what the inputs need, not of what the code happens to
read: a decode step reads each live lane's cache up to its own position,
not the ``max_len`` rows the cache holds, and the weights once.

The attention count and the ``bound`` arithmetic follow ``chip_smoke.py``
(``attn_work``, ``bound``, ``train_flops``); the decode step's bytes are
new here.
"""
from __future__ import annotations

BF16 = 2


def hd(dims: dict) -> int:
    return dims.get("head_dim") or dims["d_model"] // dims["n_heads"]


def padded_vocab(dims: dict) -> int:
    return (dims["vocab"] + 127) // 128 * 128


def attn_block_params(dims: dict) -> int:
    """Weights of one attention + SwiGLU block's products."""
    d, hq, hkv, h = dims["d_model"], dims["n_heads"], dims["n_kv_heads"], \
        hd(dims)
    return 2 * d * hq * h + 2 * d * hkv * h + 3 * d * dims["d_ff"]


def weight_bytes(dims: dict) -> int:
    """Bytes of every weight a forward reads once, in bf16: the products'
    weights and the tied embedding table, which the greedy head reads
    whole."""
    return BF16 * (padded_vocab(dims) * dims["d_model"]
                   + dims["n_layers"] * attn_block_params(dims))


def attn_work(b, hq, hkv, s, d, window: int = 0, *, skv: int | None = None,
              causal: bool = True) -> tuple[int, int]:
    """(flops, bytes) of prefill attention of S queries over ``skv`` keys
    (default S): 4 D flops (q.k and p.v) for each (query, key) pair the
    mask shows, per batch and q head: S (S + 1) / 2 causal pairs, fewer
    under a ``window`` of w (w (w + 1) / 2 + (S - w) w), S x Skv without
    the causal mask; q, o, k, v each moved once in bf16."""
    skv = s if skv is None else skv
    if causal:
        w = min(window or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    else:
        pairs = s * skv
    return 4 * b * hq * pairs * d, BF16 * b * d * (2 * hq * s + 2 * hkv * skv)


def bound_s(flops: float, nbytes: float, peaks: tuple[float, float]
            ) -> tuple[float, str]:
    """The least time (s) the card could take: the larger of the
    operations over the bf16 tensor-core peak and the bytes over the
    memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def frame_attention(dims: dict, s: int) -> tuple[int, int]:
    """One layer's causal attention over one frame of ``s`` tokens."""
    return attn_work(1, dims["n_heads"], dims["n_kv_heads"], s, hd(dims))


def frame_flops(dims: dict, s: int) -> float:
    """Model FLOPs of one chain frame of ``s`` tokens through a dense
    model: 2 per weight of every layer product and token, the causal
    attention pairs of every layer, and the head's logits at the last
    position only (the chain emits one greedy token a frame)."""
    layers = dims["n_layers"] * (2 * s * attn_block_params(dims)
                                 + frame_attention(dims, s)[0])
    return float(layers + 2 * padded_vocab(dims) * dims["d_model"])


def frame_bytes(dims: dict, s: int) -> float:
    """Bytes one chain frame needs: the weights once, and each layer's
    attention inputs and output once."""
    return float(weight_bytes(dims)
                 + dims["n_layers"] * frame_attention(dims, s)[1])


def decode_step_work(dims: dict, lanes: int, keys: int) -> tuple[float, float]:
    """(flops, bytes) of one engine decode step over ``lanes`` live lanes
    whose attention sees ``keys`` cached positions in all (the sum over
    the lanes of each one's position + 1). Flops: 2 per weight and lane,
    4 hd per (query head, key) pair in each layer, and the greedy head.
    Bytes: the weights once; each lane's K/V up to its own position read
    and one row of each written, in every layer."""
    d, h = dims["d_model"], hd(dims)
    hq, hkv, layers = dims["n_heads"], dims["n_kv_heads"], dims["n_layers"]
    head = 2 * padded_vocab(dims) * d
    flops = lanes * head + layers * (
        lanes * 2 * attn_block_params(dims) + 4 * hq * h * keys)
    kv_row = 2 * hkv * h * BF16                      # one position's k and v
    nbytes = weight_bytes(dims) + layers * (keys + lanes) * kv_row
    return float(flops), float(nbytes)
