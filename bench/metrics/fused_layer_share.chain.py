"""How many of the chain's layers took the fused pointwise path: launches
of the fused RoPE kernel (``rope_qk_fwd``, one a layer) over launches of
the prefill attention (one a layer), in the traced slice. 100 % when every
layer took it; nothing to read where no fused RoPE kernel ran."""
import re

LAYER = "kernels/pointwise"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"
ROPE = re.compile(r"rope_qk_fwd")
ATTENTION = re.compile(r"flash_fwd|chunked_fwd")


def read(rec):
    trace = rec.get("trace")
    if not trace or not rec.get("chain"):
        return None
    rope = attention = 0
    for name, k in trace["kernels"].items():
        if ROPE.search(name):
            rope += k["launches"]
        elif ATTENTION.search(name):
            attention += k["launches"]
    if not rope or not attention:
        return None
    return 100.0 * rope / attention
