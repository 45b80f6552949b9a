"""The share of the traced slice's kernel time that goes to neither a GEMM
nor the prefill attention: the norms, RoPE, SwiGLU's gate, the residual
adds, casts and copies, the embedding and the greedy head's reductions.
Kernels are told apart by name; memory copies and sets are not kernels and
count on neither side."""
import re

LAYER = "kernels/pointwise"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "tokens_per_s"
# cuBLAS's and CUTLASS's matrix products (``nvjet_*``, ``*gemm*``,
# ``sm90_xmma_*``, ``cutlass_*``)
GEMM = re.compile(r"nvjet|gemm|xmma|cutlass|cublas", re.IGNORECASE)
# the kernels that run one call of the prefill attention each
ATTENTION = re.compile(r"flash_fwd|chunked_fwd")
COPY = re.compile(r"^Mem(cpy|set)")


def read(rec):
    trace = rec.get("trace")
    if not trace or not rec.get("chain"):
        return None
    total = other = 0.0
    for name, k in trace["kernels"].items():
        if COPY.match(name):
            continue
        total += k["seconds"]
        if not (GEMM.search(name) or ATTENTION.search(name)):
            other += k["seconds"]
    if total <= 0:
        return None
    return 100.0 * other / total
