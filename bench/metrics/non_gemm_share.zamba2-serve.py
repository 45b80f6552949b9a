"""The share of the traced slice's kernel time in Zamba2's decode step
that goes to neither a GEMM nor a copy or set: the SSM state update, the
conv, the norms, the gates, the attention's elementwise work. Kernels are
told apart by name with ``pointwise_share.chain``'s patterns; memory
copies and sets count on neither side."""
from bench import harness

LAYER = "models/ssm.py mamba_block"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "tokens_per_s"
_CHAIN = harness.load_module("metrics", "pointwise_share.chain")
GEMM, COPY = _CHAIN.GEMM, _CHAIN.COPY


def read(rec):
    trace = rec.get("trace")
    if not trace or not rec.get("serve"):
        return None
    total = other = 0.0
    for name, k in trace["kernels"].items():
        if COPY.match(name):
            continue
        total += k["seconds"]
        if not GEMM.search(name):
            other += k["seconds"]
    if total <= 0:
        return None
    return 100.0 * other / total
