"""The share of the traced slice's kernel time in Granite 4.0-H's decode
step that goes to the MoE's routing, dispatch and combine (``models/moe.py``
``moe_local``'s ``moe/route_dispatch`` and ``moe/combine`` ranges) rather
than to its products: device seconds of the kernels whose names ``ROUTE``
matches over all kernel seconds, copies and sets left out.

The names were read on the card (NVIDIA H100 80GB HBM3, PyTorch built for
CUDA 12.8) in an eager decode step, where ``chip_smoke.py`` checks that
every kernel the pattern matches runs inside those two ranges: the top-k
of the router's logits (``gatherTopK``, and ``bitonicSortKVInPlace`` over
the k it keeps), the stable sort of the flat choices by expert
(``radixSortKVInPlace``), ``searchsorted`` over it, the ranks' scatter
(``_scatter_gather_elementwise_kernel``), the index gather of each
choice's run start (``gpu_index_kernel``), and the combine's gather of
the (token, choice) rows (``vectorized_gather_kernel`` over long
indices) and weighted sum (``gemv2N_kernel``). Kernels of the routing
that other layers run under the same name (the elementwise arithmetic,
the buffers' ``index_copy_``, which also writes the attention's K/V, the
concatenations and copies) and the router's own product are not counted,
so the share is a lower bound of the routing's: in an eager step of the
cell's 32 lanes at position 300 the two ranges held 4.4 of 39.2 device
ms, these kernels 2.0 (NVIDIA H100 80GB HBM3)."""
import re

from bench import harness

LAYER = "models/moe.py moe_local"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "itl_p95_ms"
ROUTE = re.compile(r"gatherTopK|bitonicSortKVInPlace|radixSortKVInPlace|"
                   r"searchsorted|_scatter_gather_elementwise_kernel|"
                   r"gpu_index_kernel|vectorized_gather_kernel<\d+, long>|"
                   r"gemv2N_kernel")
COPY = harness.load_module("metrics", "pointwise_share.chain").COPY


def read(rec):
    trace = rec.get("trace")
    if not trace or not rec.get("serve") or not rec["dims"].get("moe"):
        return None
    total = route = 0.0
    for name, k in trace["kernels"].items():
        if COPY.match(name):
            continue
        total += k["seconds"]
        if ROUTE.search(name):
            route += k["seconds"]
    if total <= 0 or route <= 0:
        return None
    return 100.0 * route / total
