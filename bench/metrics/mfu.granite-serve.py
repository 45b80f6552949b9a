"""Granite 4.0-H's whole decode step's share of the card's peak: over the
engine steps inside the window, the least time each could take at the
card's peaks (``work_granite.decode_step_work`` for its live lanes and
their positions: the larger of its FLOPs over the bf16 peak and its bytes
over the HBM rate) over the time the steps took, as ``mfu.serve`` reads a
dense step."""
from bench import work, work_granite

LAYER = "models/transformer.py decode_step"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"


def read(rec):
    serve, peaks = rec.get("serve"), rec.get("peaks")
    dims = rec.get("dims") or {}
    if not serve or not serve["steps"] or not peaks \
            or not dims.get("layer_types") or not dims.get("moe"):
        return None
    least = took = 0.0
    for before, after, lanes, keys, _ in serve["steps"]:
        flops, nbytes = work_granite.decode_step_work(dims, lanes, keys)
        least += work.bound_s(flops, nbytes, (peaks["bf16_flops"],
                                              peaks["hbm_bytes_per_s"]))[0]
        took += after - before
    return 100.0 * least / took
