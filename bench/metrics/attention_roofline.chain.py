"""The prefill attention kernels' share of their roofline in the traced
slice: each launch is one layer's causal attention over one frame, whose
least time at the card's peaks (``work.frame_attention``) is summed over
the launches and divided by the device time of those kernels. The kernels
are found by name, so any kernel that implements the attention is read
against the same work."""
import re

from bench import work

LAYER = "kernels/flash_attention"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"
# the kernels that run one call of the prefill attention each
KERNELS = re.compile(r"flash_fwd|chunked_fwd")


def read(rec):
    trace, chain, peaks = rec.get("trace"), rec.get("chain"), rec.get("peaks")
    if not trace or not chain or not peaks:
        return None
    launches = seconds = 0
    for name, k in trace["kernels"].items():
        if KERNELS.search(name):
            launches += k["launches"]
            seconds += k["seconds"]
    if not launches:
        return None
    flops, nbytes = work.frame_attention(rec["dims"],
                                         chain["tokens_per_frame"])
    least = work.bound_s(flops, nbytes, (peaks["bf16_flops"],
                                         peaks["hbm_bytes_per_s"]))[0]
    return 100.0 * launches * least / seconds
