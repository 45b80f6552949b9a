"""Zamba2's decode state update's share of its roofline in the traced
slice: each launch of a kernel named ``ssd_decode`` updates one Mamba2
layer's state of every lane, whose least time is that fp32 state read
once and written once (2 x lanes x heads x head_dim x d_state x 4 bytes,
the engine's ``batch_slots`` lanes) over the card's HBM rate; the least
times of the launches, summed, over their device seconds. Nothing to read
where no such kernel ran (the plain ops' update)."""
import re

LAYER = "models/ssm.py mamba_block"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "itl_p95_ms"
KERNELS = re.compile(r"ssd_decode")
FP32 = 4


def read(rec):
    trace, serve, peaks = rec.get("trace"), rec.get("serve"), rec.get("peaks")
    if not trace or not serve or not peaks or not rec["dims"].get("ssm"):
        return None
    launches = seconds = 0
    for name, k in trace["kernels"].items():
        if KERNELS.search(name):
            launches += k["launches"]
            seconds += k["seconds"]
    if not launches:
        return None
    s, d = rec["dims"]["ssm"], rec["dims"]["d_model"]
    heads = s["expand"] * d // s["head_dim"]
    nbytes = 2 * serve["batch_slots"] * heads * s["head_dim"] \
        * s["d_state"] * FP32
    return 100.0 * launches * nbytes / peaks["hbm_bytes_per_s"] / seconds
