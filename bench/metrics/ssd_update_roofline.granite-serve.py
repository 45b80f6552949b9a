"""Granite 4.0-H's decode state update's share of its roofline in the
traced slice: ``ssd_update_roofline.zamba2-serve``'s reading (each launch
of a kernel named ``ssd_decode`` updates one Mamba2 layer's state of every
lane, whose least time is that fp32 state read once and written once over
the card's HBM rate; the least times of the launches, summed, over their
device seconds), here at d_state 128, one B/C group and the cell's 32
lanes. Nothing to read where no such kernel ran."""
from bench import harness

LAYER = "models/ssm.py mamba_block"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "itl_p95_ms"
_ZAMBA2 = harness.load_module("metrics", "ssd_update_roofline.zamba2-serve")


def read(rec):
    return _ZAMBA2.read(rec)
