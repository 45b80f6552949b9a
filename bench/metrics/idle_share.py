"""The card's idle share in the traced slice: 1 less the union of its
activity intervals over the slice's wall time."""
LAYER = "H100"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "tokens_per_s"


def read(rec):
    trace = rec.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
