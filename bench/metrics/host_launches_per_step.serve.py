"""The host's CUDA launches (kernels, graphs, copies, fills) in the
traced slice, per engine step in it: one graph replay a step plus the
copies and lane resets around it."""
LAYER = "serve/graph.py CapturedStep"
SOURCE = "device_trace"
UNIT = "launches"
BETTER = "lower"
MOVES = "itl_p95_ms"


def read(rec):
    trace = rec.get("trace")
    if not trace or "serve" not in rec:
        return None
    steps = trace["ranges"].get("bench/engine.step", 0)
    return trace["host_launches"] / steps if steps else None
