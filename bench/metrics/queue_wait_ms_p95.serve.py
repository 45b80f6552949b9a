"""Admission: the 95th percentile, over every request due in the window
and admitted, of the engine's admission stamp (``Request.admitted_s``)
less its due time: the wait for a free slot."""
from bench.harness import percentile

LAYER = "serve/engine.py ServeEngine"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "ttft_p95_ms"


def read(rec):
    waits = rec.get("serve", {}).get("queue_wait_ms")
    return percentile(waits, 95) if waits else None
