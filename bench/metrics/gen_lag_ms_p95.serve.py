"""How late the load generator submitted requests: the 95th percentile,
over every request due in the window, of its submission less its due
time. A late generator hides queueing from time to first token."""
from bench.harness import percentile

LAYER = "load generator"
SOURCE = "host_clock"
UNIT = "ms"
BETTER = "lower"
MOVES = "ttft_p95_ms"


def read(rec):
    lags = rec.get("serve", {}).get("gen_lag_ms")
    return percentile(lags, 95) if lags else None
