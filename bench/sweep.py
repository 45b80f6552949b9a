"""The knee of a serving cell: the highest offered rate at which the
engine's backlog does not grow over a window.

    python3 bench/sweep.py --workload <serve cell> --rates R1 R2 ... \
        --seconds S --seed N

One process: set-up once, then for each rate a window of steady Poisson
arrivals with the cell's lengths (no drain) on a fresh engine, after the
mix's lead-in at the same rate. Prints one
JSON line a rate: the output tokens/s, the mean share of slots in use and
the requests waiting for a slot at each quarter of the window. The cell's
fixed rate is 0.8 x the knee, written into its traffic file.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.run import setup_env  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    setup_env()
    import torch

    from bench import harness, traffic

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(harness.load_spec(), args.workload, args.seed,
                             args.seconds, False)
    run = harness.load_module("drivers", cell.mix["driver"]).Run(
        cell, harness.Tracing(False))
    run.setup()
    for rate in args.rates:
        run.mix = {**cell.mix, "drain_s": 0.0,
                   "arrivals": {"kind": "poisson", "rate_per_s": rate}}
        run.arrivals = traffic.requests(run.mix, args.seconds, args.seed,
                                        cell.dims["vocab"])
        rec = run.window(harness.Meter())
        steps = rec["serve"]["steps"]
        t0 = rec["serve"]["t0"]

        def queued(q):
            at = t0 + q * args.seconds
            return min(steps, key=lambda s: abs(s[1] - at))[4]

        print(json.dumps({
            "workload": cell.name, "rate_per_s": rate,
            "offered": rec["attempted"],
            "tokens_per_s": rec["tokens"] / rec["window_s"],
            "occupancy": sum(s[2] for s in steps)
            / (len(steps) * cell.mix["batch_slots"]),
            "step_ms": 1e3 * sum(s[1] - s[0] for s in steps) / len(steps),
            "queued_at_quarters": [queued(q) for q in (0.25, 0.5, 0.75,
                                                       1.0)]}), flush=True)
        run.free()
        gc.collect()
        torch.cuda.empty_cache()
        run.new_engine()
    return 0


if __name__ == "__main__":
    sys.exit(main())
