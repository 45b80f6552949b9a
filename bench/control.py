"""The control of a cell's ``correct``: the plain reference computed in
float8 (e4m3) in the program's place, the precision below the
configurations' bf16, read against the fp32 reference with the same
numbers the check compares.

    python3 bench/control.py --workload <name> --seconds S --seeds N1 N2 N3

For each seed, one process runs the cell's set-up and a window of
``--seconds`` at the cell's own load (served requests drained as in a
run), then prints one JSON line with the program's numbers (``program``),
the control's (``control``) and the cell's limits. The limits are set
between the two readings; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.run import setup_env  # noqa: E402


def readings(workload: str, seed: int, seconds: float, cell=None) -> dict:
    """One seed's program and control readings of ``workload`` (or of a
    ready ``cell``, such as a test's smoke-size one)."""
    from bench import harness

    if cell is None:
        cell = harness.load_cell(harness.load_spec(), workload, seed,
                                 seconds, False)
    run = harness.load_module("drivers", cell.mix["driver"]).Run(
        cell, harness.Tracing(False))
    run.setup()
    rec = run.window(harness.Meter())
    run.free()
    out = {"workload": cell.name, "seed": seed, "attempted": rec["attempted"],
           "failed": rec["failed"], "program": run.check(),
           "control": run.control(), "limits": cell.limits}
    del run
    gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    setup_env()
    import torch

    if not torch.cuda.is_available():
        print("the control needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
