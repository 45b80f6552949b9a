"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``)
and a CUDA card: set-up (weights from the seed, the program's warm-up),
the measured window of ``--seconds``, the check of the window's answers
against the plain reference, and one JSON line on standard output with
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, read
from a profiler trace of a slice of the window) and ``device``, and with
``--trace 1`` ``breakdown``; ``checks``, last, holds each number compared
with its limit, which also end standard error. Without CUDA, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it exits with a code other than 0 and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# the kernel caches, at fixed paths inside the checkout: only a cell's first
# run in a checkout builds (the program's own build/kernels is beside them)
CACHE = CHECKOUT / "build" / "bench_cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_env() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # libraries that would load JAX by themselves are kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (CHECKOUT / "src", CHECKOUT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def compare(values: dict, limits: dict) -> dict:
    """Each number with a limit, against it: ``max`` (at most) or ``min``
    (at least)."""
    out = {}
    for name, lim in limits.items():
        v = values[name]
        ok = v <= lim["max"] if "max" in lim else v >= lim["min"]
        out[name] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out


def end_to_end(spec: dict, cell, rec: dict, meter, setup_s: float) -> dict:
    from bench.harness import percentile, reports

    values = {"setup_s": setup_s}
    if rec["tokens"] > 0:
        values["tokens_per_s"] = rec["tokens"] / rec["window_s"]
        values["joules_per_token"] = meter.joules / rec["tokens"]
    if rec.get("ttft_ms"):
        values["ttft_p95_ms"] = percentile(rec["ttft_ms"], 95)
    if rec.get("itl_ms"):
        values["itl_p95_ms"] = percentile(rec["itl_ms"], 95)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"] if reports(m, cell.name)
            and m["name"] in values}


def per_layer(spec: dict, cell, record: dict) -> dict:
    from bench.harness import load_module, reports

    out = {}
    for m in spec["per_layer"]:
        if not reports(m, cell.name):
            continue
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    setup_env()
    from bench import harness
    from bench.energy import EnergyCounter, cuda_pci_bus_id

    spec = harness.load_spec()
    cell = harness.load_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace))
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    peaks = harness.load_json(harness.BENCH / "peaks.json").get(kind)
    counter = EnergyCounter(cuda_pci_bus_id(0))
    meter = harness.Meter(counter)
    tracing = harness.Tracing(cell.trace)
    run = harness.load_module("drivers", cell.mix["driver"]).Run(
        cell, tracing)
    run.setup()
    # the peak of the window, not of set-up's transients
    torch.cuda.reset_peak_memory_stats()
    rec = run.window(meter)
    peak = torch.cuda.max_memory_allocated()
    # set-up ends as the window opens (a serving mix's lead-in is set-up)
    setup_s = meter.t[0] - T_START
    trace = tracing.reduce()
    run.free()
    t_check = time.perf_counter()
    values = run.check()
    checks = compare(values, cell.limits)
    check_s = time.perf_counter() - t_check
    banned = harness.banned_modules()
    if banned:
        print(f"JAX or the JAX package was loaded: {banned}", file=sys.stderr)
        return 3
    record = {**rec, "energy_j": meter.joules, "energy_window_s":
              meter.seconds, "trace": trace, "dims": cell.dims,
              "mix": cell.mix, "peaks": peaks}
    if cell.trace:
        metrics = per_layer(spec, cell, record)
    else:
        metrics = end_to_end(spec, cell, rec, meter, setup_s)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": peak,
              "power_limit_w": counter.power_limit_w()}
    result = {"correct": rec["failed"] == 0
              and all(c["ok"] for c in checks.values()),
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    summary = {"samples": rec["samples"], "check_s": check_s,
               "values": values}
    if trace is not None:
        summary["trace"] = {k: trace[k] for k in ("device_events", "ranges",
                                                  "range_s")}
    print(json.dumps(summary))
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
