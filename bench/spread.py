"""Spreads of a cell's runs, for setting the end-to-end bounds.

    python3 bench/spread.py RESULTS...

Each file holds the standard output of ``bench/run.py`` runs (any number
of result lines, other lines ignored); each file is one set. Prints, for
each metric, each set's median and spread (the distance between the first
and third quartiles of ``statistics.quantiles(values, n=4)``, as a share
of the median), and the bound five times the widest spread would give.
"""
from __future__ import annotations

import json
import statistics
import sys


def results(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"correct"' in line:
                out.append(json.loads(line))
    return out


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths: list[str]) -> int:
    sets = [results(p) for p in paths]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        row = []
        for s in sets:
            vals = [r["metrics"][name]["value"] for r in s
                    if name in r["metrics"]]
            if len(vals) >= 2:
                row.append((statistics.median(vals), spread(vals), len(vals)))
        if not row:
            continue
        widest = max(sp for _, sp, _ in row)
        print(json.dumps({"metric": name, "sets": [
            {"median": m, "spread": sp, "runs": n} for m, sp, n in row],
            "widest": widest, "bound_5x": max(0.01, 5 * widest)}))
    bad = [r for s in sets for r in s if not r["correct"]]
    print(json.dumps({"runs": sum(len(s) for s in sets),
                      "not_correct": len(bad)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
