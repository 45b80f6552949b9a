"""The spec and the files it names: every cell, configuration, mix, limit
and per-layer metric is found by name, and a cell is added from new files
alone."""
import hashlib
import json
import re
import shutil

import pytest
import smoke

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]


def test_spec_shape():
    assert list(SPEC) == TOP
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"])
               ) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_file_declares_its_entry(metric):
    mod = harness.load_module("metrics", metric["name"])
    assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.BETTER, mod.MOVES) == (
        metric["layer"], metric["source"], metric["unit"], metric["better"],
        metric["moves"])
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
    moves = harness.by_name(SPEC["end_to_end"], metric["moves"], "metric")
    for w in metric.get("workloads", [x["name"] for x in SPEC["workloads"]]):
        assert harness.reports(moves, w), (metric["name"], w)
    assert mod.read({}) is None          # nothing to read, nothing returned


@pytest.mark.parametrize("workload", SPEC["workloads"],
                         ids=[w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(SPEC, workload["name"], 1, 10.0, False)
    harness.load_module("drivers", cell.mix["driver"])
    assert len(cell.mix["why"]) <= 200
    assert cell.limits
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if harness.reports(m, cell.name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.reports(m, cell.name) for m in SPEC["per_layer"])


def _hashes(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_added_cell_from_new_files(tmp_path):
    """A new mix, limits, metric and cell need new files and new spec
    entries only; the added cell then runs (at the smoke size, here)."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    before = _hashes(root / "bench")
    mix = harness.load_json(harness.BENCH / "traffic" / "serve-chat.json")
    mix.update(arrivals={"kind": "on_off", "rate_per_s": 3.0, "on_s": 2.0,
                         "off_s": 3.0},
               why="the chat mix in bursts")
    (root / "bench" / "traffic" / "serve-chat-bursty.json").write_text(
        json.dumps(mix))
    (root / "bench" / "limits" / "phi3-14b.serve-bursty.json").write_text(
        json.dumps({"served_gap_max": {"max": 1e-4},
                    "served_tokens_checked": {"min": 1}}))
    (root / "bench" / "metrics" / "steps_in_window.serve.py").write_text(
        'LAYER = "serve/engine.py ServeEngine"\nSOURCE = "program_counter"\n'
        'UNIT = "steps"\nBETTER = "higher"\nMOVES = "tokens_per_s"\n\n\n'
        'def read(rec):\n    s = rec.get("serve")\n'
        '    return len(s["steps"]) if s else None\n')
    spec["workloads"].append({"name": "phi3-14b.serve-bursty",
                              "config": "phi3-medium-14b",
                              "traffic": "serve-chat-bursty", "chips": 1,
                              "why": "bursty arrivals"})
    spec["per_layer"].append({"name": "steps_in_window.serve",
                              "unit": "steps", "better": "higher",
                              "source": "program_counter",
                              "layer": "serve/engine.py ServeEngine",
                              "moves": "tokens_per_s",
                              "workloads": ["phi3-14b.serve-bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _hashes(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
    cell = harness.load_cell(spec, "phi3-14b.serve-bursty", 3, 2.0, False,
                             root=root)
    assert cell.mix["arrivals"]["kind"] == "on_off"
    run, rec, values, checks = smoke.run_cell(smoke.shrink(cell))
    assert rec["failed"] == 0 and all(c["ok"] for c in checks.values())
    metric = harness.load_module("metrics", "steps_in_window.serve",
                                 bench=root / "bench")
    assert metric.read(rec) == len(rec["serve"]["steps"]) > 0
