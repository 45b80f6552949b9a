"""Cells of the benchmark at the program's smoke sizes on the CPU, for the
tests: each configuration file's ``as_run`` and overrides replaced by the
smoke configuration's sizes, fp32, and a short window."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (CHECKOUT / "src", CHECKOUT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import harness  # noqa: E402

SMOKE_MIX = {
    "serve": {"batch_slots": 4, "max_len": 48,
              "arrivals": {"kind": "poisson", "rate_per_s": 40.0},
              "prompt": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                         "min": 2, "max": 16},
              "output": {"dist": "lognormal", "median": 5, "sigma": 0.5,
                         "min": 2, "max": 12},
              "lead_s": 0.3, "drain_s": 60,
              "check": {"sample_requests": 12},
              "trace_slice": None},
    "chain": {"batch": 1, "tokens_per_frame": 24, "frame_period_s": 0.5,
              "warmup_frames": 1, "system": {"big": 1, "little": 0},
              "strategy": "herad", "timeout_s": 120,
              "check": {"sample_frames": 2}},
}


def as_run(cfg) -> dict:
    """A configuration file's ``as_run`` sizes of a program config."""
    dims = {"kind": cfg.kind, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps,
            "tie_embeddings": cfg.tie_embeddings}
    return dims


def shrink(cell: harness.Cell, dtype: str = "float32") -> harness.Cell:
    """``cell`` at its configuration's smoke size on the CPU."""
    from repro_torch.models.config import get_smoke_config

    config = dict(cell.config)
    smoke = get_smoke_config(config["program_arch"])
    over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                          "d_ff", "vocab")}
    config.update(program_overrides=over, dtype=dtype,
                  as_run=as_run(smoke))
    mix = {**cell.mix, **SMOKE_MIX[cell.mix["driver"]]}
    return dataclasses.replace(cell, config=config, mix=mix, device="cpu")


def smoke_cell(workload: str, seed: int = 7, seconds: float = 1.0,
               trace: bool = False, dtype: str = "float32") -> harness.Cell:
    """The spec's ``workload`` at its configuration's smoke size."""
    cell = harness.load_cell(harness.load_spec(), workload, seed, seconds,
                             trace)
    return shrink(cell, dtype)


def run_cell(cell: harness.Cell, hook=None):
    """Set-up, window and check of ``cell`` on the CPU; ``hook(run)``, if
    given, breaks the timed path after set-up. Returns (run, record,
    values, checks)."""
    sys.argv = sys.argv[:1]
    from bench.run import compare

    run = harness.load_module("drivers", cell.mix["driver"]).Run(
        cell, harness.Tracing(False))
    run.setup()
    if hook is not None:
        hook(run)
    rec = run.window(harness.Meter())
    run.free()
    values = run.check()
    return run, rec, values, compare(values, cell.limits)
