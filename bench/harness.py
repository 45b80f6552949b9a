"""The benchmark's general machinery: the spec and the files it names,
discovery of drivers and per-layer metrics by name, the statistics, the
reduction of a profiler trace, and the program's configuration.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

  configs/<config>.json       sizes as run (``as_run``), the program's
                              registered name and overrides, the source
  traffic/<mix>.json          the mix's ``driver`` and parameters
  drivers/<driver>.py         a ``Run`` class that sets up, drives the
                              window and reads the answers back
  metrics/<metric>.py         ``LAYER``, ``SOURCE``, ``UNIT``, ``BETTER``,
                              ``MOVES`` and ``read(record)``
  limits/<workload>.json      the limit of each number ``correct`` compares
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")
# the CUDA API calls that put work on the device: a graph's kernels show on
# the device one by one but cost the host one launch
HOST_LAUNCH = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                         r"GraphLaunch|Memcpy|Memset)")
BREAKDOWN_ENTRIES = 10


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def by_name(entries: list[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r}")


def load_module(kind: str, name: str, bench: Path = BENCH):
    """``bench/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded from its file, not imported by name)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One run of one cell: its configuration file, traffic mix and
    limits, and the run's arguments."""
    name: str
    config: dict
    mix: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"

    @property
    def dims(self) -> dict:
        return self.config["as_run"]


def load_cell(spec: dict, workload: str, seed: int, seconds: float,
              trace: bool, root: Path = CHECKOUT) -> Cell:
    cell = by_name(spec["workloads"], workload, "workload")
    config = by_name(spec["configs"], cell["config"], "config")
    return Cell(name=workload, config=load_json(root / config["file"]),
                mix=load_json(root / "bench" / "traffic"
                              / f"{cell['traffic']}.json"),
                limits=load_json(root / "bench" / "limits"
                                 / f"{workload}.json"),
                chips=cell["chips"], seed=seed, seconds=seconds,
                trace=trace)


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric of the spec is reported in ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


# ------------------------------------------------------------- statistics
def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all the values, interpolated
    linearly between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    at = (len(xs) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def banned_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in BANNED})


# --------------------------------------------------------- the program
def port_config(cell: Cell):
    """The program's ``ModelConfig`` of the cell's configuration: its
    registered one with the file's overrides, checked field by field
    against the sizes the file says are run."""
    from repro_torch.models.config import get_config

    c = cell.config
    cfg = get_config(c["program_arch"])
    cfg = dataclasses.replace(cfg, param_dtype=c["dtype"],
                              compute_dtype=c["dtype"],
                              **c.get("program_overrides", {}))
    dims = cell.dims
    got = {"kind": cfg.kind, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps,
           "tie_embeddings": cfg.tie_embeddings,
           "shared_attn_every": cfg.shared_attn_every,
           "ssm": dataclasses.asdict(cfg.ssm) if cfg.ssm else None,
           "window": cfg.window, "moe": cfg.moe}
    want = {k: dims.get(k) for k in got}
    want["window"] = dims.get("window", 0)
    want["shared_attn_every"] = dims.get("shared_attn_every", 0)
    if got != want:
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise ValueError(f"{cell.name}: the program's configuration differs "
                         f"from {c['name']}'s as_run: {diff}")
    return cfg


# ------------------------------------------------------------- the trace
def reduce_trace(events, window_s: float) -> dict:
    """What the metrics read of a torch.profiler trace of ``window_s``
    seconds: the device's busy seconds (the union of its activity
    intervals), each kernel's launches and seconds, the host's launches,
    the benchmark's ranges (``bench/...``) and the idle gaps between
    device activity, each labelled by the innermost benchmark range the
    host was in when it began."""
    from torch.autograd import DeviceType

    device, ranges, launches = [], [], 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.time_range.start, e.time_range.end,
                               e.name[:100]))
        elif e.name.startswith("bench/"):
            ranges.append((e.time_range.start, e.time_range.end, e.name))
        elif HOST_LAUNCH.match(e.name):
            launches += 1
    device.sort()
    busy, reach, kernels, gaps = 0.0, None, {}, []
    for start, end, name in device:
        if reach is not None and start > reach:
            gaps.append((reach, start))
        busy += max(0.0, end - max(start, reach if reach is not None
                                   else start))
        reach = end if reach is None else max(reach, end)
        count, secs = kernels.get(name, (0, 0.0))
        kernels[name] = (count + 1, secs + (end - start) * 1e-6)
    range_counts: dict[str, int] = {}
    range_s: dict[str, float] = {}
    for start, end, name in ranges:
        range_counts[name] = range_counts.get(name, 0) + 1
        range_s[name] = range_s.get(name, 0.0) + (end - start) * 1e-6
    # innermost range containing t: the latest-starting one that covers it
    ranges.sort()

    def label(t):
        inner = None
        for start, end, name in ranges:
            if start > t:
                break
            if end >= t:
                inner = name
        return inner or "host outside the benchmark's ranges"

    gaps.sort(key=lambda g: g[0] - g[1])
    top_gaps = [[label(s), (e - s) * 1e-6] for s, e in
                gaps[:BREAKDOWN_ENTRIES]]
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "kernels": {k: {"launches": c, "seconds": s}
                        for k, (c, s) in kernels.items()},
            "host_launches": launches, "ranges": range_counts,
            "range_s": range_s, "device_events": len(device),
            "breakdown": {
                "device_ops": [[k, s] for k, (_, s) in
                               top_ops[:BREAKDOWN_ENTRIES]],
                "idle_gaps": top_gaps}}


class Meter:
    """The window's clock, and the card's energy counter where one is
    given, read when the window opens and closes (each once: later calls
    do nothing). Runs that report no energy (the knee sweep, the control,
    the CPU tests) give no counter."""

    def __init__(self, counter=None):
        self.counter = counter
        self.mj = [None, None]
        self.t = [None, None]

    def _read(self, i: int) -> None:
        if self.t[i] is None:
            self.t[i] = time.perf_counter()
            if self.counter is not None:
                self.mj[i] = self.counter.read_mj()

    def open(self) -> None:
        self._read(0)

    def close(self) -> None:
        self._read(1)

    @property
    def joules(self) -> float:
        return (self.mj[1] - self.mj[0]) / 1e3

    @property
    def seconds(self) -> float:
        return self.t[1] - self.t[0]


class Tracing:
    """The profiler over a slice of the window, and the benchmark's ranges
    (``record_function``) around each call into a layer; without a trace
    both are free."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.t0 = self.t1 = None
        self.result = None
        # host intervals in which starting or stopping the profiler held
        # the caller up: what it timed there is the profiler's, not the
        # program's
        self.blocked: list[tuple[float, float]] = []

    def range(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def warm(self) -> None:
        """A tiny profile in set-up, so that starting the profiler inside
        the window does not pay for its first initialisation."""
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        begin = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.blocked.append((begin, self.t0))

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.blocked.append((self.t1, time.perf_counter()))

    def clear(self, t: float, after_s: float = 1.0) -> bool:
        """Whether host time ``t`` lies outside every interval the
        profiler held the caller up, and ``after_s`` past it."""
        return all(not a <= t <= b + after_s for a, b in self.blocked)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def reduce(self) -> dict | None:
        """The reduced trace, or None where no slice was profiled."""
        if self.result is None and self.prof is not None:
            self.result = reduce_trace(self.prof.events(), self.t1 - self.t0)
            self.prof = None
        return self.result
