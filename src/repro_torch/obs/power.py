"""Measured-power ingestion: RAPL / powermetrics captures -> timelines.

The paper's energy numbers come from wall-power counters (Intel RAPL
MSRs on the x86 platforms, ``powermetrics`` on the Apple parts); until
now everything in this repo ran on *modeled* watts. This module is the
ingestion half of closing that loop: it parses the two capture formats
into one normalized :class:`PowerCapture` timeline of interval energy
samples, which the attribution layer (:func:`repro_torch.obs.report.
attribute_energy`) splits across trace spans and the calibration layer
(:func:`repro_torch.control.calibrate.samples_from_capture`) re-fits power
models from.

Like the rest of ``repro_torch.obs`` this module imports nothing from the
repro stack: power models arrive duck-typed (anything with
``busy_watts(ctype, freq)`` / ``idle_watts(ctype)``), core types are the
plain ``"B"`` / ``"L"`` string convention, and trace events are the
loaded Chrome dicts ``repro_torch.obs.export.load_trace`` returns.

Capture formats
---------------

**RAPL log** (``parse_rapl_log``): what a sysfs poller writes — one
monotonically wrapping cumulative-µJ counter reading per line, mirroring
``/sys/class/powercap/intel-rapl:*/energy_uj``::

    # rapl v1
    # domain package max_energy_uj=262143328850
    0.000000 package 262143328000
    0.500000 package 1057300

  - lines are ``<t_seconds> <domain> <energy_uj>`` (a 2-field line
    ``<t> <uj>`` is read as domain ``package``);
  - the counter **wraps** at ``max_energy_uj`` (from the domain header;
    default :data:`DEFAULT_RAPL_MAX_UJ`): a negative delta between
    consecutive readings is un-wrapped by adding the range, exactly the
    correction the kernel's own energy accounting applies;
  - domain names are normalized: a trailing socket index is stripped
    (``package-0`` -> ``package``).

**powermetrics** (``parse_powermetrics``): the text blocks macOS
``powermetrics`` prints — one block per sampling interval with
``<Name> Power: <n> mW`` lines. Time advances by each block's
``(NNNms elapsed)`` header; fields may be missing per block (the tool
omits rails that read zero, and users filter samplers), which simply
leaves a gap in that domain's timeline. Cluster rails are normalized to
the repo's core types: ``P-Cluster`` -> ``big``, ``E-Cluster`` ->
``little``.

Both parsers return interval samples (energy over ``[t0, t1)``), the
faithful representation of what the counters measure — RAPL gives energy
*between* reads, powermetrics average power *over* a block.

Synthetic captures
------------------

:func:`synthesize_rapl_log` / :func:`synthesize_powermetrics` fabricate
byte-parseable capture files from a known power model and a scripted
:class:`UtilizationWindow` schedule (including a forced RAPL counter
wraparound), so CI exercises the whole ingestion -> attribution -> refit
loop without any hardware. ``windows_from_schedule`` pairs the parsed
energies with the schedule's ground-truth busy/alloc core-seconds;
``capture_windows_from_trace`` does the same from a real trace's frame
spans — both yield :class:`CaptureWindow` records that
``repro_torch.control.calibrate.samples_from_capture`` turns into
least-squares rows.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Mapping, Sequence

BIG = "B"
LITTLE = "L"

#: Default RAPL counter range (µJ) when the log carries no domain header;
#: the common package-domain ``max_energy_range_uj`` on recent parts.
DEFAULT_RAPL_MAX_UJ = 262_143_328_850

# powermetrics rail name -> normalized capture domain
_PM_DOMAINS = {
    "p-cluster": "big",
    "e-cluster": "little",
    "cpu": "cpu",
    "gpu": "gpu",
    "ane": "ane",
    "dram": "dram",
    "package": "package",
    "combined": "package",
}


@dataclasses.dataclass(frozen=True)
class PowerSample:
    """Energy measured over one capture interval ``[t0, t1)``."""

    t0: float
    t1: float
    energy_j: float
    domain: str = "package"

    def __post_init__(self):
        if self.t1 <= self.t0:
            raise ValueError("sample interval must have positive length")
        if self.energy_j < 0:
            raise ValueError("interval energy must be non-negative")

    @property
    def dt(self) -> float:
        return self.t1 - self.t0

    @property
    def watts(self) -> float:
        return self.energy_j / self.dt


class PowerCapture:
    """A normalized multi-domain power timeline of interval samples.

    Samples are grouped per domain, sorted, and must not overlap within
    a domain (gaps are fine — powermetrics omits fields per block).
    ``energy_between`` integrates a domain pro-rata over partial overlap,
    which is exact for counters that are themselves interval-averaged.
    """

    def __init__(self, samples: Iterable[PowerSample]):
        by_domain: dict[str, list[PowerSample]] = {}
        for s in samples:
            by_domain.setdefault(s.domain, []).append(s)
        for domain, series in by_domain.items():
            series.sort(key=lambda s: s.t0)
            for a, b in zip(series, series[1:]):
                if b.t0 < a.t1 - 1e-9:
                    raise ValueError(
                        f"overlapping samples in domain {domain!r} at "
                        f"t={b.t0:.6f}")
        self._series = {d: tuple(s) for d, s in sorted(by_domain.items())}

    @property
    def domains(self) -> tuple[str, ...]:
        return tuple(self._series)

    def series(self, domain: str) -> tuple[PowerSample, ...]:
        return self._series.get(domain, ())

    @property
    def extent(self) -> tuple[float, float]:
        """(earliest t0, latest t1) across every domain; (0, 0) if empty."""
        starts = [s[0].t0 for s in self._series.values() if s]
        ends = [s[-1].t1 for s in self._series.values() if s]
        if not starts:
            return (0.0, 0.0)
        return (min(starts), max(ends))

    def _resolve(self, domain: str | None) -> tuple[str, ...]:
        """Default-domain policy: an explicit domain wins; otherwise
        ``package``, then ``cpu``, then the big+little cluster pair, then
        a lone domain — never a blind sum that double-counts package and
        cluster rails."""
        if domain is not None:
            if domain not in self._series:
                raise KeyError(
                    f"domain {domain!r} not captured (have "
                    f"{list(self._series)})")
            return (domain,)
        for pref in ("package", "cpu"):
            if pref in self._series:
                return (pref,)
        if "big" in self._series and "little" in self._series:
            return ("big", "little")
        if len(self._series) == 1:
            return tuple(self._series)
        raise ValueError(
            f"ambiguous default domain among {list(self._series)}; pass "
            f"domain= explicitly")

    def energy_between(self, t0: float, t1: float,
                       domain: str | None = None) -> float:
        """Measured joules over ``[t0, t1)`` (pro-rata partial overlap)."""
        if t1 <= t0:
            return 0.0
        total = 0.0
        for d in self._resolve(domain):
            for s in self._series[d]:
                lo, hi = max(s.t0, t0), min(s.t1, t1)
                if hi > lo:
                    total += s.energy_j * (hi - lo) / s.dt
        return total

    def total_energy(self, domain: str | None = None) -> float:
        return sum(s.energy_j for d in self._resolve(domain)
                   for s in self._series[d])

    def avg_watts(self, domain: str | None = None) -> float:
        t0, t1 = self.extent
        if t1 <= t0:
            return 0.0
        return self.energy_between(t0, t1, domain) / (t1 - t0)

    def rebase(self, t0: float = 0.0) -> "PowerCapture":
        """Shift every timestamp so the capture extent starts at ``t0`` —
        the usual alignment step before attributing against a trace whose
        exporter normalized its own epoch to zero."""
        start, _ = self.extent
        shift = t0 - start
        return PowerCapture(
            PowerSample(s.t0 + shift, s.t1 + shift, s.energy_j, s.domain)
            for series in self._series.values() for s in series)


# ------------------------------------------------------------------ parsers
def _normalize_rapl_domain(name: str) -> str:
    # package-0 / package-1 -> package; intel-rapl:0 path leaves just the
    # leaf name in practice, so only the socket suffix needs stripping
    return re.sub(r"-\d+$", "", name.strip().lower())


def parse_rapl_log(text: str) -> PowerCapture:
    """Parse a RAPL cumulative-counter log (module docstring format) into
    a :class:`PowerCapture`, un-wrapping counter rollovers per domain."""
    max_uj: dict[str, int] = {}
    last: dict[str, tuple[float, int]] = {}
    samples: list[PowerSample] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = re.match(r"#\s*domain\s+(\S+)\s+max_energy_uj=(\d+)", line)
            if m:
                max_uj[_normalize_rapl_domain(m.group(1))] = int(m.group(2))
            continue
        parts = line.split()
        if len(parts) == 2:
            t_str, uj_str = parts
            domain = "package"
        elif len(parts) == 3:
            t_str, domain, uj_str = parts
            domain = _normalize_rapl_domain(domain)
        else:
            raise ValueError(f"rapl log line {lineno}: expected "
                             f"'<t> [domain] <energy_uj>', got {raw!r}")
        t, uj = float(t_str), int(uj_str)
        prev = last.get(domain)
        if prev is not None:
            t_prev, uj_prev = prev
            if t <= t_prev:
                raise ValueError(
                    f"rapl log line {lineno}: non-increasing timestamp "
                    f"for domain {domain!r}")
            delta = uj - uj_prev
            if delta < 0:  # counter wrapped between reads
                delta += max_uj.get(domain, DEFAULT_RAPL_MAX_UJ)
            samples.append(PowerSample(t_prev, t, delta * 1e-6, domain))
        last[domain] = (t, uj)
    return PowerCapture(samples)


_PM_HEADER = re.compile(
    r"\*\*\*\s*Sampled system activity.*\(([\d.]+)\s*ms elapsed\)")
_PM_POWER = re.compile(
    r"^\s*([A-Za-z][A-Za-z0-9 -]*?)\s+Power:\s+([\d.]+)\s*mW\s*$")


def parse_powermetrics(text: str) -> PowerCapture:
    """Parse a macOS ``powermetrics`` text capture into a
    :class:`PowerCapture`. Time starts at 0 and advances by each block's
    elapsed header; rails missing from a block leave a gap in that
    domain's timeline (no sample is fabricated)."""
    samples: list[PowerSample] = []
    t = 0.0
    elapsed_s = None
    block_t0 = 0.0
    for raw in text.splitlines():
        header = _PM_HEADER.search(raw)
        if header:
            block_t0 = t
            elapsed_s = float(header.group(1)) / 1e3
            if elapsed_s <= 0:
                raise ValueError("powermetrics block with non-positive "
                                 "elapsed time")
            t += elapsed_s
            continue
        if elapsed_s is None:
            continue  # preamble before the first block
        m = _PM_POWER.match(raw)
        if not m:
            continue
        rail, mw = m.group(1).strip().lower(), float(m.group(2))
        domain = _PM_DOMAINS.get(rail, rail.replace(" ", "-"))
        samples.append(PowerSample(
            block_t0, block_t0 + elapsed_s, mw * 1e-3 * elapsed_s, domain))
    return PowerCapture(samples)


# ------------------------------------------------------ synthetic captures
@dataclasses.dataclass(frozen=True)
class UtilizationWindow:
    """Ground truth for one synthetic capture window: per-core-type
    utilization in [0, 1] on ``n_big``/``n_little`` allocated cores at
    DVFS levels ``f_big``/``f_little`` for ``dt_s`` seconds."""

    dt_s: float
    u_big: float = 0.0
    u_little: float = 0.0
    n_big: int = 4
    n_little: int = 4
    f_big: float = 1.0
    f_little: float = 1.0

    def __post_init__(self):
        if self.dt_s <= 0:
            raise ValueError("window duration must be positive")
        if not (0.0 <= self.u_big <= 1.0 and 0.0 <= self.u_little <= 1.0):
            raise ValueError("utilizations must be in [0, 1]")
        if self.n_big < 0 or self.n_little < 0:
            raise ValueError("core counts must be non-negative")
        if self.f_big <= 0 or self.f_little <= 0:
            raise ValueError("DVFS levels must be positive")

    def alloc_s(self) -> dict[str, float]:
        """Allocated core-seconds per core type."""
        return {BIG: self.n_big * self.dt_s,
                LITTLE: self.n_little * self.dt_s}

    def busy_s(self) -> dict[tuple[str, float], float]:
        """Busy core-seconds per (core type, DVFS level)."""
        return {(BIG, self.f_big): self.u_big * self.n_big * self.dt_s,
                (LITTLE, self.f_little):
                    self.u_little * self.n_little * self.dt_s}

    def watts(self, power) -> float:
        """Model draw of the window: busy cores at static + dynamic·f³,
        allocated-but-idle cores at static — the same decomposition
        ``repro_torch.energy.account`` charges."""
        w = self.n_big * (
            self.u_big * power.busy_watts(BIG, self.f_big)
            + (1.0 - self.u_big) * power.idle_watts(BIG))
        w += self.n_little * (
            self.u_little * power.busy_watts(LITTLE, self.f_little)
            + (1.0 - self.u_little) * power.idle_watts(LITTLE))
        return w

    def type_watts(self, power) -> dict[str, float]:
        """The same draw split per core type (for per-cluster rails)."""
        return {
            BIG: self.n_big * (
                self.u_big * power.busy_watts(BIG, self.f_big)
                + (1.0 - self.u_big) * power.idle_watts(BIG)),
            LITTLE: self.n_little * (
                self.u_little * power.busy_watts(LITTLE, self.f_little)
                + (1.0 - self.u_little) * power.idle_watts(LITTLE)),
        }


def _schedule_edges(windows: Sequence[UtilizationWindow],
                    t0: float) -> list[float]:
    edges = [t0]
    for w in windows:
        edges.append(edges[-1] + w.dt_s)
    return edges


def synthesize_rapl_log(
    power,
    windows: Sequence[UtilizationWindow],
    *,
    sample_dt: float = 0.5,
    t0: float = 0.0,
    start_uj: int = 0,
    max_energy_uj: int = DEFAULT_RAPL_MAX_UJ,
    domain: str = "package",
) -> str:
    """Fabricate a parseable RAPL log from ``power`` and a window
    schedule. The counter accumulates the model's per-window draw, read
    every ``sample_dt`` seconds (plus at each window edge, so parsed
    window energies are exact up to µJ rounding). Start the counter near
    ``max_energy_uj`` (e.g. ``start_uj=max_energy_uj - 1000``) to force
    a wraparound mid-capture."""
    if sample_dt <= 0:
        raise ValueError("sample_dt must be positive")
    if not 0 <= start_uj < max_energy_uj:
        raise ValueError("start_uj must lie inside the counter range")
    lines = ["# rapl v1",
             f"# domain {domain} max_energy_uj={max_energy_uj}",
             f"{t0:.6f} {domain} {start_uj}"]
    counter = float(start_uj)
    t = t0
    for w in windows:
        watts = w.watts(power)
        end = t + w.dt_s
        while t < end - 1e-12:
            step = min(sample_dt, end - t)
            counter = (counter + watts * step * 1e6) % max_energy_uj
            t += step
            lines.append(f"{t:.6f} {domain} {int(round(counter))}")
    return "\n".join(lines) + "\n"


def synthesize_powermetrics(
    power,
    windows: Sequence[UtilizationWindow],
    *,
    sample_dt: float = 1.0,
    drop_fields: Mapping[int, Sequence[str]] | None = None,
) -> str:
    """Fabricate a parseable ``powermetrics`` capture: one sampled-
    activity block per ``sample_dt`` tick with P-Cluster / E-Cluster /
    CPU / Package rails from the model. ``drop_fields`` maps block index
    to rail names omitted from that block (the missing-field robustness
    the parser must tolerate)."""
    if sample_dt <= 0:
        raise ValueError("sample_dt must be positive")
    drop = {i: {f.lower() for f in fields}
            for i, fields in (drop_fields or {}).items()}
    blocks = []
    block = 0
    for w in windows:
        tw = w.type_watts(power)
        cpu_mw = (tw[BIG] + tw[LITTLE]) * 1e3
        remaining = w.dt_s
        while remaining > 1e-12:
            step = min(sample_dt, remaining)
            remaining -= step
            dropped = drop.get(block, set())
            lines = [f"*** Sampled system activity "
                     f"(Thu Aug  7 10:00:00 2026 +0000) "
                     f"({step * 1e3:.2f}ms elapsed) ***",
                     "",
                     "**** Processor usage ****",
                     ""]
            for rail, mw in (("E-Cluster", tw[LITTLE] * 1e3),
                             ("P-Cluster", tw[BIG] * 1e3),
                             ("CPU", cpu_mw),
                             ("Package", cpu_mw)):
                if rail.lower() not in dropped:
                    lines.append(f"{rail} Power: {mw:.1f} mW")
            blocks.append("\n".join(lines))
            block += 1
    return "\n\n".join(blocks) + "\n"


# -------------------------------------------------------- capture windows
@dataclasses.dataclass(frozen=True)
class CaptureWindow:
    """One aligned measurement window: what ran (allocated and busy
    core-seconds) against what was drawn (measured joules) — exactly the
    row shape ``repro_torch.control.calibrate.TraceSample`` fits from.

    ``variant`` names the kernel variant whose busy time dominated the
    window ("base" when spans carry no variant annotation), so
    calibration can fit per-variant power/weight figures from a capture
    that sweeps implementations
    (``repro_torch.control.calibrate.samples_from_capture(by_variant=True)``)."""

    t0: float
    t1: float
    alloc_s: Mapping[str, float]
    busy_s: Mapping[tuple[str, float], float]
    energy_j: float
    variant: str = "base"


def windows_from_schedule(
    schedule: Sequence[UtilizationWindow],
    capture: PowerCapture,
    *,
    t0: float = 0.0,
    domain: str | None = None,
) -> list[CaptureWindow]:
    """Pair a scripted schedule's ground-truth busy/alloc core-seconds
    with the *measured* energy a parsed capture read over each window —
    the synthetic arm of the ingestion -> refit loop (and the template
    for hardware runs driven by a known schedule)."""
    edges = _schedule_edges(schedule, t0)
    return [
        CaptureWindow(
            t0=a, t1=b,
            alloc_s=w.alloc_s(),
            busy_s=w.busy_s(),
            energy_j=capture.energy_between(a, b, domain),
        )
        for w, a, b in zip(schedule, edges, edges[1:])
    ]


def capture_windows_from_trace(
    events: Sequence[Mapping],
    capture: PowerCapture,
    stage_info: Mapping[str, Mapping],
    *,
    offset_s: float = 0.0,
    domain: str | None = None,
) -> list[CaptureWindow]:
    """Carve a loaded trace into calibration windows against a capture.

    ``events`` are Chrome dicts (``repro_torch.obs.export.load_trace``);
    control-window spans (``cat="window"``) define the window edges and
    frame spans (``cat="frame"``) the busy time, attributed to (core
    type, DVFS level) through ``stage_info`` — a mapping of stage name to
    ``{"ctype": "B"|"L", "freq": f, "cores": r}`` as built by
    ``repro_torch.control.calibrate.stage_info_from_plan``. Allocation charges
    every stage that processed at least one frame in the window with its
    full ``cores`` for the window length. Capture time is trace time
    plus ``offset_s`` (captures and traces run on different clocks; the
    default assumes both were started together, see ``PowerCapture.
    rebase``). Stages absent from ``stage_info`` are skipped.
    """
    window_spans = sorted(
        (e for e in events
         if e.get("ph") == "X" and e.get("cat") == "window"),
        key=lambda e: e.get("ts", 0.0))
    frame_spans = [e for e in events
                   if e.get("ph") == "X" and e.get("cat") == "frame"]
    out: list[CaptureWindow] = []
    for wspan in window_spans:
        w0 = wspan.get("ts", 0.0) / 1e6
        w1 = w0 + wspan.get("dur", 0.0) / 1e6
        if w1 <= w0:
            continue
        busy: dict[tuple[str, float], float] = {}
        var_busy: dict[str, float] = {}
        active: set[str] = set()
        for e in frame_spans:
            name = e.get("name")
            info = stage_info.get(name)
            if info is None:
                continue
            s0 = e.get("ts", 0.0) / 1e6
            s1 = s0 + e.get("dur", 0.0) / 1e6
            overlap = min(s1, w1) - max(s0, w0)
            if overlap <= 0:
                continue
            key = (info["ctype"], float(info.get("freq", 1.0)))
            busy[key] = busy.get(key, 0.0) + overlap
            # kernel-variant attribution: the span's own annotation wins
            # (runtime workers stamp non-base variants), else the plan's
            variant = (e.get("args") or {}).get("variant") \
                or info.get("variant", "base")
            var_busy[variant] = var_busy.get(variant, 0.0) + overlap
            active.add(name)
        alloc: dict[str, float] = {}
        for name in active:
            info = stage_info[name]
            alloc[info["ctype"]] = alloc.get(info["ctype"], 0.0) \
                + info.get("cores", 1) * (w1 - w0)
        # clamp: scheduler jitter can push span-sum busy a hair over the
        # allocation product; TraceSample rejects busy > alloc
        for (v, f), s in list(busy.items()):
            cap_s = alloc.get(v, 0.0)
            total_v = sum(x for (vv, _), x in busy.items() if vv == v)
            if total_v > cap_s > 0.0:
                busy[(v, f)] = s * cap_s / total_v
        dominant = max(var_busy, key=var_busy.get) if var_busy else "base"
        out.append(CaptureWindow(
            t0=w0, t1=w1, alloc_s=alloc, busy_s=busy,
            energy_j=capture.energy_between(w0 + offset_s, w1 + offset_s,
                                            domain),
            variant=dominant))
    return out
