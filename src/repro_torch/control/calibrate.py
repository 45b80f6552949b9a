"""Trace-fitted power calibration: recover a PowerModel from runtime traces.

The presets in ``repro_torch.energy.model`` are order-of-magnitude estimates;
this module fits watts to what the platform actually draws. The model is
linear in its unknowns, so ordinary least squares does it exactly: a
measurement window of length ``T`` with
per-core-type allocated core-seconds ``A_v``, busy core-seconds ``B_v(f)``
at DVFS level ``f``, and measured energy ``E`` satisfies

    E = sum_v  A_v * static_v  +  (sum_f B_v(f) * f^3) * dynamic_v

(busy time at level f draws static + dynamic * f^3; allocated-but-idle
time draws static — exactly the decomposition ``repro_torch.energy.account``
charges, so a fitted model plugs straight back into the frontier
machinery). Four unknowns (static/dynamic x big/little), one row per
window: a handful of windows at different utilizations pins them down.

Sources of samples:

  - :func:`sample_from_run` converts a ``StreamingPipelineRuntime.run()``
    stats dict (its per-replica ``busy_s`` map and measured ``energy_j``)
    into a :class:`TraceSample` — the "recorded trace" path;
  - :func:`samples_from_capture` converts aligned measurement windows
    from a **real power capture** (RAPL ``energy_uj`` logs or macOS
    ``powermetrics``, parsed and aligned by :mod:`repro_torch.obs.power` —
    ``windows_from_schedule`` / ``capture_windows_from_trace``) — the
    measured-hardware path;
  - :func:`synthesize_samples` fabricates windows from a known model at
    scripted utilizations (+ optional noise) — the round-trip test path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.chain import BIG, LITTLE
from repro_torch.energy.model import CoreTypePower, PowerModel

_CLASS_TO_CTYPE = {"big": BIG, "little": LITTLE, BIG: BIG, LITTLE: LITTLE}


@dataclasses.dataclass(frozen=True)
class TraceSample:
    """One measurement window of a power trace.

    ``alloc_s`` maps core type ('B'/'L') to allocated core-seconds over
    the window (replicas x window length); ``busy_s`` maps
    (core type, DVFS level) to busy core-seconds at that level. Busy time
    must not exceed allocated time per type; ``energy_j`` is the measured
    energy of the window in joules."""

    alloc_s: Mapping[str, float]
    busy_s: Mapping[tuple[str, float], float]
    energy_j: float

    def __post_init__(self):
        alloc = {v: float(s) for v, s in self.alloc_s.items()}
        busy = {(v, float(f)): float(s)
                for (v, f), s in self.busy_s.items()}
        if any(s < 0 for s in alloc.values()) \
                or any(s < 0 for s in busy.values()):
            raise ValueError("core-seconds must be non-negative")
        if any(f <= 0 for _, f in busy):
            raise ValueError("DVFS levels must be positive")
        for v in set(v for v, _ in busy):
            total_busy = sum(s for (vv, _), s in busy.items() if vv == v)
            if total_busy > alloc.get(v, 0.0) * (1 + 1e-6) + 1e-9:
                raise ValueError(
                    f"busy core-seconds exceed allocated for type {v!r}")
        if self.energy_j < 0:
            raise ValueError("energy_j must be non-negative")
        object.__setattr__(self, "alloc_s", alloc)
        object.__setattr__(self, "busy_s", busy)

    def busy_total(self, v: str) -> float:
        return sum(s for (vv, _), s in self.busy_s.items() if vv == v)

    def dyn_weight(self, v: str) -> float:
        """The dynamic-watts regressor: sum_f busy_s[v, f] * f**3."""
        return sum(s * f**3 for (vv, f), s in self.busy_s.items() if vv == v)


def sample_from_run(stages, stats: dict) -> TraceSample:
    """Build a :class:`TraceSample` from a runtime ``run()`` result.

    ``stages`` are the runtime's StageSpecs (their ``device_class`` and
    ``replicas`` size the allocation; stage names key the busy map) and
    ``stats`` the dict ``StreamingPipelineRuntime.run`` returned — it must
    contain ``energy_j`` (metered run) plus the standard ``total_s`` /
    ``busy_s`` fields. All busy time is attributed to the nominal level
    (the runtime does not yet simulate per-stage clocks; recorded traces
    with real DVFS residency should build samples directly)."""
    if "energy_j" not in stats:
        raise ValueError("stats lack energy_j — run with a metered runtime "
                         "(from_plan(..., power=...))")
    window = stats["total_s"]
    alloc = {BIG: 0.0, LITTLE: 0.0}
    busy = {(BIG, 1.0): 0.0, (LITTLE, 1.0): 0.0}
    by_stage = {}
    for (name, _ri), s in stats["busy_s"].items():
        by_stage[name] = by_stage.get(name, 0.0) + s
    for spec in stages:
        v = _CLASS_TO_CTYPE[spec.device_class]
        alloc[v] += max(spec.replicas, 1) * window
        busy[(v, 1.0)] += min(by_stage.get(spec.name, 0.0),
                              max(spec.replicas, 1) * window)
    return TraceSample(alloc, busy, stats["energy_j"])


def samples_from_capture(windows: Iterable, by_variant: bool = False):
    """Convert aligned capture windows into :class:`TraceSample` rows.

    ``windows`` are :class:`repro_torch.obs.power.CaptureWindow` records (duck-
    typed: anything with ``alloc_s`` / ``busy_s`` / ``energy_j``) as
    produced by ``windows_from_schedule`` (scripted synthetic or
    hardware captures) or ``capture_windows_from_trace`` (a real trace
    aligned against a capture). Windows with no allocation at all (e.g.
    a capture interval that overlapped no trace activity) carry no
    information for the fit and are skipped.

    ``by_variant=True`` keys the result by the windows' kernel-variant
    annotation instead — ``{variant: [TraceSample, ...]}`` — so a
    capture that sweeps implementations (one plan generation per
    variant) yields one fitting set per variant; windows without an
    annotation land under ``"base"``.
    """
    out: list[TraceSample] = []
    grouped: dict[str, list[TraceSample]] = {}
    for w in windows:
        alloc = {v: s for v, s in w.alloc_s.items() if s > 0.0}
        if not alloc:
            continue
        busy = {k: s for k, s in w.busy_s.items() if s > 0.0}
        sample = TraceSample(alloc, busy, max(float(w.energy_j), 0.0))
        if by_variant:
            grouped.setdefault(getattr(w, "variant", "base") or "base",
                               []).append(sample)
        else:
            out.append(sample)
    return grouped if by_variant else out


def stage_info_from_plan(plan) -> dict[str, dict]:
    """Describe a plan's stages for trace/capture alignment.

    Returns ``{stage_name: {"ctype", "freq", "cores", "variant"}}`` keyed
    by the runtime's stage naming (``s{start}-{end}``), the mapping
    ``repro_torch.obs.power.capture_windows_from_trace`` and
    ``repro_torch.obs.report.attribute_energy`` consume. ``plan`` is anything
    with ``.stages`` of Stage/FreqStage records (a ``Solution`` /
    ``FreqSolution``, or an ``ActivePlan``'s ``point.solution``).
    """
    return {
        f"s{st.start}-{st.end}": {
            "ctype": st.ctype,
            "freq": float(getattr(st, "freq", 1.0)),
            "cores": int(st.cores),
            "variant": getattr(st, "variant", "base"),
        }
        for st in plan.stages
    }


@dataclasses.dataclass(frozen=True)
class VariantObservation:
    """Measured cost of one (kernel variant, core type) combination.

    ``busy_s`` is total busy core-seconds over the observation window(s)
    at DVFS level ``freq``; ``frames`` the frames processed. The nominal
    per-frame work is ``busy_s * freq / frames`` (a stage at level f
    spends w/f wall seconds per frame), which is what multiplier fitting
    compares across variants."""

    variant: str
    ctype: str
    busy_s: float
    frames: int
    freq: float = 1.0

    def __post_init__(self):
        if self.busy_s < 0 or self.frames <= 0 or self.freq <= 0:
            raise ValueError(
                "need busy_s >= 0, frames > 0, freq > 0")

    def work_per_frame(self) -> float:
        """Per-frame busy seconds normalized to the nominal clock."""
        return self.busy_s * self.freq / self.frames


def observations_from_run(stages, stats: dict) -> list[VariantObservation]:
    """Per-(variant, core type) cost observations from a runtime run.

    ``stages`` are the runtime's StageSpecs (their ``variant``,
    ``device_class`` and ``freq`` attribute the busy time), ``stats`` the
    ``StreamingPipelineRuntime.run`` result — ``busy_s`` and
    ``replica_frames`` are summed per stage. One observation per
    (variant, ctype, freq) triple present in the run; stages that
    processed no frame are skipped."""
    acc: dict[tuple[str, str, float], list[float]] = {}
    busy_by_stage: dict[str, float] = {}
    frames_by_stage: dict[str, int] = {}
    for (name, _ri), s in stats.get("busy_s", {}).items():
        busy_by_stage[name] = busy_by_stage.get(name, 0.0) + s
    for (name, _ri), c in stats.get("replica_frames", {}).items():
        frames_by_stage[name] = frames_by_stage.get(name, 0) + c
    for spec in stages:
        frames = frames_by_stage.get(spec.name, 0)
        if frames <= 0:
            continue
        key = (getattr(spec, "variant", "base"),
               _CLASS_TO_CTYPE[spec.device_class],
               float(getattr(spec, "freq", 1.0)) or 1.0)
        cur = acc.setdefault(key, [0.0, 0])
        cur[0] += busy_by_stage.get(spec.name, 0.0)
        cur[1] += frames
    return [
        VariantObservation(variant=k, ctype=v, busy_s=b, frames=n, freq=f)
        for (k, v, f), (b, n) in acc.items() if n > 0
    ]


def fit_variant_multipliers(
    observations: Iterable[VariantObservation],
) -> dict[str, dict[str, float]]:
    """Measured per-variant per-core-type weight multipliers.

    For each variant ``k`` and core type ``v`` with both a variant and a
    base observation, the multiplier is the ratio of nominal per-frame
    work: ``m_k(v) = work_k(v) / work_base(v)`` — the *measured* figure
    the scheduling model's ``w * m_k / f`` composition calls for
    (multiple observations of the same pair are pooled busy/frames-
    weighted). Returns ``{variant: {"B": m, "L": m}}`` for the non-base
    variants; core types never observed under a variant are omitted
    (callers keep the previous — or unit — multiplier there). Raises if
    a variant was observed on a core type the base never ran on: a ratio
    against nothing is not a measurement."""
    pooled: dict[tuple[str, str], list[float]] = {}
    for ob in observations:
        cur = pooled.setdefault((ob.variant, ob.ctype), [0.0, 0])
        cur[0] += ob.busy_s * ob.freq
        cur[1] += ob.frames
    work = {k: b / n for k, (b, n) in pooled.items() if n > 0}
    out: dict[str, dict[str, float]] = {}
    for (variant, ctype), w in work.items():
        if variant == "base":
            continue
        base = work.get(("base", ctype))
        if base is None:
            raise ValueError(
                f"variant {variant!r} observed on type {ctype!r} without "
                "a base observation to ratio against")
        if base <= 0.0 or w <= 0.0:
            continue  # zero-cost windows carry no ratio information
        out.setdefault(variant, {})[ctype] = w / base
    return out


def synthesize_samples(
    power: PowerModel,
    utilizations: Sequence[tuple[float, float]],
    window_s: float = 1.0,
    cores: tuple[int, int] | Sequence[tuple[int, int]] = (4, 4),
    freqs: tuple[float, float] = (1.0, 1.0),
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
) -> list[TraceSample]:
    """Fabricate trace windows from a known model (the round-trip path).

    Each ``(u_big, u_little)`` utilization pair in [0, 1] yields one
    window of ``window_s`` seconds on ``cores = (n_big, n_little)`` cores
    running busy time at per-type levels ``freqs``; ``noise`` is the
    relative sigma of multiplicative Gaussian noise on the energy (0 =
    exact).

    ``cores`` may also be a per-window sequence of (n_big, n_little)
    pairs (cycled if shorter than ``utilizations``). Identifying static
    watts of BOTH core types needs windows whose *allocation* mix varies
    — with one fixed core count the two allocation columns of the
    least-squares system are proportional and the fit is rank-deficient.
    """
    core_seq = [cores] if isinstance(cores[0], int) else list(cores)
    f_big, f_little = freqs
    if rng is None:
        rng = np.random.default_rng(0)
    samples = []
    for i, (u_big, u_little) in enumerate(utilizations):
        if not (0.0 <= u_big <= 1.0 and 0.0 <= u_little <= 1.0):
            raise ValueError("utilizations must be in [0, 1]")
        n_big, n_little = core_seq[i % len(core_seq)]
        alloc = {BIG: n_big * window_s, LITTLE: n_little * window_s}
        busy = {(BIG, f_big): u_big * n_big * window_s,
                (LITTLE, f_little): u_little * n_little * window_s}
        e = 0.0
        for v, f in ((BIG, f_big), (LITTLE, f_little)):
            b = busy[(v, f)]
            e += b * power.busy_watts(v, f) \
                + (alloc[v] - b) * power.idle_watts(v)
        if noise > 0.0:
            e *= float(1.0 + noise * rng.standard_normal())
        samples.append(TraceSample(alloc, busy, max(e, 0.0)))
    return samples


def fit_power_model(
    samples: Iterable[TraceSample],
    name: str = "calibrated",
    freq_levels=None,
    on_degenerate: str = "fallback",
) -> PowerModel:
    """Least-squares fit of (static, dynamic) watts per core type.

    Solves the linear system described in the module docstring with
    ``numpy.linalg.lstsq`` and clamps tiny negative estimates (noise can
    push an unconstrained fit below zero) to 0. Identifying all four
    coefficients needs windows that actually vary utilization *and*
    allocation mix per core type; real captures are routinely degenerate
    (duplicate utilizations, zero-busy idle windows, single-type chains).
    ``on_degenerate`` controls what happens then:

      - ``"fallback"`` (default): solve the rank-deficient system with a
        singular-value-truncated minimum-norm least squares — the energy
        totals are still matched exactly on the observed subspace, the
        unidentifiable directions are pinned at the smallest-magnitude
        (never noise-amplified) solution, and zero-information cases
        (no windows, no allocation) still raise;
      - ``"raise"``: the strict pre-capture behaviour — reject the
        window set with ``ValueError`` so calibration scripts can demand
        a schedule that identifies everything.

    ``freq_levels`` seeds the fitted model's DVFS ladder (default:
    nominal-only)."""
    if on_degenerate not in ("fallback", "raise"):
        raise ValueError("on_degenerate must be 'fallback' or 'raise'")
    rows, energies = [], []
    for s in samples:
        rows.append([s.alloc_s.get(BIG, 0.0), s.dyn_weight(BIG),
                     s.alloc_s.get(LITTLE, 0.0), s.dyn_weight(LITTLE)])
        energies.append(s.energy_j)
    if not rows:
        raise ValueError("need at least one trace window to fit")
    if len(rows) < 2 and on_degenerate == "raise":
        raise ValueError("need at least two trace windows to fit")
    a = np.asarray(rows, dtype=np.float64)
    y = np.asarray(energies, dtype=np.float64)
    # drop all-zero columns (e.g. a platform with no little cores in the
    # trace) and pin their coefficients at 0
    active = np.flatnonzero(np.abs(a).sum(axis=0) > 0.0)
    if len(active) == 0:
        raise ValueError("traces contain no allocation at all")
    rank = np.linalg.matrix_rank(a[:, active])
    if rank < len(active) and on_degenerate == "raise":
        raise ValueError(
            "trace windows are rank-deficient (vary the utilizations "
            "and/or window mix to identify all coefficients)")
    # rcond truncates near-zero singular values: on a full-rank system
    # this is plain OLS; on a degenerate one it yields the minimum-norm
    # solution instead of blowing up along the unidentified directions
    coef = np.zeros(4)
    coef[active], *_ = np.linalg.lstsq(a[:, active], y, rcond=1e-9)
    coef = np.maximum(coef, 0.0)
    return PowerModel(
        name=name,
        big=CoreTypePower(static_watts=float(coef[0]),
                          dynamic_watts=float(coef[1])),
        little=CoreTypePower(static_watts=float(coef[2]),
                             dynamic_watts=float(coef[3])),
        freq_levels=freq_levels if freq_levels is not None else (1.0,),
    )


def fit_report(samples: Sequence[TraceSample], fitted: PowerModel) -> dict:
    """Residual diagnostics of a fit: per-window predicted vs measured
    energy, the relative RMS error, and the worst window."""
    preds, meas = [], []
    for s in samples:
        e = 0.0
        for (v, f), b in s.busy_s.items():
            e += b * fitted.busy_watts(v, f)
        for v, alloc in s.alloc_s.items():
            e += (alloc - s.busy_total(v)) * fitted.idle_watts(v)
        preds.append(e)
        meas.append(s.energy_j)
    preds_a, meas_a = np.asarray(preds), np.asarray(meas)
    scale = np.maximum(np.abs(meas_a), 1e-12)
    rel = np.abs(preds_a - meas_a) / scale
    return {
        "predicted_j": preds,
        "measured_j": meas,
        "rel_rms": float(np.sqrt(np.mean(rel**2))),
        "rel_max": float(rel.max()),
    }
