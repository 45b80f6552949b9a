"""Power models for heterogeneous big/little processors.

The model follows the classic CMOS decomposition used by the related
energy-aware scheduling literature (Gupta et al., arXiv:1105.3748; Mack et
al., arXiv:2112.08980): a core of type v draws

    P_idle(v)    = static_watts                      (allocated but waiting)
    P_busy(v, f) = static_watts + dynamic_watts * f**3   (executing at
                   normalized DVFS frequency f, latency scaled by 1/f)

``dynamic_watts`` is calibrated at the nominal frequency f = 1. The cubic
law is the standard P_dyn = C V**2 f with V roughly proportional to f.

Units are free: watts times the chain's time unit gives the energy unit
(the DVB-S2 tables are in µs, so energies come out in µJ).

The per-platform presets below are order-of-magnitude estimates assembled
from public per-core package-power measurements of the paper's four
evaluated platform families (Apple M1 Ultra, Intel Core Ultra 9 185H, an
ARM big.LITTLE part, an AMD Zen4/Zen4c hybrid). They are meant for
*relative* big-vs-little trade-off studies, not absolute joule claims —
see docs/energy.md for the calibration story.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.chain import BIG, LITTLE, TaskChain
from repro_torch.core.dvfs import scale_chain as _scale_chain

# Accepted spellings for per-core-type frequency-ladder keys.
_CTYPE_ALIASES = {BIG: BIG, LITTLE: LITTLE, "big": BIG, "little": LITTLE}


def _normalize_ladder(levels) -> tuple[float, ...]:
    levels = tuple(float(f) for f in levels)
    if not levels or any(f <= 0 for f in levels):
        raise ValueError("freq_levels must be positive")
    return levels


def normalize_freq_levels(
    freq_levels,
) -> tuple[float, ...] | dict[str, tuple[float, ...]]:
    """Validate a frequency-ladder spec: either one shared tuple of
    positive normalized levels, or a per-core-type mapping with keys
    'B'/'L' (aliases 'big'/'little') covering both types."""
    if isinstance(freq_levels, Mapping):
        ladders: dict[str, tuple[float, ...]] = {}
        for key, levels in freq_levels.items():
            ctype = _CTYPE_ALIASES.get(key)
            if ctype is None:
                raise ValueError(
                    f"unknown core type {key!r} in freq_levels (use "
                    f"'B'/'L' or 'big'/'little')")
            ladders[ctype] = _normalize_ladder(levels)
        missing = {BIG, LITTLE} - ladders.keys()
        if missing:
            raise ValueError(
                f"per-core-type freq_levels must cover both types; "
                f"missing {sorted(missing)}")
        return ladders
    return _normalize_ladder(freq_levels)


@dataclasses.dataclass(frozen=True)
class CoreTypePower:
    """Static (= idle) and dynamic watts of one core type."""

    static_watts: float
    dynamic_watts: float

    def __post_init__(self):
        if self.static_watts < 0 or self.dynamic_watts < 0:
            raise ValueError("power draws must be non-negative")

    def busy_watts(self, freq: float = 1.0) -> float:
        """Power while executing at normalized DVFS frequency ``freq``."""
        return self.static_watts + self.dynamic_watts * freq**3

    def idle_watts(self) -> float:
        """Power of an allocated core that is waiting for work."""
        return self.static_watts


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Per-core-type power model with optional DVFS frequency levels.

    ``freq_levels`` are normalized frequencies (1.0 = nominal). Running at
    level f multiplies dynamic power by f**3 and task latency by 1/f.
    The ladder is either one tuple shared by both core types (the
    backward-compatible default) or a per-core-type mapping such as
    ``{"big": (0.5, 1.0), "little": (0.75, 1.0)}`` — real hybrid parts
    expose different OPP tables per cluster. :meth:`levels_for` resolves
    the ladder of one type either way.
    """

    name: str
    big: CoreTypePower
    little: CoreTypePower
    freq_levels: tuple[float, ...] | Mapping[str, tuple[float, ...]] = (1.0,)

    def __post_init__(self):
        object.__setattr__(self, "freq_levels",
                           normalize_freq_levels(self.freq_levels))

    def levels_for(self, v: str) -> tuple[float, ...]:
        """The DVFS ladder of core type ``v`` ('B' or 'L')."""
        if isinstance(self.freq_levels, Mapping):
            ctype = _CTYPE_ALIASES.get(v)
            if ctype is None:
                raise ValueError(f"unknown core type {v!r}")
            return self.freq_levels[ctype]
        return self.freq_levels

    def core(self, v: str) -> CoreTypePower:
        if v == BIG:
            return self.big
        if v == LITTLE:
            return self.little
        raise ValueError(f"unknown core type {v!r}")

    def busy_watts(self, v: str, freq: float = 1.0) -> float:
        return self.core(v).busy_watts(freq)

    def idle_watts(self, v: str) -> float:
        return self.core(v).idle_watts()

    def scale_chain(self, chain: TaskChain, f_big: float = 1.0,
                    f_little: float = 1.0) -> TaskChain:
        """DVFS view of a chain: task latency scales as 1/f per core type.

        Delegates to :func:`repro_torch.core.dvfs.scale_chain` (the single
        source of the 1/f latency rule); kept as a method for the
        historical call sites. Returns ``chain`` itself at nominal
        frequencies.
        """
        return _scale_chain(chain, f_big, f_little)

    @classmethod
    def from_device_classes(cls, system, idle_fraction: float = 0.1,
                            name: str = "device-classes",
                            freq_levels: tuple[float, ...]
                            | Mapping[str, tuple[float, ...]] = (1.0,),
                            ) -> "PowerModel":
        """Build a model from a planner HeterogeneousSystem.

        ``DeviceClass.watts`` is the busy draw; ``idle_fraction`` of it is
        attributed to static (idle) power, the rest to dynamic.
        ``freq_levels`` opts the model into DVFS (e.g. for the planner's
        ``freqherad`` strategy) — one shared tuple or a per-core-type
        mapping; the default keeps it nominal-only.
        """
        def split(watts: float) -> CoreTypePower:
            return CoreTypePower(static_watts=watts * idle_fraction,
                                 dynamic_watts=watts * (1.0 - idle_fraction))

        return cls(name=name, big=split(system.big.watts),
                   little=split(system.little.watts),
                   freq_levels=freq_levels)


# --------------------------------------------------------------- presets
# Apple M1 Ultra (Mac Studio): Firestorm P-cores vs Icestorm E-cores.
POWER_APPLE_M1_ULTRA = PowerModel(
    name="apple-m1-ultra",
    big=CoreTypePower(static_watts=0.35, dynamic_watts=4.25),
    little=CoreTypePower(static_watts=0.06, dynamic_watts=0.84),
    freq_levels=(0.6, 0.8, 1.0),
)

# Intel Core Ultra 9 185H (Meteor Lake): Redwood Cove P vs Crestmont E.
POWER_INTEL_ULTRA9_185H = PowerModel(
    name="intel-ultra9-185h",
    big=CoreTypePower(static_watts=0.60, dynamic_watts=5.40),
    little=CoreTypePower(static_watts=0.20, dynamic_watts=1.55),
    freq_levels=(0.5, 0.75, 1.0),
)

# Generic ARM big.LITTLE (Cortex-X/A7x class big vs A5x class little).
POWER_ARM_BIG_LITTLE = PowerModel(
    name="arm-big-little",
    big=CoreTypePower(static_watts=0.25, dynamic_watts=2.15),
    little=CoreTypePower(static_watts=0.05, dynamic_watts=0.40),
    freq_levels=(0.5, 0.75, 1.0),
)

# AMD hybrid (Zen 4 "big" vs Zen 4c compact cores, Ryzen AI 9 class).
POWER_AMD_RYZEN_AI9 = PowerModel(
    name="amd-ryzen-ai9",
    big=CoreTypePower(static_watts=0.55, dynamic_watts=5.05),
    little=CoreTypePower(static_watts=0.30, dynamic_watts=2.20),
    freq_levels=(0.5, 0.75, 1.0),
)

# A brand-neutral default for synthetic studies: big:little busy ~ 1:0.35,
# matching Solution.energy_proxy's historical default ratio.
DEFAULT_POWER = PowerModel(
    name="default",
    big=CoreTypePower(static_watts=0.10, dynamic_watts=0.90),
    little=CoreTypePower(static_watts=0.03, dynamic_watts=0.32),
)

# The same synthetic default with a generic three-step DVFS ladder; used
# as the fallback model of the "freqherad" strategy registration.
DEFAULT_DVFS_POWER = PowerModel(
    name="default-dvfs",
    big=DEFAULT_POWER.big,
    little=DEFAULT_POWER.little,
    freq_levels=(0.5, 0.75, 1.0),
)

PLATFORM_POWER = {
    "m1_ultra": POWER_APPLE_M1_ULTRA,
    "intel_185h": POWER_INTEL_ULTRA9_185H,
    "arm": POWER_ARM_BIG_LITTLE,
    "amd": POWER_AMD_RYZEN_AI9,
}
