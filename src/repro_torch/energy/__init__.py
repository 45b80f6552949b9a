"""Energy subsystem: power models, energy accounting, and the
(period, energy) bi-objective view of the paper's scheduling problem.

Layers:
  - :mod:`repro_torch.energy.model`   — per-core-type power models (static/idle +
    dynamic watts, optional DVFS frequency levels) with presets for the
    paper's four platforms (Apple, Intel, ARM, AMD);
  - :mod:`repro_torch.energy.account` — exact per-schedule energy accounting for
    any :class:`repro_torch.core.Solution` or frequency-annotated
    :class:`repro_torch.core.dvfs.FreqSolution` (busy energy from per-stage
    utilization, idle energy for allocated-but-waiting cores);
  - :mod:`repro_torch.energy.pareto`  — (period, energy) Pareto frontiers from a
    single HeRAD DP table, the energy-constrained ``energad`` strategy
    (minimum energy subject to a period bound), the DVFS-aware
    ``freqherad`` strategy plus the frequency-swept ``dvfs_frontier``,
    and the 4-axis ``variant_herad`` / ``variant_frontier`` pair that
    adds the kernel-variant dimension from :mod:`repro_torch.core.variants`.

Units: chain weights set the time unit (µs for the DVB-S2 tables), powers
are watts, so energies come out in watt x time-unit (µJ per frame).
"""
from .model import (  # noqa: F401
    CoreTypePower,
    PowerModel,
    normalize_freq_levels,
    DEFAULT_DVFS_POWER,
    DEFAULT_POWER,
    POWER_AMD_RYZEN_AI9,
    POWER_APPLE_M1_ULTRA,
    POWER_ARM_BIG_LITTLE,
    POWER_INTEL_ULTRA9_185H,
    PLATFORM_POWER,
)
from .account import (  # noqa: F401
    EnergyReport,
    StageEnergy,
    energy,
    energy_report,
)
from .pareto import (  # noqa: F401
    CandidateTable,
    ParetoPoint,
    dvfs_frontier,
    energad,
    freqherad,
    min_energy_under_period,
    min_energy_under_period_freq,
    min_energy_under_period_freq_batch,
    min_energy_under_period_freq_reference,
    min_energy_under_period_reference,
    min_energy_meeting_deadline,
    min_period_under_power,
    pareto_frontier,
    sweep_budgets,
    sweep_budgets_freq,
    sweep_budgets_freq_reference,
    sweep_budgets_reference,
    sweep_budgets_variant,
    sweep_budgets_variant_reference,
    variant_frontier,
    variant_herad,
)
