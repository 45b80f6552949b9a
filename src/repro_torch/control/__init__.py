"""Adaptive runtime control, the port's counterpart of ``repro.control``:
time-varying power caps (:mod:`~repro_torch.control.budget`),
least-squares fitting of power models and kernel-variant multipliers from
measured runs (:mod:`~repro_torch.control.calibrate`), the closed-loop
:class:`~repro_torch.control.governor.Governor` that re-plans off the
(period, energy) Pareto frontier and swaps the schedule into
:class:`~repro_torch.pipeline.runtime.StreamingPipelineRuntime`, and the
scenario harness (:mod:`~repro_torch.control.sim`): the sleep-simulated
pipeline scenarios (``run_scenario``) and the SLO-governed serving
scenario (``run_serve_scenario``).
"""
from .budget import (  # noqa: F401
    BatteryBudget,
    ConstantBudget,
    MeteredBatteryBudget,
    PowerBudget,
    ScriptedBudget,
    ThermalThrottleBudget,
)
from .calibrate import (  # noqa: F401
    TraceSample,
    VariantObservation,
    fit_power_model,
    fit_report,
    fit_variant_multipliers,
    observations_from_run,
    sample_from_run,
    samples_from_capture,
    stage_info_from_plan,
    synthesize_samples,
)
from .governor import (  # noqa: F401
    ActivePlan,
    Governor,
    GovernorEvent,
    Observation,
)
from .sim import (  # noqa: F401
    Arrival,
    ScenarioResult,
    ServeScenarioResult,
    ServeWindowRecord,
    WindowRecord,
    bursty_arrivals,
    diurnal_arrivals,
    run_scenario,
    run_serve_scenario,
    sleep_stage_builder,
)
