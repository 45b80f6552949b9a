"""Adaptive runtime control, the port's counterpart of ``repro.control``:
time-varying power caps (:mod:`~repro_torch.control.budget`), the
closed-loop :class:`~repro_torch.control.governor.Governor` that re-plans
off the (period, energy) Pareto frontier, and the SLO-governed serving
scenario (:mod:`~repro_torch.control.sim`).

Not carried yet: ``calibrate`` (power-model fitting from measured
traces) and the sleep-simulated pipeline scenarios (``run_scenario`` and
its sleeping stage functions), which need the pipeline runtime.
"""
from .budget import (  # noqa: F401
    BatteryBudget,
    ConstantBudget,
    MeteredBatteryBudget,
    PowerBudget,
    ScriptedBudget,
    ThermalThrottleBudget,
)
from .governor import (  # noqa: F401
    ActivePlan,
    Governor,
    GovernorEvent,
    Observation,
)
from .sim import (  # noqa: F401
    Arrival,
    ServeScenarioResult,
    ServeWindowRecord,
    bursty_arrivals,
    diurnal_arrivals,
    run_serve_scenario,
)
