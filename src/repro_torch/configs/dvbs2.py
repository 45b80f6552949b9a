"""The paper's real-world workload: the DVB-S2 receiver task chain.

Average task latencies (µs) from Table III for both evaluated platforms:
  - Mac Studio (Apple M1 Ultra, 16 P-cores "big" @3.2 GHz, 4 E-cores "little"
    @2 GHz), interframe level 4;
  - X7 Ti (Intel Ultra 9 185H, 6 P-cores "big", 8 E-cores "little"),
    interframe level 8.

Replicability per Table III's "Rep." column. Used to reproduce Table II's
schedules/periods exactly, and as the canonical example chain.
"""
from __future__ import annotations

from repro_torch.core.chain import TaskChain, chain_from_rows
from repro_torch.energy.model import (
    POWER_APPLE_M1_ULTRA,
    POWER_INTEL_ULTRA9_185H,
    PowerModel,
)

# (name, replicable, w_big_mac, w_little_mac, w_big_x7, w_little_x7)
_TASKS = [
    ("Radio.receive",            False,   52.3,  248.3,  131.7,  133.2),
    ("MultAGC1.imultiply",       False,   75.2,  149.9,  138.3,  318.1),
    ("SyncFreqCoarse.sync",      False,   96.4,  496.6,  113.7,  429.0),
    ("FilterMatched.filter1",    False,  318.9,  902.9,  334.8,  711.9),
    ("FilterMatched.filter2",    False,  315.1,  883.2,  329.3,  712.6),
    ("SyncTiming.sync",          False,  950.6, 1468.9, 1341.9, 2387.1),
    ("SyncTiming.extract",       False,   55.5,  106.0,   58.7,  135.1),
    ("MultAGC2.imultiply",       False,   37.1,   75.4,   63.5,  157.4),
    ("SyncFrame.sync1",          False,  361.0, 1064.7,  365.9,  848.1),
    ("SyncFrame.sync2",          False,   52.9,  169.1,   81.1,  197.9),
    ("ScramblerSym.descramble",  True,    16.0,   61.0,   25.1,   65.9),
    ("SyncFreqFineLR.sync",      False,   50.5,  247.1,   54.3,  203.2),
    ("SyncFreqFinePF.sync",      True,    99.2,  597.8,  253.8,  356.2),
    ("FramerPLH.remove",         True,    23.4,   65.1,   47.4,   87.7),
    ("NoiseEst.estimate",        True,    40.5,   65.4,   32.4,   65.4),
    ("ModemQPSK.demodulate",     True,  2257.5, 4838.6, 2123.1, 5742.4),
    ("Interleaver.deinterleave", True,    21.1,   58.4,   29.3,   47.6),
    ("DecoderLDPC.decodeSIHO",   True,   153.2,  506.7,  239.7, 1024.4),
    ("DecoderBCH.decodeHIHO",    True,  3339.9, 7303.5, 6209.0, 8166.2),
    ("ScramblerBin.descramble",  True,   191.7,  464.9,  559.0,  621.8),
    ("SinkBinFile.send",         False,    9.5,   33.3,   34.6,   75.6),
    ("Source.generate",          False,    4.0,   13.6,   16.9,   23.4),
    ("Monitor.check",            True,     9.5,   21.0,    9.2,   20.5),
]

# Table III totals, used as data-integrity checks in the test-suite.
TOTALS = {
    ("mac", "B"): 8530.8,
    ("mac", "L"): 19841.3,
    ("x7", "B"): 12592.5,
    ("x7", "L"): 22530.7,
}

# Platform resources evaluated in Table II: full machine and half machine.
RESOURCES = {
    "mac": {"full": (16, 4), "half": (8, 2)},
    "x7": {"full": (6, 8), "half": (3, 4)},
}

# Expected periods (µs) from Table II per (platform, resources, strategy).
TABLE2_PERIODS = {
    ("mac", (8, 2)): {"herad": 1128.7, "twocatac": 1154.3, "fertac": 1265.6,
                      "otac_b": 1442.9, "otac_l": 11440.0},
    ("mac", (16, 4)): {"herad": 950.6, "twocatac": 950.6, "fertac": 950.6,
                       "otac_b": 950.6, "otac_l": 6470.9},
    ("x7", (3, 4)): {"herad": 2722.1, "twocatac": 2722.1, "fertac": 2867.0,
                     "otac_b": 6209.0, "otac_l": 7490.3},
    ("x7", (6, 8)): {"herad": 1341.9, "twocatac": 1341.9, "fertac": 1552.3,
                     "otac_b": 2867.0, "otac_l": 3745.1},
}

# DVB-S2 frame: K = 14232 info bits per frame at rate 8/9 (MODCOD 2); the
# paper reports information throughput = K * interframe / period.
K_INFO_BITS = 14232.0
INTERFRAME = {"mac": 4, "x7": 8}

# Power models for the evaluated platforms (repro_torch.energy.model presets);
# chain weights are µs, so energies come out in µJ per frame.
POWER = {
    "mac": POWER_APPLE_M1_ULTRA,
    "x7": POWER_INTEL_ULTRA9_185H,
}

# Explicit big/little core-id layout per platform, for the runtime's
# process-worker affinity (repro.pipeline.runtime, ``core_map=``). The
# default low-half-big policy happens to match the M1 Ultra (P-cores
# numbered first), but the X7 Ti's Ultra 9 185H exposes its 6 P-cores as
# 12 hyperthread siblings (0-11) ahead of 8 E-cores (12-19) — an uneven
# split the halves heuristic gets wrong, hence the override.
CORE_MAP = {
    "mac": {"big": tuple(range(0, 16)), "little": tuple(range(16, 20))},
    "x7": {"big": tuple(range(0, 12)), "little": tuple(range(12, 20))},
}


def core_map(platform: str) -> dict:
    """Explicit affinity pools for 'mac' or 'x7' (see ``CORE_MAP``)."""
    try:
        return {cls: list(ids) for cls, ids in CORE_MAP[platform].items()}
    except KeyError:
        raise ValueError(f"unknown platform {platform!r}") from None


def platform_power(platform: str) -> PowerModel:
    """Power model preset for 'mac' or 'x7'."""
    try:
        return POWER[platform]
    except KeyError:
        raise ValueError(f"unknown platform {platform!r}") from None


#: Kernel-variant preset for the DVB-S2 chain: the memory-efficient
#: "chunked" implementation point (two-pass lazy softmax shape — see
#: repro.kernels.flash_attention.chunked). Multipliers are per-core-type
#: weight factors vs the base implementation, representative of the
#: bandwidth-vs-vector-work trade that family exhibits: big cores pay
#: the second K read (bandwidth-bound, x1.30), little cores bank the
#: dropped accumulator-rescale vector work (x0.82). Exemplar calibration
#: values for examples/tests — production plans refit them from capture
#: windows via repro.control.calibrate.fit_variant_multipliers.
VARIANT_MULTIPLIERS = {"chunked": (1.30, 0.82)}


def variant_registry(platform: str = "mac"):
    """A ``VariantRegistry`` covering every DVB-S2 task with the
    ``VARIANT_MULTIPLIERS`` preset (same task names on both platforms).
    ``variant_registry(platform).spec_for(dvbs2_chain(platform))`` is the
    resolved spec the 4-axis planners consume."""
    from repro_torch.core.variants import VariantRegistry

    reg = VariantRegistry()
    for name, (big, little) in VARIANT_MULTIPLIERS.items():
        for task in dvbs2_chain(platform).names:
            reg.register(task, name, big=big, little=little)
    return reg


def dvbs2_chain(platform: str = "mac") -> TaskChain:
    """The 23-task DVB-S2 receiver chain for 'mac' or 'x7'."""
    if platform == "mac":
        rows = [(n, r, wb, wl) for (n, r, wb, wl, _, _) in _TASKS]
    elif platform == "x7":
        rows = [(n, r, wb, wl) for (n, r, _, _, wb, wl) in _TASKS]
    else:
        raise ValueError(f"unknown platform {platform!r}")
    return chain_from_rows(rows)


def throughput_mbps(period_us: float, platform: str) -> float:
    """Information throughput in Mb/s for a given period (µs)."""
    frames_per_s = 1e6 / period_us * INTERFRAME[platform]
    return frames_per_s * K_INFO_BITS / 1e6


def budget_presets(platform: str, resources: str = "half",
                   horizon_s: float = 9.0) -> dict:
    """Scenario power budgets sized from the platform's own frontier.

    For the governor scenarios (repro_torch.control) the interesting caps are
    relative: between two frontier points a cap forces a specific re-plan,
    below the frugalest point it is infeasible. These presets compute the
    (period, energy) frontier of the chosen platform/resources and place
    caps at its high / mid / low watt levels (with a few % headroom so the
    pinned plan is admissible):

      - ``"constant"``: the high cap — steady state, no trigger;
      - ``"battery"``:  drain-to-empty over ``horizon_s`` seconds stepping
        high → mid → low as the charge falls (>= 2 forced re-plans);
      - ``"metered_battery"``: the same capacity and levels, but closed
        on the governor's *measured* energy (``MeteredBatteryBudget``):
        the open-loop ``drain_w`` only seeds the projection, and each
        call returns a fresh stateful instance;
      - ``"thermal"``:  high → mid at ``horizon_s/3``, recovering at
        ``2 * horizon_s / 3``.

    Returns ``{"constant", "battery", "metered_battery", "thermal"}``
    plus ``"_levels"``, the (hi, mid, low) watt triple the traces were
    built from.
    """
    from repro_torch.control.budget import (
        BatteryBudget,
        ConstantBudget,
        MeteredBatteryBudget,
        ThermalThrottleBudget,
    )
    from repro_torch.energy.pareto import pareto_frontier

    chain = dvbs2_chain(platform)
    power = platform_power(platform)
    b, l = RESOURCES[platform][resources]
    front = pareto_frontier(chain, b, l, power)
    watts = [pt.energy / pt.period for pt in front]
    hi = watts[0] * 1.05
    mid = watts[min(len(watts) - 1, len(watts) // 3)] * 1.02
    low = watts[min(len(watts) - 1, 2 * len(watts) // 3)] * 1.02
    return {
        "constant": ConstantBudget(hi),
        "battery": BatteryBudget(
            capacity_j=hi * horizon_s, drain_w=hi,
            levels=((0.65, hi), (0.35, mid), (0.0, low))),
        "metered_battery": MeteredBatteryBudget(
            capacity_j=hi * horizon_s, drain_w=hi,
            levels=((0.65, hi), (0.35, mid), (0.0, low))),
        "thermal": ThermalThrottleBudget(
            nominal_w=hi, throttled_w=mid,
            t_throttle=horizon_s / 3.0, t_recover=2.0 * horizon_s / 3.0),
        "_levels": (hi, mid, low),
    }


def serving_preset(platform: str, resources: str = "half",
                   slo_factor: float = 1.05) -> dict:
    """SLO-governed serving scenario preset (docs/serving.md).

    Sizes a per-step latency SLO off the platform's own frontier: the
    target is a mid-frontier period (index ``len(front) // 3``) with
    ``slo_factor`` headroom, so the *minimum-energy* point meeting the
    SLO sits strictly below max-performance on the energy axis — the gap
    the governed serving arm must bank versus the max-perf fallback —
    and the constant cap clears the fastest point's draw by a few %, so
    max-performance stays admissible as the EAPS fallback.

    Returns ``{"chain", "power", "b", "l", "frontier", "slo_period",
    "cap_w", "budget"}`` — everything a ``Governor(slo_period=...)``
    plus an ``AdmissionPlanner`` over the same frontier needs.
    """
    from repro_torch.control.budget import ConstantBudget
    from repro_torch.energy.pareto import pareto_frontier

    chain = dvbs2_chain(platform)
    power = platform_power(platform)
    b, l = RESOURCES[platform][resources]
    front = pareto_frontier(chain, b, l, power)
    slo_period = front[min(len(front) - 1, len(front) // 3)].period \
        * slo_factor
    cap_w = front[0].energy / front[0].period * 1.05
    return {
        "chain": chain,
        "power": power,
        "b": b,
        "l": l,
        "frontier": front,
        "slo_period": slo_period,
        "cap_w": cap_w,
        "budget": ConstantBudget(cap_w),
    }
