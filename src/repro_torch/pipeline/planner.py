"""Pipeline planner: the paper's scheduler as a first-class feature, the
port's counterpart of ``repro.pipeline.planner`` (equal to it wherever it
is deterministic).

Maps a model's layer-block chain onto a heterogeneous accelerator system
(two device classes, "big" and "little"),
using FERTAC / 2CATAC / HeRAD to choose the pipeline decomposition, the
per-stage replication, and the device class per stage. This is the direct
transplant of the paper's StreamPU scheduling into LLM serving/training:

  task chain      = [ingest] + per-layer blocks + [head] + [emit]
  w^B / w^L       = analytic roofline step latency per device class
                    max(FLOPs/peak, bytes/bw) per block
  replicable      = stateless across *streams* (layer blocks: yes — a
                    stream's KV/SSM state pins to one replica, exactly like
                    StreamPU's frame-parallel replication); the stream
                    multiplexer / ordered emitter are sequential
  period          = reciprocal throughput (frames == microbatches)

The planner also powers elastic scaling: when the device pool changes
(node failure / preemption), the chain is simply re-scheduled for the new
(b, l) and the runtime re-materializes stages from the checkpoint.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import (
    BIG,
    LITTLE,
    STRATEGIES,
    FreqSolution,
    Solution,
    TaskChain,
)
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    name: str
    peak_flops: float          # FLOP/s (dense bf16)
    hbm_bw: float              # B/s
    count: int
    watts: float = 0.0         # optional: for the energy report


# The reference's default classes, kept as they are so that the port's
# plans equal the reference's; they are not rates of any card the port
# runs on.
BIG_CLASS = DeviceClass("tpu-v5p-class", 459e12, 2765e9, 0, watts=350.0)
LITTLE_CLASS = DeviceClass("tpu-v5e-class", 197e12, 819e9, 0, watts=170.0)

# One NVIDIA H100 80GB HBM3 (SXM): its datasheet dense bf16 rate, HBM3
# bandwidth and 700 W power limit. One card is one class; give it a count
# with ``dataclasses.replace``.
H100_CLASS = DeviceClass("nvidia-h100-80gb-hbm3", 989e12, 3.35e12, 0,
                         watts=700.0)


@dataclasses.dataclass(frozen=True)
class HeterogeneousSystem:
    big: DeviceClass
    little: DeviceClass

    @classmethod
    def default(cls, n_big: int, n_little: int) -> "HeterogeneousSystem":
        return cls(dataclasses.replace(BIG_CLASS, count=n_big),
                   dataclasses.replace(LITTLE_CLASS, count=n_little))


@dataclasses.dataclass(frozen=True)
class BlockCost:
    name: str
    flops: float
    bytes_moved: float
    replicable: bool = True

    def latency(self, dev: DeviceClass) -> float:
        """Roofline step latency (s) of this block on one device."""
        return max(self.flops / dev.peak_flops, self.bytes_moved / dev.hbm_bw)


def _layer_cost(cfg: ModelConfig, tokens: int, mode: str) -> tuple[float, float]:
    """(flops, bytes) of one decoder block for `tokens` tokens per step."""
    d = cfg.d_model
    hq, hkv, hd = max(cfg.n_heads, 1), max(cfg.n_kv_heads, 1), cfg.hd
    if cfg.kind == "ssm" or (cfg.kind == "hybrid"):
        s = cfg.ssm
        di, n = s.d_inner(d), s.d_state
        flops = 2 * tokens * d * (2 * di + 2 * n + s.n_heads(d)) \
            + 2 * tokens * di * n * 2 + 2 * tokens * di * d
        params = d * (2 * di + 2 * n + s.n_heads(d)) + di * d
    else:
        attn_p = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        ff = cfg.moe.d_ff_expert * cfg.moe.top_k * 3 * d if cfg.moe \
            else 3 * d * cfg.d_ff
        flops = 2 * tokens * (attn_p + ff)
        if mode != "decode":
            # quadratic attention term (causal): ~2 * S * tokens * hq * hd
            flops += 2 * tokens * tokens * hq * hd
        params = attn_p + (cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert
                           if cfg.moe else 3 * d * cfg.d_ff)
    byte_per = 2
    bytes_moved = params * byte_per + tokens * d * byte_per * 4
    if mode == "decode" and cfg.kind not in ("ssm",):
        # decode reads the KV cache for the active tokens' streams
        bytes_moved += tokens * 2 * hkv * hd * byte_per * 512  # ~cache slice
    return float(flops), float(bytes_moved)


def model_chain(cfg: ModelConfig, *, tokens_per_step: int, mode: str,
                system: HeterogeneousSystem) -> tuple[TaskChain, list[BlockCost]]:
    """Build the paper-style task chain for a model: per-block w^B / w^L."""
    blocks: list[BlockCost] = []
    d = cfg.d_model
    emb_flops = 0.0
    emb_bytes = tokens_per_step * d * 2 + cfg.padded_vocab * d * 2 / 64
    blocks.append(BlockCost("ingest", 1e6, 1e6, replicable=False))
    blocks.append(BlockCost("embed", emb_flops, emb_bytes))
    lf, lb = _layer_cost(cfg, tokens_per_step, mode)
    for i in range(cfg.n_layers):
        blocks.append(BlockCost(f"layer{i}", lf, lb))
    head_flops = 2 * tokens_per_step * d * cfg.padded_vocab
    head_bytes = cfg.padded_vocab * d * 2
    blocks.append(BlockCost("head", head_flops, head_bytes))
    blocks.append(BlockCost("emit", 1e6, 1e6, replicable=False))
    chain = TaskChain(
        w_big=[b.latency(system.big) * 1e6 for b in blocks],      # µs
        w_little=[b.latency(system.little) * 1e6 for b in blocks],
        replicable=[b.replicable for b in blocks],
        names=[b.name for b in blocks],
    )
    return chain, blocks


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    solution: Solution
    chain: TaskChain
    period_us: float
    tokens_per_step: int
    # set by the DVFS-aware "freqherad" strategy: the same stages as
    # ``solution`` but annotated with per-stage frequency levels
    freq_solution: FreqSolution | None = None

    def throughput_tokens_per_s(self) -> float:
        return self.tokens_per_step / (self.period_us * 1e-6)

    def stage_table(self) -> list[dict]:
        """One dict per stage; DVFS plans add ``freq`` and ``variant``
        columns (variant-aware weights via ``FreqStage.weight``)."""
        rows = []
        freq_stages = self.freq_solution.stages if self.freq_solution \
            else (None,) * len(self.solution.stages)
        for st, fst in zip(self.solution.stages, freq_stages):
            if fst is None:
                weight = self.chain.weight(st.start, st.end, st.cores,
                                           st.ctype)
            else:
                weight = fst.weight(self.chain, self.freq_solution.variants)
            row = {
                "tasks": [self.chain.names[i]
                          for i in range(st.start, st.end + 1)],
                "n_tasks": st.n_tasks(),
                "devices": st.cores,
                "class": "big" if st.ctype == BIG else "little",
                "weight_us": weight,
            }
            if fst is not None:
                row["freq"] = fst.freq
                row["variant"] = fst.variant
            rows.append(row)
        return rows

    def energy_proxy_watts(self, system: HeterogeneousSystem) -> float:
        b_used = self.solution.cores_used(BIG)
        l_used = self.solution.cores_used(LITTLE)
        return b_used * system.big.watts + l_used * system.little.watts

    def energy_report(self, system: HeterogeneousSystem, power=None,
                      idle_fraction: float = 0.1):
        """Exact per-step energy accounting (repro_torch.energy.account).

        ``power`` defaults to a model derived from the device classes'
        ``watts`` fields (``idle_fraction`` of the draw attributed to
        static/idle power). Chain weights are µs, so energies are µJ per
        pipeline step; ``report.avg_watts`` is directly in watts. DVFS
        plans (``freq_solution`` set) are costed at their per-stage
        frequency levels — each ``StageEnergy.stage.freq`` in the report
        shows the level the stage runs at.
        """
        from repro_torch.energy.account import energy_report
        from repro_torch.energy.model import PowerModel

        if power is None:
            power = PowerModel.from_device_classes(
                system, idle_fraction=idle_fraction)
        return energy_report(self.chain,
                             self.freq_solution or self.solution, power)


def plan_pipeline(cfg: ModelConfig, *, system: HeterogeneousSystem,
                  tokens_per_step: int, mode: str = "decode",
                  strategy: str = "herad", power=None,
                  power_cap_w: float | None = None,
                  frontier=None, variants=None) -> PipelinePlan:
    """Schedule ``cfg``'s layer chain onto ``system``.

    For the energy-constrained ``strategy="energad"`` the optional
    ``power`` (a repro_torch.energy.model.PowerModel) selects the model to
    minimize under; it defaults to one derived from the device classes'
    ``watts`` fields — the same model ``PipelinePlan.energy_report`` scores
    with, so the planner optimizes what the report measures.

    ``strategy="freqherad"`` additionally picks a per-stage DVFS level
    (the frequency plan): the plan's ``freq_solution`` carries the
    annotated stages, ``stage_table()`` gains a ``freq`` column, and
    ``energy_report`` costs each stage at its level. The default ladder
    is ``repro_torch.energy.model.DEFAULT_DVFS_POWER.freq_levels``; pass a
    ``power`` with custom ``freq_levels`` to override. The plan's period
    equals nominal HeRAD's optimum (top level = 1.0), so DVFS only
    spends slack, never throughput.

    ``strategy="variant_herad"`` adds the kernel-variant axis on top:
    ``variants`` (a ``repro_torch.core.variants.VariantSpec`` resolved against
    the model chain, or a ``VariantRegistry`` to resolve here) supplies
    the measured per-variant per-class weight multipliers, and each stage
    additionally picks its implementation. The plan's ``freq_solution``
    stages carry ``variant`` names, ``stage_table()`` gains a ``variant``
    column, and the runtime instantiates the registered callables.

    ``power_cap_w`` plans under an operator power cap instead: the
    fastest (period, energy) Pareto-frontier point whose average draw
    fits under the cap (``repro_torch.energy.pareto.min_period_under_power``,
    a bisection over the cached frontier) — the runtime governor's
    re-plan query, exposed here so an initial deployment and every later
    re-plan pick schedules the same way. ``strategy`` then only selects
    the frontier ("freqherad" sweeps per-stage DVFS levels; anything
    else uses the nominal frontier). Raises when even the frugalest
    schedule exceeds the cap. Pass ``frontier`` (a list of
    ``ParetoPoint`` from a previous cap query, sorted by period as the
    builders return it) to re-plan under a sequence of caps without
    re-sweeping — frontier construction, not the query, is the
    expensive part (see BENCH_sched.json).
    """
    chain, _ = model_chain(cfg, tokens_per_step=tokens_per_step, mode=mode,
                           system=system)
    if variants is not None and hasattr(variants, "spec_for"):
        variants = variants.spec_for(chain)  # accept a VariantRegistry
    if power_cap_w is not None:
        return _plan_under_cap(cfg, chain, system, tokens_per_step,
                               strategy, power, power_cap_w, frontier,
                               variants)
    if strategy == "energad":
        from repro_torch.energy.model import PowerModel
        from repro_torch.energy.pareto import energad

        if power is None:
            power = PowerModel.from_device_classes(system)
        sol = energad(chain, system.big.count, system.little.count,
                      power=power)
    elif strategy == "freqherad":
        from repro_torch.energy.model import DEFAULT_DVFS_POWER, PowerModel
        from repro_torch.energy.pareto import freqherad

        if power is None:
            # device classes carry only a busy-watts figure; the DVFS
            # ladder comes from the energy layer's default model so the
            # planner and the strategy's own fallback can never disagree
            power = PowerModel.from_device_classes(
                system, freq_levels=DEFAULT_DVFS_POWER.freq_levels)
        fsol = freqherad(chain, system.big.count, system.little.count,
                         power=power)
        if fsol.is_empty():
            raise ValueError(
                f"no feasible schedule for {cfg.name} on "
                f"b={system.big.count}, l={system.little.count}")
        return PipelinePlan(fsol.to_solution(), chain, fsol.period(chain),
                            tokens_per_step, freq_solution=fsol)
    elif strategy == "variant_herad":
        from repro_torch.energy.model import DEFAULT_DVFS_POWER, PowerModel
        from repro_torch.energy.pareto import variant_herad

        if power is None:
            power = PowerModel.from_device_classes(
                system, freq_levels=DEFAULT_DVFS_POWER.freq_levels)
        fsol = variant_herad(chain, system.big.count, system.little.count,
                             power=power, variants=variants)
        if fsol.is_empty():
            raise ValueError(
                f"no feasible schedule for {cfg.name} on "
                f"b={system.big.count}, l={system.little.count}")
        return PipelinePlan(fsol.to_solution(), chain, fsol.period(chain),
                            tokens_per_step, freq_solution=fsol)
    else:
        sol = STRATEGIES[strategy](chain, system.big.count,
                                   system.little.count)
    if sol.is_empty():
        raise ValueError(
            f"no feasible schedule for {cfg.name} on b={system.big.count}, "
            f"l={system.little.count}")
    return PipelinePlan(sol, chain, sol.period(chain), tokens_per_step)


def _plan_under_cap(cfg, chain, system: HeterogeneousSystem,
                    tokens_per_step: int, strategy: str, power,
                    power_cap_w: float, frontier=None,
                    variants=None) -> PipelinePlan:
    """Fastest frontier plan with average draw <= ``power_cap_w``."""
    from repro_torch.core.dvfs import FreqSolution
    from repro_torch.energy.model import DEFAULT_DVFS_POWER, PowerModel
    from repro_torch.energy.pareto import min_period_under_power

    use_variants = strategy == "variant_herad" and variants is not None
    dvfs = strategy in ("freqherad", "variant_herad")
    if power is None:
        power = PowerModel.from_device_classes(
            system,
            freq_levels=DEFAULT_DVFS_POWER.freq_levels if dvfs else (1.0,))
    pt = min_period_under_power(chain, system.big.count, system.little.count,
                                power, power_cap_w, dvfs=dvfs,
                                frontier=frontier,
                                variants=variants if use_variants else None)
    if pt is None:
        raise ValueError(
            f"no schedule for {cfg.name} fits under {power_cap_w} W on "
            f"b={system.big.count}, l={system.little.count}")
    if isinstance(pt.solution, FreqSolution):
        return PipelinePlan(pt.solution.to_solution(), chain, pt.period,
                            tokens_per_step, freq_solution=pt.solution)
    return PipelinePlan(pt.solution, chain, pt.period, tokens_per_step)
