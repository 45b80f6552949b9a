"""Scheduling core: the paper's strategies for partially-replicable task
chains on two types of resources.

The problem (paper Section III): a linear chain of n tasks, each with a
per-core-type latency w_i^v for v in {big, little} (µs in the DVB-S2
tables), must be cut into consecutive pipeline stages; replicable
(stateless) stages may run on r cores at weight w/r, sequential ones are
pinned to one core. The objective is the minimum period — the reciprocal
throughput of the pipeline — under core budgets (b, l).

Strategies (all take ``(chain, b, l)`` and return a
:class:`~repro_torch.core.chain.Solution`; see ``STRATEGIES``):

- ``herad`` / ``herad_ref``: the exact dynamic program (Theorem 1),
  vectorized / faithful scalar pseudo-code.
- ``fertac``: greedy, little-cores-first stage packing inside a binary
  search over the period.
- ``twocatac`` / ``twocatac_memo``: greedy trying both core types per
  stage (exponential as in the paper / memoized polynomial variant).
- ``otac_b`` / ``otac_l``: homogeneous (single-type) baselines.
- ``energad``: minimum energy under a period bound (exact DP, defined in
  ``repro_torch.energy.pareto``; energies in watt x time-unit, µJ for µs
  chains).
- ``freqherad``: DVFS-aware — assigns (core type, replica count,
  frequency level) per stage, lexicographically optimizing (period,
  energy); returns a :class:`~repro_torch.core.dvfs.FreqSolution`. Defined in
  ``repro_torch.energy.pareto`` on top of :mod:`repro_torch.core.dvfs`.
- ``variant_herad``: the 4-axis strategy — (core type, replica count,
  frequency level, kernel variant) per stage over a
  :class:`~repro_torch.core.variants.VariantSpec`; reduces bit-identically to
  ``freqherad`` for single-variant specs. Defined in
  ``repro_torch.energy.pareto`` on top of :mod:`repro_torch.core.variants`.
"""
from .chain import (  # noqa: F401
    BIG,
    LITTLE,
    EMPTY_SOLUTION,
    Solution,
    Stage,
    TaskChain,
    chain_from_rows,
    cores_for_work,
    make_chain,
    max_packing,
    required_cores,
)
from .greedy import (  # noqa: F401
    compute_stage,
    choose_best_solution,
    fertac,
    otac,
    schedule,
    twocatac,
)
from .herad import (  # noqa: F401
    extract_solution,
    herad,
    herad_reference,
    herad_table,
)
from .dvfs import (  # noqa: F401
    EMPTY_FREQ_SOLUTION,
    FreqSolution,
    FreqStage,
    annotate_frequency,
    dvfs_tables,
    extract_dvfs_solution,
    extract_variant_solution,
    scale_chain,
    variant_tables,
)
from .variants import (  # noqa: F401
    DEFAULT_VARIANT,
    TaskVariant,
    VariantRegistry,
    VariantSpec,
)
from .brute import brute_force  # noqa: F401


def _energad(c, b, l):
    # Lazy import: repro_torch.energy builds on repro_torch.core, not the other way
    # around; the strategy table is the one place the layers meet.
    from repro_torch.energy.pareto import energad

    return energad(c, b, l)


def _freqherad(c, b, l):
    # Same lazy-import layering as energad: the DVFS DP needs a power
    # model (repro_torch.energy), the core layer only the representation.
    from repro_torch.energy.pareto import freqherad

    return freqherad(c, b, l)


def _variant_herad(c, b, l):
    # 4-axis strategy with no registry in scope: runs over the trivial
    # (base-only) spec, which is exactly freqherad. Callers with real
    # variants invoke repro_torch.energy.pareto.variant_herad directly.
    from repro_torch.energy.pareto import variant_herad

    return variant_herad(c, b, l)


STRATEGIES = {
    "herad": lambda c, b, l: herad(c, b, l),
    "herad_ref": lambda c, b, l: herad_reference(c, b, l),
    "fertac": lambda c, b, l: fertac(c, b, l),
    "twocatac": lambda c, b, l: twocatac(c, b, l),
    "twocatac_memo": lambda c, b, l: twocatac(c, b, l, memoize=True),
    "otac_b": lambda c, b, l: otac(c, b, BIG),
    "otac_l": lambda c, b, l: otac(c, l, LITTLE),
    # energy-constrained: min energy among period-optimal schedules
    "energad": _energad,
    # DVFS-aware: per-stage (type, replicas, frequency), lexicographic
    # (period, energy) — returns a FreqSolution
    "freqherad": _freqherad,
    # 4-axis: (type, replicas, frequency, kernel variant); equals
    # freqherad under the trivial base-only variant spec
    "variant_herad": _variant_herad,
}
