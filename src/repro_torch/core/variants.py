"""Kernel-variant axis: implementation choice as a scheduling dimension.

A task can ship several *implementations* (kernel variants) with different
time/energy points per core type — e.g. a Pallas flash-attention kernel, a
chunked-softmax memory-efficient variant, and a lowerable XLA fallback.
This module makes that choice schedulable: a per-stage dimension alongside
(core type, replicas, frequency), following the task-variant frame of
Mack et al. (arXiv:2112.08980) for heterogeneous SoCs.

Model: variant ``k`` multiplies task ``t``'s per-core-type weight by a
*measured* factor ``m_k(t, v)`` (fit from capture windows by
``repro.control.calibrate``, or benchmarked directly — never assumed).
The scheduling layers compose this with the DVFS rule: a stage [i, j] on
type v at level f under variant k has work

    sum_{t=i..j} w_t^v * m_k(t, v)  /  f

so the variant axis enters every DP exactly the way the frequency axis
does — through scaled interval sums (``repro_torch.core.dvfs.scale_chain``
composes both).

Three objects:

- :class:`TaskVariant`: one (task, variant) registration — multipliers
  plus an optional runtime callable.
- :class:`VariantRegistry`: the mutable name-keyed registry tasks register
  into (``register("ModemQPSK.demodulate", "chunked", big=1.2,
  little=0.85, fn=...)``).
- :class:`VariantSpec`: the *resolved*, immutable per-chain table the
  planning layers consume — ordered variant names (``"base"`` first) and
  per-task multiplier arrays aligned with the chain. ``scaled`` returns
  the variant-reweighted :class:`~repro_torch.core.chain.TaskChain` (the chain
  itself for the base variant, so the common path stays free, mirroring
  ``scale_chain``'s nominal no-op).

Every task implicitly has the ``"base"`` variant (multiplier 1.0, the
chain's own measured weights); tasks without a registration for variant
``k`` run their base implementation under ``k`` (multiplier 1.0), which
the candidate pruning in ``repro_torch.energy.pareto`` recognizes as a
duplicate and drops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping

import numpy as np

from .chain import BIG, LITTLE, TaskChain

#: The implicit variant every task has: the chain's own weights.
DEFAULT_VARIANT = "base"


@dataclasses.dataclass(frozen=True)
class TaskVariant:
    """One implementation choice of one task.

    ``mult_big`` / ``mult_little`` are *measured* weight multipliers: the
    task's latency under this variant divided by its base latency, per
    core type (fit by ``repro.control.calibrate.fit_variant_multipliers``
    or taken from a benchmark sweep). ``fn`` is the runtime callable (or
    callable factory) the pipeline executors instantiate when a plan
    selects this variant; it is deliberately excluded from equality so
    planning artifacts compare by their measurable fields.
    """

    task: str
    name: str
    mult_big: float = 1.0
    mult_little: float = 1.0
    fn: Callable | None = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def __post_init__(self):
        if self.mult_big <= 0 or self.mult_little <= 0:
            raise ValueError("variant weight multipliers must be positive")
        if self.name == DEFAULT_VARIANT and (self.mult_big != 1.0
                                             or self.mult_little != 1.0):
            raise ValueError(
                f"variant {DEFAULT_VARIANT!r} is the identity by definition")

    def mult(self, ctype: str) -> float:
        if ctype == BIG:
            return self.mult_big
        if ctype == LITTLE:
            return self.mult_little
        raise ValueError(f"unknown core type {ctype!r}")


class VariantRegistry:
    """Task-keyed variant registrations: task name -> {variant name -> v}.

    The registry is the *mutable* side (kernels register themselves,
    calibration updates multipliers); :meth:`spec_for` freezes it into the
    :class:`VariantSpec` the planning layers consume. Variant name order
    is registration order (``"base"`` always first), so candidate
    enumeration — and with it every DP tie-break — is deterministic.
    """

    def __init__(self):
        self._order: list[str] = []
        self._by_task: dict[str, dict[str, TaskVariant]] = {}

    def register(self, task: str, name: str, *, big: float = 1.0,
                 little: float = 1.0, fn: Callable | None = None
                 ) -> TaskVariant:
        """Register (or update) variant ``name`` of ``task``."""
        if name == DEFAULT_VARIANT:
            raise ValueError(
                f"{DEFAULT_VARIANT!r} is implicit and cannot be registered")
        tv = TaskVariant(task, name, big, little, fn)
        if name not in self._order:
            self._order.append(name)
        self._by_task.setdefault(task, {})[name] = tv
        return tv

    @property
    def names(self) -> tuple[str, ...]:
        """All variant names, base first, then registration order."""
        return (DEFAULT_VARIANT, *self._order)

    def get(self, task: str, name: str) -> TaskVariant | None:
        """The registration for (task, name), or None (base/unregistered)."""
        return self._by_task.get(task, {}).get(name)

    def variants_for(self, task: str) -> dict[str, TaskVariant]:
        return dict(self._by_task.get(task, {}))

    def spec_for(self, chain: TaskChain) -> "VariantSpec":
        """Resolve the registry against ``chain``'s task names."""
        names = self.names
        K, n = len(names), chain.n
        mult = {BIG: np.ones((K, n)), LITTLE: np.ones((K, n))}
        fns: dict[tuple[str, str], Callable] = {}
        for ki, vname in enumerate(names[1:], start=1):
            for ti, task in enumerate(chain.names):
                tv = self.get(task, vname)
                if tv is None:
                    continue
                mult[BIG][ki, ti] = tv.mult_big
                mult[LITTLE][ki, ti] = tv.mult_little
                if tv.fn is not None:
                    fns[(task, vname)] = tv.fn
        return VariantSpec(names, chain.names, mult, fns)


class VariantSpec:
    """Resolved per-chain variant table (immutable planning input).

    ``names`` is the ordered variant tuple (``"base"`` first);
    ``mult[v]`` a (K, n) multiplier array aligned with the chain's tasks.
    ``scaled`` materializes variant-reweighted chains (cached one chain
    per variant name — the planning layers reuse one base chain across a
    whole frontier build); the base variant returns the chain itself, so
    single-variant specs add zero float operations anywhere.
    """

    def __init__(self, names: Iterable[str], task_names: Iterable[str],
                 mult: Mapping[str, np.ndarray],
                 fns: Mapping[tuple[str, str], Callable] | None = None):
        self.names = tuple(names)
        self.task_names = tuple(task_names)
        if not self.names or self.names[0] != DEFAULT_VARIANT:
            raise ValueError(
                f"VariantSpec.names must start with {DEFAULT_VARIANT!r}")
        if len(set(self.names)) != len(self.names):
            raise ValueError("duplicate variant names")
        K, n = len(self.names), len(self.task_names)
        self.mult = {v: np.asarray(mult[v], dtype=np.float64)
                     for v in (BIG, LITTLE)}
        for v in (BIG, LITTLE):
            if self.mult[v].shape != (K, n):
                raise ValueError(f"mult[{v!r}] must have shape (K, n) = "
                                 f"({K}, {n})")
            if (self.mult[v] <= 0).any():
                raise ValueError("variant multipliers must be positive")
            if not np.all(self.mult[v][0] == 1.0):
                raise ValueError("the base variant's multipliers must be 1")
        self._fns = dict(fns or {})
        self._cache: dict[str, tuple[TaskChain, TaskChain]] = {}

    # ------------------------------------------------------------- queries
    @classmethod
    def trivial(cls, chain: TaskChain) -> "VariantSpec":
        """The single-variant (base-only) spec of ``chain``."""
        ones = np.ones((1, chain.n))
        return cls((DEFAULT_VARIANT,), chain.names,
                   {BIG: ones, LITTLE: ones})

    @property
    def n_variants(self) -> int:
        return len(self.names)

    def is_trivial(self) -> bool:
        return len(self.names) == 1

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown variant {name!r} "
                           f"(have {self.names})") from None

    def multipliers(self, name: str) -> dict[str, np.ndarray]:
        ki = self.index(name)
        return {v: self.mult[v][ki] for v in (BIG, LITTLE)}

    def fn_for(self, task: str, name: str) -> Callable | None:
        """The runtime callable registered for (task, variant), if any."""
        return self._fns.get((task, name))

    def is_identity(self, name: str) -> bool:
        """True iff ``name`` multiplies every weight by exactly 1."""
        ki = self.index(name)
        return bool(np.all(self.mult[BIG][ki] == 1.0)
                    and np.all(self.mult[LITTLE][ki] == 1.0))

    def scaled(self, chain: TaskChain, name: str) -> TaskChain:
        """``chain`` with this variant's multipliers applied per task.

        Returns ``chain`` itself for the base variant (and any all-ones
        variant), so the common path is free. The result is cached per
        variant name for the most recent chain — frontier builds and DP
        queries hit the cache on every candidate re-pricing.
        """
        ki = self.index(name)
        if ki == 0 or self.is_identity(name):
            return chain
        hit = self._cache.get(name)
        if hit is not None and hit[0] is chain:
            return hit[1]
        out = TaskChain(
            w_big=chain.w[BIG] * self.mult[BIG][ki],
            w_little=chain.w[LITTLE] * self.mult[LITTLE][ki],
            replicable=chain.replicable,
            names=chain.names,
        )
        self._cache[name] = (chain, out)
        return out

    def with_multipliers(self, name: str, mult_big, mult_little
                         ) -> "VariantSpec":
        """A new spec with variant ``name``'s multiplier rows replaced.

        The governor's drift recalibration rescales the *active* variant
        only — this is the immutable-update hook it uses: every other
        variant's rows (and the base) carry over untouched.
        """
        ki = self.index(name)
        if ki == 0:
            raise ValueError("the base variant is the identity and cannot "
                             "be rescaled; rescale the chain instead")
        mult = {v: self.mult[v].copy() for v in (BIG, LITTLE)}
        mult[BIG][ki] = np.asarray(mult_big, dtype=np.float64)
        mult[LITTLE][ki] = np.asarray(mult_little, dtype=np.float64)
        return VariantSpec(self.names, self.task_names, mult, self._fns)

    # ------------------------------------------------------------ equality
    def __eq__(self, other) -> bool:
        if not isinstance(other, VariantSpec):
            return NotImplemented
        return (self.names == other.names
                and self.task_names == other.task_names
                and all(np.array_equal(self.mult[v], other.mult[v])
                        for v in (BIG, LITTLE)))

    def __hash__(self) -> int:
        return hash((self.names, self.task_names))

    def __repr__(self) -> str:
        return (f"VariantSpec(names={self.names!r}, "
                f"n_tasks={len(self.task_names)})")
