"""Catalog of selectable kernel implementations per family, the port's
counterpart of ``repro.kernels.registry`` (same family and variant names,
the port's callables):

  flash_attention:  base       — hand-written CUDA flash kernel
                                 (``flash_attention/kernel.py``)
                    chunked    — hand-written CUDA two-pass lazy-softmax
                                 kernel (``flash_attention/chunked.py``)
                    xla        — chunked plain-torch attention
                                 (``models/attention.py``, (B,S,H,D) layout)
  ssd_scan:         base       — hand-written CUDA chunked scan
                                 (``ssd_scan/kernel.py``)
                    blocked    — plain-torch block decomposition
                                 (``models/ssm.py:ssd_ref``)
                    sequential — plain-torch sequential recurrence
                                 (``ssd_scan/ref.py``)

``variant_names(family)`` is the selectable set (base first);
``implementation(family, name)`` the callable. ``register_family``, the
bridge into the scheduler's variant registry, needs ``core.variants``,
which the port has not carried across yet.
"""
from __future__ import annotations

from typing import Callable, Mapping

from repro_torch.kernels.flash_attention.chunked import chunked_attention_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.ssd_scan.kernel import ssd_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential
from repro_torch.models.attention import flash_attention_xla
from repro_torch.models.ssm import ssd_ref

#: family -> {variant name -> implementation}; "base" first.
FAMILIES: dict[str, dict[str, Callable]] = {
    "flash_attention": {
        "base": flash_attention_cuda,
        "chunked": chunked_attention_cuda,
        "xla": flash_attention_xla,
    },
    "ssd_scan": {
        "base": ssd_cuda,
        "blocked": ssd_ref,
        "sequential": ssd_ref_sequential,
    },
}


def variant_names(family: str) -> tuple[str, ...]:
    """Selectable implementation names of ``family``, base first."""
    if family not in FAMILIES:
        raise KeyError(f"unknown kernel family {family!r} "
                       f"(have {sorted(FAMILIES)})")
    return tuple(FAMILIES[family])


def implementation(family: str, name: str) -> Callable:
    """The callable implementing variant ``name`` of ``family``."""
    impls = FAMILIES.get(family)
    if impls is None or name not in impls:
        raise KeyError(f"unknown variant {family}/{name} "
                       f"(have {variant_names(family) if impls else ()})")
    return impls[name]


def register_family(registry, task: str, family: str,
                    multipliers: Mapping[str, tuple[float, float]]) -> list:
    """Register ``family``'s measured non-base variants for ``task`` in a
    scheduler variant registry. Not available yet: it needs the port's
    ``core.variants`` (ROADMAP Queue A item 9)."""
    raise NotImplementedError(
        "register_family needs core.variants, not ported yet (ROADMAP "
        "Queue A item 9)")
