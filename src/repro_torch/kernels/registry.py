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
``implementation(family, name)`` the callable. ``register_family``
bridges a family into a :class:`repro_torch.core.variants.VariantRegistry`
under a task name: the caller supplies measured per-core-type weight
multipliers (this module never assumes them), and the catalog contributes
the port's callable, so a plan that selects the variant can instantiate
it.
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
    """Register ``family``'s non-base variants for ``task``.

    ``multipliers`` maps variant name -> measured (big, little) weight
    multipliers (pass only the variants you measured to register a
    subset). Returns the :class:`repro_torch.core.variants.TaskVariant`
    registrations.
    """
    out = []
    for name, (big, little) in multipliers.items():
        fn = implementation(family, name)  # validates family/name
        if name == "base":
            raise ValueError("the base implementation is the task itself; "
                             "register only non-base variants")
        out.append(registry.register(task, name, big=big, little=little,
                                     fn=fn))
    return out
