"""The card's own energy counter, read through NVML with ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card
has used since the driver loaded (Volta and later). The benchmark reads
it at the window's start and end; the difference is what the card drew
over the window. The card's enforced power limit is read beside it. There is no fallback: a missing library, a missing card
or a counter the card does not support raises ``EnergyCounterError``,
and no modelled or zero value is ever returned.
"""
from __future__ import annotations

import ctypes

LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0


class EnergyCounterError(RuntimeError):
    """The energy counter cannot be read."""


class _Device(ctypes.Structure):
    pass


_Handle = ctypes.POINTER(_Device)


class EnergyCounter:
    """One card's cumulative energy counter. ``pci_bus_id`` (as CUDA gives
    it, ``0000:18:00.0``) picks the card; without it the host must hold
    exactly one card."""

    def __init__(self, pci_bus_id: str | None = None,
                 library: str = LIBRARY):
        try:
            self._lib = ctypes.CDLL(library)
        except OSError as e:
            raise EnergyCounterError(f"cannot load {library}: {e}") from e
        lib = self._lib
        for name, args, res in (
                ("nvmlInit_v2", [], ctypes.c_int),
                ("nvmlErrorString", [ctypes.c_int], ctypes.c_char_p),
                ("nvmlDeviceGetCount_v2",
                 [ctypes.POINTER(ctypes.c_uint)], ctypes.c_int),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ctypes.POINTER(_Handle)], ctypes.c_int),
                ("nvmlDeviceGetHandleByPciBusId_v2",
                 [ctypes.c_char_p, ctypes.POINTER(_Handle)], ctypes.c_int),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [_Handle, ctypes.POINTER(ctypes.c_ulonglong)],
                 ctypes.c_int),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [_Handle, ctypes.POINTER(ctypes.c_uint)], ctypes.c_int)):
            try:
                fn = getattr(lib, name)
            except AttributeError as e:
                raise EnergyCounterError(f"{library} lacks {name}") from e
            fn.argtypes, fn.restype = args, res
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = _Handle()
        if pci_bus_id is not None:
            self._check(lib.nvmlDeviceGetHandleByPciBusId_v2(
                pci_bus_id.encode(), ctypes.byref(self._handle)),
                f"nvmlDeviceGetHandleByPciBusId_v2({pci_bus_id})")
        else:
            count = ctypes.c_uint()
            self._check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)),
                        "nvmlDeviceGetCount_v2")
            if count.value != 1:
                raise EnergyCounterError(
                    f"{count.value} cards and no PCI bus id to pick one")
            self._check(lib.nvmlDeviceGetHandleByIndex_v2(
                0, ctypes.byref(self._handle)),
                "nvmlDeviceGetHandleByIndex_v2")
        self.read_mj()          # a counter the card lacks fails here

    def _check(self, rc: int, what: str) -> None:
        if rc != NVML_SUCCESS:
            msg = self._lib.nvmlErrorString(rc)
            raise EnergyCounterError(
                f"{what}: NVML error {rc} "
                f"({msg.decode() if msg else 'unknown'})")

    def read_mj(self) -> int:
        """Millijoules used since the driver loaded."""
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value

    def power_limit_w(self) -> float:
        """The power limit the card enforces, in watts."""
        mw = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetEnforcedPowerLimit(
            self._handle, ctypes.byref(mw)),
            "nvmlDeviceGetEnforcedPowerLimit")
        return mw.value / 1e3


def cuda_pci_bus_id(device: int = 0) -> str | None:
    """The PCI bus id of CUDA device ``device`` in NVML's form, or None
    where this torch does not give it."""
    import torch

    props = torch.cuda.get_device_properties(device)
    bus = getattr(props, "pci_bus_id", None)
    if bus is None:
        return None
    return (f"{getattr(props, 'pci_domain_id', 0):08x}:{bus:02x}:"
            f"{getattr(props, 'pci_device_id', 0):02x}.0")
