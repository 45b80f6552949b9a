"""The energy counter raises where it cannot read the card, and never
returns a modelled or zero value."""
import pytest
import smoke  # noqa: F401

from bench import energy


def test_missing_library_raises():
    with pytest.raises(energy.EnergyCounterError, match="cannot load"):
        energy.EnergyCounter(library="libnvidia-ml-absent.so.1")


def test_no_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(energy.EnergyCounterError):
        energy.EnergyCounter()


def test_a_library_without_the_counter_raises(tmp_path):
    """A library that loads but lacks NVML's entry points (here libc) is
    refused, not read as 0."""
    import ctypes.util

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no libc to stand in")
    with pytest.raises(energy.EnergyCounterError, match="lacks"):
        energy.EnergyCounter(library=libc)


def test_counter_on_the_card(chip):
    counter = energy.EnergyCounter(energy.cuda_pci_bus_id(0))
    a = counter.read_mj()
    assert a > 0 and counter.read_mj() >= a
