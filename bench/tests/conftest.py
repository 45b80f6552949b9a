import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; run on the card with "
        "python3 -m pytest bench/tests -m chip")


@pytest.fixture
def chip():
    """Skips the test where this host has no CUDA card (decided when the
    test runs, never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
