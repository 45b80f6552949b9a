"""Percentiles and rates over all samples."""
import numpy as np
import pytest
import smoke  # noqa: F401

from bench import harness
from bench import run as bench_run


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_matches_numpy_linear(n, q):
    x = np.random.default_rng(n).lognormal(size=n)
    assert harness.percentile(x.tolist(), q) == pytest.approx(
        float(np.percentile(x, q)), rel=1e-12)


class Meter:
    joules = 300.0
    seconds = 10.0


def test_end_to_end_over_all_samples():
    spec = harness.load_spec()
    cell = harness.load_cell(spec, "phi3-14b.serve", 1, 10.0, False)
    ttft = list(range(1, 201))            # every request, none dropped
    itl = [10.0] * 1000 + [500.0] * 60
    rec = {"tokens": 1234, "window_s": 10.0, "ttft_ms": ttft, "itl_ms": itl}
    m = bench_run.end_to_end(spec, cell, rec, Meter(), 42.0)
    assert m["tokens_per_s"]["value"] == 123.4
    assert m["joules_per_token"]["value"] == 300.0 / 1234
    assert m["ttft_p95_ms"]["value"] == pytest.approx(
        float(np.percentile(ttft, 95)))
    assert m["itl_p95_ms"]["value"] == 500.0   # 60 of 1060 are the tail
    assert m["setup_s"] == {"value": 42.0, "unit": "s"}
    chain = harness.load_cell(spec, "phi3-14b.chain", 1, 10.0, False)
    m = bench_run.end_to_end(spec, chain, {"tokens": 2048 * 80,
                                           "window_s": 9.5}, Meter(), 5.0)
    assert set(m) == {"tokens_per_s", "joules_per_token", "setup_s"}
