"""The control of ``correct``: the reference in fp8 in the program's
place must fail each cell's limits.

On the CPU at the smoke size (fp32 program): the control reads far above
the program. On the card (``-m chip``), at each cell's own size on three
seeds: the control's readings fail the cell's limits."""
import pytest
import smoke

import torch

from bench import control, harness

torch.set_num_threads(2)


@pytest.mark.parametrize("workload", ["phi3-14b.chain", "phi3-14b.serve"])
def test_control_reads_above_the_program(workload):
    out = control.readings(workload, 7, 3.0,
                           cell=smoke.smoke_cell(workload))
    key = "hidden_rel_gap_max" if "chain" in workload else "served_gap_max"
    assert out["control"][key] > 10 * out["program"][key] + 1e-3, out


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.load_spec()["workloads"]])
def test_control_fails_the_cell_limits(chip, workload):
    from bench.run import compare

    for seed in (9001, 9002, 9003):
        out = control.readings(workload, seed, 10.0)
        checks = compare(out["control"], out["limits"])
        assert not all(c["ok"] for c in checks.values()), out
        torch.cuda.empty_cache()
