"""The control, at a size the CPU holds: the reference computed with its
projections in fp8 (the precision below the configurations' bf16), put in
the program's place and held to the same limits by the same checks, comes
out not correct where the bf16 program is correct, on three seeds of each
family, on the number each family's cell compares (the dense cell's widest
gap, the MoE cell's mean gap). The same reading on the card, at the cells'
sizes, set each cell's limit (portbench/prove.py --control; PERF.md)."""
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import bench, smoke_cell


class _StepClock:
    """The harness's clock in this test: 5 ms more at every reading, so that
    the window serves the same steps (and the sample the same requests)
    however busy the host is."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.005
        return self.t


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_fp8_control_fails_where_the_program_passes(moe, monkeypatch):
    cell = smoke_cell.cell(moe)
    (name, limit), = cell.spec["check"]["limits"].items()
    assert name == ("logit_gap_mean" if moe else "logit_gap_max")
    for seed in (1, 2, 3):
        built = bench.build(cell, seed, torch.device("cpu"))
        monkeypatch.setattr(bench, "time", SimpleNamespace(perf_counter=_StepClock().perf_counter,
                                                           sleep=time.sleep))
        rec = bench.drive(built["engine"], cell, seed, 4.0, lambda: None)
        monkeypatch.setattr(bench, "time", time)
        v = bench.judge(cell, rec, built["weights"], seed, torch.device("cpu"), control=True)
        assert v["correct"], (seed, v["readings"])
        assert v["control_correct"] is False, (seed, v["control_checks"])
        assert v["control_checks"][name] == {"value": v["control"][name], "limit": limit}
        assert v["readings"][name] <= limit < v["control"][name], (seed, v["readings"], v["control"])
