"""The check catches the faults a cell can have, planted under the timed
path while the rest of a run goes on as on the chip (only the look for a
card skipped); and the control, the reference in fp8 in the program's
place, fails the cell's limits at a size a test run holds."""
import json

import pytest
import torch

from benchmark import harness
from conftest import run_cell

FAULTS = [("tiny-train", "half_batch"), ("tiny-train", "frozen_state"),
          ("tiny-rate", "half_batch"), ("tiny-rate", "altered"),
          ("tiny-rate", "no_nms"), ("tiny-max", "half_batch"),
          ("tiny-max", "altered"), ("tiny-max", "no_nms")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_reads_not_correct(tiny, cell, fault):
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    c = harness.load_cell(spec, cell, 5, tiny)
    undo = harness.driver_for(c, tiny).FAULTS[fault]()
    try:
        rc, res = run_cell(tiny, cell, seed=5)
    finally:
        undo()
    assert rc == 0 and res["correct"] is False, res["compared"]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-rate", "tiny-max"])
def test_the_control_reads_not_correct(tiny, cell):
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    c = harness.load_cell(spec, cell, 5, tiny)
    c.device = torch.device("cpu")
    nums = harness.driver_for(c, tiny).Driver(c).control_numbers()
    assert any(nums[k] > v for k, v in c.limits.items()), nums
