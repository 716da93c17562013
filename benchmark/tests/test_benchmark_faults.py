"""The check against a broken timed path: each planted fault a cell can
have drives a whole run (the look for a card aside) to correct = false."""

import pytest

from benchmark.harness.cell import run_cell
from benchmark.tests.conftest import toy
from benchmark.tools.faults import FAULTS

CASES = [("m50_f32.pjgrid", "unchanged"), ("m50_f32.pjgrid", "half_batch"),
         ("m50_bf16.pjgrid", "unchanged"), ("m50_bf16.pjgrid", "half_batch"),
         ("m50_f32.compdist", "altered"), ("m50_f32.compdist", "half_batch")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    cell = toy(name)
    with FAULTS[cell["traffic"]["entry"]][fault]():
        result, info = run_cell(name, 2 ** 31 + 5, 0.0, False, "cpu",
                                cell=cell)
    assert result["correct"] is False, info["numbers"]


@pytest.mark.parametrize("name", ["m50_f32.pjgrid", "m50_f32.compdist"])
def test_sound_run_is_correct(name):
    result, _ = run_cell(name, 2 ** 31 + 5, 0.0, False, "cpu",
                         cell=toy(name))
    assert result["correct"] is True
