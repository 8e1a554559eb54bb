"""Each fault a cell can have, planted under a whole run on the CPU (the
look for a card skipped), turns ``correct`` false."""
import time

import pytest

from bench.harness.runner import run_cell
from bench.tests.faults import FAULTS, plant
from bench.tests.small import SMALL_LIMITS, small_cell


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["kdd.fit", "susy.fit"])
def test_fault_fails_one_card_cell(workload, fault, monkeypatch):
    plant(fault, monkeypatch.setattr)
    res, lines = run_cell(small_cell(workload), 2**31 + 99, 0.5, False,
                          "cpu", time.perf_counter(), SMALL_LIMITS)
    assert res["correct"] is False and res["failed"] >= 1
    assert lines[-1].startswith("check center_step")


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails_four_site_cell(fault, monkeypatch):
    plant(fault, monkeypatch.setattr)
    res, _ = run_cell(small_cell("kdd4.fit"), 2**31 + 98, 0.5, False, "cpu",
                      time.perf_counter(), SMALL_LIMITS,
                      rank_setup=(plant, fault))
    assert res["correct"] is False and res["failed"] >= 1
