"""The one traffic generator: a mix's loop is a parameter of its data
file, and a loop it does not know is refused, not run as another."""
import dataclasses
import time

import pytest

from bench.harness.runner import run_cell
from bench.harness.spec import BENCH, load_json
from bench.harness.traffic import due_times
from bench.tests.small import SMALL_LIMITS, small_cell


@pytest.mark.parametrize("path", sorted((BENCH / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_mix_names_a_known_loop(path):
    mix = load_json(path)
    assert mix["name"] == path.stem
    due_times(mix, 1, 1.0)
    assert int(mix["warm_fits"]) >= 1 and int(mix["check_fits"]) >= 1


def test_an_unknown_loop_is_refused():
    with pytest.raises(ValueError, match="loop"):
        due_times({"name": "x", "loop": "bursty"}, 1, 1.0)


def test_open_loop_arrivals_come_from_the_seed():
    mix = {"loop": "open", "rate_per_s": 50.0}
    a, b = due_times(mix, 2**31 + 5, 2.0), due_times(mix, 2**31 + 5, 2.0)
    assert a == b and a != due_times(mix, 2**31 + 6, 2.0)
    assert all(0 < x < y < 2.0 for x, y in zip(a, a[1:]))
    assert 50 <= len(a) <= 150


def test_an_open_loop_mix_runs_every_fit_that_fell_due():
    mix = {"name": "open", "loop": "open", "rate_per_s": 4.0,
           "warm_fits": 1, "check_fits": 1}
    cell = dataclasses.replace(small_cell("kdd.fit"), traffic=mix)
    seed = 2**31 + 4
    res, _ = run_cell(cell, seed, 1.0, False, "cpu", time.perf_counter(),
                      SMALL_LIMITS)
    assert res["correct"] is True
    assert res["attempted"] == len(due_times(mix, seed, 1.0)) >= 2
