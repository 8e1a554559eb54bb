"""A cell on several cards holds every rank, not rank 0 alone: an answer
that differs between ranks, or a JAX module in a spawned rank, fails the
run (four gloo ranks on the CPU)."""
import time

import pytest

from bench.harness.runner import ForbiddenModules, diverged, run_cell
from bench.tests.faults import diverge_on_rank, hold_a_jax_module
from bench.tests.small import SMALL_LIMITS, small_cell


def _run(rank_setup):
    return run_cell(small_cell("kdd4.fit"), 2**31 + 97, 0.5, False, "cpu",
                    time.perf_counter(), SMALL_LIMITS, rank_setup=rank_setup)


def test_a_rank_that_returns_another_answer_fails_the_run():
    res, lines = _run((diverge_on_rank, 1))
    assert res["correct"] is False
    assert res["ranks_differ"] == res["attempted"] >= 1
    assert res["check"]["broken"]["value"] >= res["ranks_differ"]
    assert lines[-4].startswith("check broken")


def test_a_spawned_rank_holding_jax_refuses_the_run():
    with pytest.raises(ForbiddenModules, match="jax"):
        _run((hold_a_jax_module,))


@pytest.mark.parametrize("digests, n", [
    ([["a", "b"], ["a", "b"], ["a", "b"]], 0),
    ([["a", "b"], ["a", "c"], ["a", "b"]], 1),
    ([["a", "b"], ["x", "c"], ["a", "c"]], 2),
])
def test_diverged_counts_the_fits_some_rank_differs_on(digests, n):
    assert diverged([{"digests": d} for d in digests]) == n
