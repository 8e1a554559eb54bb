"""The benchmark's own work counts and the roofline share built on them."""
import pytest

from bench.harness.readers import roofline_share
from bench.harness.trace import OpCall, TraceSummary
from bench.harness.work import DEFAULT_PEAKS, least_seconds, op_work


def test_min_argmin_work():
    flops, nbytes = op_work("min_argmin", [(244_922, 34), (36_537, 34)], 4)
    assert flops == 2 * 244_922 * 36_537 * 34
    assert nbytes == 4 * (244_922 + 36_537) * 34 + 8 * 244_922


def test_lloyd_step_work():
    n, k, d = 874_751, 3, 34
    flops, nbytes = op_work("lloyd_step", [(n, d), (n,), (k, d)], 4)
    assert flops == 2 * n * k * d + 2 * n * d
    assert nbytes == 4 * (n * d + k * d) + 4 * n + 4 * (k * d + k) + 8 * n


def test_bf16_rows_count_their_bytes():
    assert (op_work("min_argmin", [(100, 8), (10, 8)], 2)[1]
            == 2 * (100 + 10) * 8 + 8 * 100)


def test_least_seconds_is_the_larger_bound():
    big = least_seconds("min_argmin", [(244_922, 34), (36_537, 34)], 4,
                        DEFAULT_PEAKS)
    assert big == pytest.approx(2 * 244_922 * 36_537 * 34 / 67e12)
    small = least_seconds("min_argmin", [(244_922, 34), (26, 34)], 4,
                          DEFAULT_PEAKS)
    assert small == pytest.approx(
        (4 * (244_922 + 26) * 34 + 8 * 244_922) / 3.35e12)


def test_unknown_op_raises():
    with pytest.raises(KeyError):
        op_work("score", [(1, 1)], 4)


class _Run:
    def __init__(self, calls):
        self.trace = TraceSummary(1.0, 0.5, calls)
        self.peaks = DEFAULT_PEAKS


def test_roofline_share_sums_least_over_kernel_time():
    shape = [(244_922, 34), (36_537, 34)]
    least = least_seconds("min_argmin", shape, 4, DEFAULT_PEAKS)
    calls = [OpCall("min_argmin", shape, 4, 2 * least, 2),
             OpCall("min_argmin", shape, 4, 2 * least, 1),
             OpCall("min_argmin", shape, 4, 0.0, 0),      # not linked
             OpCall("lloyd_step", [(10, 34), (10,), (3, 34)], 4, 1.0, 2)]
    assert roofline_share(_Run(calls), "min_argmin") == pytest.approx(50.0)


def test_roofline_share_reads_nothing_without_linked_calls():
    assert roofline_share(_Run([]), "lloyd_step") is None
