"""The readers of the program's own spans and counters
(``bench/harness/spans.py``: ``draw_ms``, ``draw_rows_per_fit``,
``seeding_ms``), on synthetic flight-recorder records and on a small fit
traced on the CPU."""
import time

import pytest

from bench.harness.runner import RunData, run_cell
from bench.harness.spec import load_metric
from bench.tests.small import SMALL_LIMITS, small_cell

NEW = ("draw_ms", "draw_rows_per_fit", "seeding_ms")


@pytest.fixture
def registry():
    """A fresh registry and flight recorder of the program's ``obs``."""
    from repro_torch import obs
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        yield reg


def _run(fits):
    return RunData(cell=None, answers=[{}] * fits, window_s=1.0,
                   setup_s=0.0, trace=None, peaks={})


def _fit(rec, t0, draws, seed_s):
    """One fit's tree as the program records it under the profiler: a
    trace of its own rooted at ``oneshot.fit``; ``draws`` as (seconds,
    rows)."""
    ctx = rec.new_trace()
    t = t0
    for sec, rows in draws:
        rec.record_span("sampler.draw", ctx, t0=t, t1=t + sec,
                        parent_id=ctx.span_id,
                        attrs={"caller": "alg1.sample", "rows": rows})
        t += sec
    rec.record_span("kmeans_pp.seed", ctx, t0=t, t1=t + seed_s,
                    parent_id=ctx.span_id)
    rec.record_span("oneshot.fit", ctx, t0=t0, t1=t + seed_s + 0.01,
                    span_id=ctx.span_id, parent_id=None)


def read(name, run):
    return load_metric(name).read(run)


def test_readers_with_the_spans_present(registry):
    _fit(registry.recorder, 100.0, [(0.002, 10), (0.004, 20)], 0.010)
    _fit(registry.recorder, 200.0, [(0.006, 30)], 0.020)
    registry.counter("sampler.rows", caller="alg1.sample").inc(40)
    registry.counter("sampler.rows", caller="kmeans_pp.pick").inc(20)
    run = _run(2)
    assert read("draw_ms", run) == pytest.approx(6.0)       # (6 + 6) / 2
    assert read("seeding_ms.susy", run) == pytest.approx(15.0)
    assert read("draw_rows_per_fit.kdd4", run) == 30.0      # 60 / 2 fits


def test_readers_without_the_spans_read_none(registry):
    # a program that records no fit tree and keeps no draw counter (the
    # parent of the change that added them): None, not 0
    run = _run(3)
    assert [read(name, run) for name in NEW] == [None, None, None]
    ctx = registry.recorder.new_trace()      # spans of something else
    registry.recorder.record_span("refresh", ctx, t0=1.0, t1=2.0,
                                  span_id=ctx.span_id, parent_id=None)
    assert [read(name, run) for name in NEW] == [None, None, None]


def test_a_fit_the_ring_cut_is_left_out():
    from repro_torch import obs
    rec = obs.FlightRecorder(True, ring=5)
    with obs.using_registry(obs.MetricsRegistry(recorder=rec)):
        _fit(rec, 100.0, [(0.001, 1), (0.001, 1)], 0.001)   # 4 records
        _fit(rec, 200.0, [(0.003, 1)], 0.005)               # 3 more
        assert rec.snapshot_section()["dropped"] == 2
        run = _run(2)
        assert read("draw_ms", run) == pytest.approx(3.0)   # the 2nd fit
        assert read("seeding_ms", run) == pytest.approx(5.0)


def test_traced_small_fit_reports_the_draw_and_seeding_metrics(registry):
    res, _ = run_cell(small_cell("kdd.fit"), 2**31 + 11, 1.0, True, "cpu",
                      time.perf_counter(), SMALL_LIMITS)
    m = res["metrics"]
    assert set(NEW) <= set(m)
    assert m["draw_ms"]["value"] > 0 and m["seeding_ms"]["value"] > 0
    # every fit draws at least one Algorithm 1 round and Algorithm 2's
    # extra centers over each site's rows: 2 x 20,000 rows in all
    assert m["draw_rows_per_fit"]["value"] >= 2 * 20_000
    assert m["draw_rows_per_fit"]["unit"] == "rows"
