"""The span tree of the port's Algorithm 3 fit (``repro_torch.obs``), on
the CPU.

* Names and nesting: ``simulate_coordinator`` under a CPU
  ``torch.profiler``, and ``distributed_cluster`` on two gloo ranks
  (``test_torch_collective.spawn_ranks``); the program opens no profiler
  annotation of its own.
* Counts: ``alg1.round`` spans a site equal the site's ``site_rounds``;
  ``sampler.rows`` equals the lengths of the logits drawn, reckoned from
  the rounds and the second level's records; ``sampler.card_draws``
  equals ``sampler.draws`` for every caller on a CUDA card (marked
  ``chip``: it skips without one) and is absent on the CPU.
* The clock: a flight-recorder span and a profiler annotation around it
  start and end within 1 ms of each other, and
  ``export_chrome(base_ns=...)`` puts the span where the profiler's export
  puts the annotation.
* The answers are bit-identical with the spans off, under a sampled root,
  and under the profiler (inside a sampled root, whose trace id the fit's
  spans then carry, and alone).

No assertion on wall time.  The module imports no JAX (the helpers of the
JAX-comparing test files are imported where they are used), so the card's
case runs where JAX is not installed.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.distributed import (distributed_cluster,
                                          simulate_coordinator)
from repro_torch.core.sampler import TorchSampler

torch.set_num_threads(1)

K, T, ITERS = 3, 20, 5
ANSWER = ("centers", "outlier_ids", "summary_ids", "summary_weights",
          "summary_candidates", "cost")


def _parts():
    from test_torch_stream import grid
    return np.array_split(grid(3600, seed=31), 3)


def _fit(seed=5):
    return simulate_coordinator(_parts(), TorchSampler(seed), k=K, t=T,
                                second_iters=ITERS, device="cpu")


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: (its value, the profiler's
    user annotations as (name, start_ns, end_ns))."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    anns = [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]
    return out, anns


def _links(spans) -> Counter:
    """(span name, parent span name) over ``spans``."""
    names = {s["span_id"]: s["name"] for s in spans}
    return Counter((s["name"], names.get(s["parent_id"])) for s in spans)


def _sampler_counters(reg) -> dict:
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("sampler.")}


def _tree(rounds, picks, sites):
    """The links below the site summaries and the second level of one fit
    whose ``sites`` sites ran ``rounds`` Algorithm 1 rounds in all."""
    return Counter({
        ("alg1.round", "oneshot.site_summary"): rounds,
        ("sampler.draw", "alg1.round"): rounds,
        ("alg1.distance", "alg1.round"): rounds,
        ("alg1.radius", "alg1.round"): rounds,
        ("alg1.readback", "alg1.round"): rounds,
        ("alg2.extra", "oneshot.site_summary"): sites,
        ("sampler.draw", "alg2.extra"): sites,
        ("alg2.reassign", "oneshot.site_summary"): sites,
        ("oneshot.second_level", "oneshot.fit"): 1,
        ("kmeans_pp.seed", "oneshot.second_level"): 1,
        ("sampler.draw", "kmeans_pp.seed"): picks,
        ("kmeans_mm.lloyd", "oneshot.second_level"): 1,
    })


def test_fit_span_tree_under_the_profiler():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        res, anns = _profiled(_fit)
        spans = reg.recorder.spans()
    rounds = sum(res["site_rounds"])
    assert rounds > 0
    want = _tree(rounds, K, 3) + Counter({
        ("oneshot.fit", None): 1,
        ("oneshot.site_summary", "oneshot.fit"): 3})
    assert _links(spans) == want
    root, = [s for s in spans if s["name"] == "oneshot.fit"]
    for s in spans:      # one trace, every span inside the fit's bounds
        assert s["trace_id"] == root["trace_id"]
        assert root["t0"] <= s["t0"] <= s["t1"] <= root["t1"]
    per_site = Counter(s["attrs"]["site"] for s in spans
                       if s["name"] == "oneshot.site_summary")
    assert per_site == Counter({0: 1, 1: 1, 2: 1})
    # each site's rounds: the alg1.round spans under its site summary
    site_of = {s["span_id"]: s["attrs"]["site"] for s in spans
               if s["name"] == "oneshot.site_summary"}
    got = Counter(site_of[s["parent_id"]] for s in spans
                  if s["name"] == "alg1.round")
    assert [got[i] for i in range(3)] == list(res["site_rounds"])
    assert sum(s["name"] == "sampler.draw" for s in spans) == rounds + 3 + K
    # no annotation of the program's own among the profiler's events
    assert not {name for name, _, _ in anns} & {s["name"] for s in spans}


def test_draw_rows_count_the_logits_drawn():
    parts = _parts()
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        res, _ = _profiled(_fit)
        spans = reg.recorder.spans("sampler.draw")
        counters = _sampler_counters(reg)
    n = [p.shape[0] for p in parts]
    records = int(res["comm_records"])
    # Algorithm 1 draws over every row of its site each round, Algorithm 2
    # once; each k-means++ pick over the gathered records
    want = {"alg1.sample": sum(r * m for r, m in zip(res["site_rounds"], n)),
            "alg2.extra": sum(n), "kmeans_pp.pick": K * records}
    draws = {"alg1.sample": sum(res["site_rounds"]), "alg2.extra": 3,
             "kmeans_pp.pick": K}
    assert counters == {
        **{f"sampler.rows{{caller={c}}}": v for c, v in want.items()},
        **{f"sampler.draws{{caller={c}}}": v for c, v in draws.items()}}
    by_caller = Counter()
    for s in spans:
        by_caller[s["attrs"]["caller"]] += s["attrs"]["rows"]
    assert dict(by_caller) == want


def _by_caller(counters, name) -> dict:
    prefix = f"{name}{{caller="
    return {k[len(prefix):-1]: v for k, v in counters.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize(
    "where", ["cpu", pytest.param("cuda", marks=pytest.mark.chip)])
def test_card_draws_count_the_draws_made_on_a_card(where):
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device(where)
    rows = np.random.default_rng(35).normal(size=(3600, 4))
    parts = np.array_split(rows.astype(np.float32), 3)
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        _profiled(lambda: simulate_coordinator(
            parts, TorchSampler(5), k=K, t=T, second_iters=ITERS,
            device=dev))
        counters = _sampler_counters(reg)
    draws = _by_caller(counters, "sampler.draws")
    assert set(draws) == {"alg1.sample", "alg2.extra", "kmeans_pp.pick"}
    assert draws["alg2.extra"] == 3 and draws["kmeans_pp.pick"] == K
    card = _by_caller(counters, "sampler.card_draws")
    assert card == (draws if dev.type == "cuda" else {})


def test_span_and_a_profiler_annotation_share_one_clock():
    def pair(name):
        with torch.profiler.record_function(name):
            with obs.span(name, root=True):
                torch.randn(256, 256) @ torch.randn(256, 256)

    def work():
        pair("warm")      # a first span's set-up is not the clock's
        pair("clock.check")

    with obs.using_registry(obs.MetricsRegistry()) as reg:
        _, anns = _profiled(work)
        rec, = reg.recorder.spans("clock.check")
        (_, a0, a1), = [a for a in anns if a[0] == "clock.check"]
        assert abs(a0 * 1e-9 - rec["t0"]) < 1e-3
        assert abs(a1 * 1e-9 - rec["t1"]) < 1e-3
        events = reg.recorder.export_chrome(base_ns=a0)["traceEvents"]
        ev, = [e for e in events if e["name"] == "clock.check"]
        assert abs(ev["ts"]) < 1e3          # microseconds after a0


def test_answers_bit_identical_off_sampled_and_profiled():
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        off = _fit()
        assert reg.recorder.spans() == [] and not _sampler_counters(reg)
        assert obs.span("alg1.round") is obs.span("sampler.draw")  # no-op
        # a sampled trace and no profiler: the phase spans of old, no
        # detail span, no draw counter
        with obs.root_trace("caller"):
            sampled = _fit()
        assert not _sampler_counters(reg)
        assert {s["name"] for s in reg.recorder.spans()} == {
            "caller", "oneshot.site_summary", "oneshot.second_level"}
    # the profiler inside the caller's sampled trace: the fit joins it
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        with obs.root_trace("caller") as ctx:
            nested, _ = _profiled(_fit)
        spans = reg.recorder.spans()
    fit, = [s for s in spans if s["name"] == "oneshot.fit"]
    assert fit["parent_id"] == ctx.span_id
    assert {s["trace_id"] for s in spans} == {ctx.trace_id}
    assert len(spans) > 20
    with obs.using_registry(obs.MetricsRegistry()):
        profiled, _ = _profiled(_fit)
    for other in (sampled, nested, profiled):
        for key in ANSWER:
            np.testing.assert_array_equal(np.asarray(other[key]),
                                          np.asarray(off[key]), err_msg=key)


def _rank_fit(rank, n, workdir):
    from test_torch_stream import grid
    x = grid(2400, seed=33).reshape(2, 1200, 4)
    with obs.using_registry(obs.MetricsRegistry()) as reg:
        res, anns = _profiled(lambda: distributed_cluster(
            x, TorchSampler(7), k=K, t=T, second_iters=ITERS, device="cpu"))
        return {"spans": reg.recorder.spans(),
                "counters": reg.snapshot()["counters"],
                "annotations": [a[0] for a in anns],
                "summary_ids": res.summary_ids.numpy()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from test_torch_collective import spawn_ranks
    return spawn_ranks(_rank_fit, 2, tmp_path_factory.mktemp("spans2"))


def test_distributed_cluster_span_tree_on_two_ranks(two_ranks):
    for rank, got in enumerate(two_ranks):
        spans = got["spans"]
        root, = [s for s in spans if s["name"] == "oneshot.fit"]
        assert root["attrs"] == {"rank": rank} and root["parent_id"] is None
        site, = [s for s in spans if s["name"] == "oneshot.site_summary"]
        assert site["attrs"] == {"site": rank}
        rounds = sum(s["name"] == "alg1.round" for s in spans)
        assert rounds > 0
        want = _tree(rounds, K, 1) + Counter({
            ("oneshot.fit", None): 1,
            ("oneshot.site_summary", "oneshot.fit"): 1,
            ("oneshot.gather", "oneshot.fit"): 1})
        assert _links(spans) == want
        # no annotation of the program's own among the profiler's events
        assert not set(got["annotations"]) & {s["name"] for s in spans}
        # the comm counters, counted on the device: as many records a site
        # as its block of the gathered ids holds
        ids = got["summary_ids"].reshape(2, -1)
        c = got["counters"]
        for i in range(2):
            assert c[f"comm.records{{path=shard_map,site={i}}}"] == \
                int((ids[i] >= 0).sum())
            assert c[f"comm.bytes{{path=shard_map,site={i}}}"] == \
                ids.shape[1] * (4 * 4 + 4 + 1 + 4)
        assert c["comm.rounds{path=shard_map}"] == 1
