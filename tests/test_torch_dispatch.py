"""The port's tile autotuner (``kernels/dispatch.py``) on the CPU.

Mirrors the reference's autotune tests (``tests/test_dispatch.py``): the
cache is written and reused; an autotune policy resolves a measured
``block_n`` on ``blocked`` and an explicit ``block_n`` wins; ``score``'s
jointly tuned (block_n, block_m) pair round-trips through the cache and
``resolve_tiles``; stale and older-schema entries are ignored, not
trusted.  Then what is the port's own: tuned results equal the untuned
ones bit for bit (a tile changes how rows are chunked, not what a row
computes); the ``cuda`` registrations carry no candidates, so a call that
resolves to ``cuda`` measures nothing and writes nothing; the resolution
memo keeps the tuned tiles, so a shape is measured once per process; the
cache file is the port's own, never the reference's.
"""
import json

import numpy as np
import pytest
import torch

import repro.kernels.dispatch as jdispatch
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.lloyd.ops import lloyd_step
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.kernels.score.ops import score

torch.set_num_threads(1)

BLOCKED_NS = (4096, 8192, 16384, 32768, 65536)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNELS_CACHE", str(tmp_path))
    dispatch.clear_autotune_cache()
    yield tmp_path / "autotune.json"
    dispatch.clear_autotune_cache()


def test_autotune_writes_and_reuses_cache(cache):
    bn = dispatch.autotune_block_n("min_argmin", "blocked", metric="l2sq",
                                   n=4096, m=16, d=4)
    assert bn in BLOCKED_NS
    payload = json.loads(cache.read_text())
    (key,) = payload.keys()
    assert key == "v2/min_argmin/blocked/cpu/l2sq/n4096/m16/d4"
    assert payload[key]["block_n"] == bn
    assert payload[key]["timings_us"]
    # second call (same shape bucket): served from the cache, so poisoning
    # the cached value must be reflected verbatim
    payload[key]["block_n"] = 12345
    cache.write_text(json.dumps(payload))
    dispatch.clear_autotune_cache()
    assert dispatch.autotune_block_n("min_argmin", "blocked", metric="l2sq",
                                     n=4000, m=16, d=4) == 12345


def test_autotune_policy_resolves_block_n(cache):
    # candidates above the shape bucket are clamped to it, so only
    # {4096, 8192} compete here
    reg, bn = dispatch.resolve("min_argmin", KernelPolicy(autotune=True),
                               metric="l2sq", n=5000, m=8, d=4)
    assert reg.name == "blocked" and bn in (4096, 8192)
    timings = json.loads(cache.read_text())[
        "v2/min_argmin/blocked/cpu/l2sq/n8192/m8/d4"]["timings_us"]
    assert sorted(timings, key=int) == ["4096", "8192"]
    # an explicit block_n always wins over the tuner
    _, bn2 = dispatch.resolve("min_argmin",
                              KernelPolicy(autotune=True, block_n=777),
                              metric="l2sq", n=5000, m=8, d=4)
    assert bn2 == 777


def test_score_joint_autotune_cache_roundtrip(cache):
    bn, bm = dispatch.autotune_tiles("score", "blocked", metric="l2sq",
                                     n=2048, m=256, d=8)
    payload = json.loads(cache.read_text())
    (key,) = payload.keys()
    assert key.startswith("v2/score/blocked/")
    assert (payload[key]["block_n"], payload[key]["block_m"]) == (bn, bm)
    assert len(payload[key]["timings_us"]) == 3   # 2048 x {64, 128, 256}
    payload[key]["block_n"], payload[key]["block_m"] = 12345, 678
    cache.write_text(json.dumps(payload))
    dispatch.clear_autotune_cache()
    assert dispatch.autotune_tiles("score", "blocked", metric="l2sq",
                                   n=2000, m=250, d=8) == (12345, 678)
    # resolve_tiles threads the tuned pair through the policy path
    reg, rbn, rbm = dispatch.resolve_tiles(
        "score", KernelPolicy(autotune=True), metric="l2sq",
        n=2000, m=250, d=8)
    assert reg.name == "blocked" and (rbn, rbm) == (12345, 678)
    # an explicit block_n pins the row tile and disables the tuner
    _, ebn, ebm = dispatch.resolve_tiles(
        "score", KernelPolicy(autotune=True, block_n=777),
        metric="l2sq", n=2000, m=250, d=8)
    assert ebn == 777 and ebm != 678
    with pytest.raises(ValueError, match="block_m"):
        dispatch.autotune_tiles("min_argmin", "blocked", metric="l2sq",
                                n=64, m=4, d=2)


def test_autotune_cache_ignores_stale_and_older_schema_entries(cache):
    stale_key = "v2/score/blocked/cpu/l2sq/n2048/m256/d8"
    cache.write_text(json.dumps({
        "score/blocked/cpu/l2sq/n2048/m256/d8": {"block_n": 99999},
        stale_key: {"block_n": 4096},
    }))
    bn, bm = dispatch.autotune_tiles("score", "blocked", metric="l2sq",
                                     n=2048, m=256, d=8)
    payload = json.loads(cache.read_text())
    assert (payload[stale_key]["block_n"],
            payload[stale_key]["block_m"]) == (bn, bm)
    # the old-schema key survives untouched (ignored, not migrated)
    assert payload["score/blocked/cpu/l2sq/n2048/m256/d8"] == {
        "block_n": 99999}
    dispatch.clear_autotune_cache()
    assert dispatch.autotune_tiles("score", "blocked", metric="l2sq",
                                   n=2048, m=256, d=8) == (bn, bm)
    # the 1-D tuner never sees 2-D entries as stale: block_n suffices
    assert dispatch.autotune_block_n("score", "blocked", metric="l2sq",
                                     n=2048, m=256, d=8) == bn
    # an unreadable file is an empty cache, not an error
    cache.write_text("{not json")
    dispatch.clear_autotune_cache()
    assert dispatch.autotune_block_n("min_argmin", "blocked", metric="l1",
                                     n=64, m=4, d=2) == 64


@pytest.mark.parametrize("metric", ["l2sq", "l1"])
def test_tuned_results_equal_untuned_bit_for_bit(cache, metric):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((20_000, 5)), dtype=torch.float32)
    c = torch.as_tensor(rng.standard_normal((40, 5)), dtype=torch.float32)
    w = torch.as_tensor(rng.uniform(0, 2, 20_000), dtype=torch.float32)
    calls = {
        "min_argmin": lambda p: min_argmin(x, c, metric=metric, policy=p),
        "score": lambda p: score(x, c, 1.5, metric=metric, policy=p),
        "lloyd_step": lambda p: lloyd_step(x, w, c, metric=metric, policy=p),
    }
    for op, call in calls.items():
        want = call(KernelPolicy(backend="blocked"))
        got = call(KernelPolicy(backend="blocked", autotune=True))
        for a, b in zip(got, want):
            assert torch.equal(a, b), op
    keys = json.loads(cache.read_text())
    assert {k.split("/")[1] for k in keys} == set(calls)
    # the tuned Lloyd step's tile is its assignment's
    (lk,) = [k for k in keys if k.startswith("v2/lloyd_step/")]
    assert keys[lk]["block_n"] in BLOCKED_NS


def test_cuda_registrations_have_no_candidates(cache, monkeypatch):
    measured = []
    monkeypatch.setattr(dispatch, "measure_block_ns",
                        lambda *a, **k: measured.append(a))
    monkeypatch.setattr(dispatch, "measure_tiles",
                        lambda *a, **k: measured.append(a))
    for op in dispatch.OPS:
        reg = dispatch.registered_backends(op)["cuda"]
        assert reg.tune_candidates == () and reg.tune_candidates_m == ()
        # under autotune a call that resolves to cuda gets the defaults
        got = dispatch.resolve_tiles(op, KernelPolicy(autotune=True),
                                     metric="l2sq", n=300_000, m=20, d=5,
                                     platform="cuda")
        assert got[0].name == "cuda"
        assert got[1:] == dispatch.resolve_tiles(
            op, KernelPolicy(), metric="l2sq", n=300_000, m=20, d=5,
            platform="cuda")[1:]
        assert dispatch.autotune_block_n(op, "cuda", metric="l2sq",
                                         n=300_000, m=20, d=5,
                                         platform="cuda") == \
            reg.default_block_n("cuda")
    assert measured == [] and not cache.exists()
    # the blocked and int8 candidates are the reference's blocked ones
    for op in dispatch.OPS:
        want = jdispatch.registered_backends(op)["blocked"]
        for name in ("blocked", "int8") if op == "score" else ("blocked",):
            reg = dispatch.registered_backends(op)[name]
            assert reg.tune_candidates == want.tune_candidates == BLOCKED_NS
            assert reg.tune_candidates_m == want.tune_candidates_m


def test_memo_keeps_tuned_tiles_and_measures_once(cache, monkeypatch):
    real, runs = dispatch.measure_block_ns, []

    def counting(*a, **k):
        runs.append(a)
        return real(*a, **k)

    monkeypatch.setattr(dispatch, "measure_block_ns", counting)
    pol = KernelPolicy(backend="blocked", autotune=True)
    first = dispatch.resolve("min_argmin", pol, metric="l2sq", n=3000,
                             m=8, d=4)
    for _ in range(3):
        assert dispatch.resolve("min_argmin", pol, metric="l2sq", n=3000,
                                m=8, d=4) == first
    # another n in the same bucket: a memo miss, served by the cache
    dispatch.resolve("min_argmin", pol, metric="l2sq", n=2900, m=8, d=4)
    assert len(runs) == 1


def test_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_KERNELS_CACHE", raising=False)
    monkeypatch.setenv("REPRO_KERNELS_CACHE", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert dispatch.cache_dir() == tmp_path / "home" / ".cache" / \
        "repro_torch_kernels"
    assert dispatch.cache_dir() != jdispatch.cache_dir()
