"""A small fit run end to end through the harness on the CPU, and the
command's refusals."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from bench.harness.runner import run_cell
from bench.harness.spec import ROOT
from bench.tests.small import SMALL_LIMITS, small_cell


def _run(workload, trace, seconds=1.0, seed=2**31 + 7, **over):
    res, lines = run_cell(small_cell(workload, **over), seed, seconds, trace,
                          "cpu", time.perf_counter(), SMALL_LIMITS)
    json.dumps(res)                       # the last line must serialise
    return res, lines


@pytest.mark.parametrize("workload", ["kdd.fit", "susy.fit"])
def test_small_cell_runs_and_is_correct(workload):
    res, lines = _run(workload, trace=False)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    fit_s = {"kdd.fit": "fit_s", "susy.fit": "fit_s.susy"}[workload]
    assert set(res["metrics"]) == {fit_s, "records_per_fit", "setup_s"}
    assert res["metrics"][fit_s]["value"] > 0
    assert res["metrics"]["records_per_fit"]["value"] > 0
    assert list(res)[-1] == "check"
    assert lines[-1].startswith("check center_step")
    assert res["device"]["platform"] == "cpu"


def test_traced_small_cell_reports_the_span_metrics():
    res, lines = _run("kdd.fit", trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    # the CPU launches no CUDA kernel: the device metrics read nothing
    assert {"site_summary_ms", "second_level_ms"} <= set(m)
    assert not {"min_argmin_roofline", "lloyd_step_roofline",
                "launches_per_fit", "gather_ms"} & set(m)
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any(line.startswith("trace op calls") for line in lines)


def test_four_site_cell_runs_on_four_gloo_ranks():
    res, _ = _run("kdd4.fit", trace=False, seconds=0.5)
    assert res["correct"] is True
    assert res["device"]["count"] == 4
    assert res["metrics"]["records_per_fit"]["value"] > 0
    assert res["metrics"]["fit_s.kdd4"]["value"] > 0
    assert res["ranks_differ"] == 0


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kdd.fit", "--seed",
         "1", "--seconds", "1", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300)


def test_command_without_a_card_prints_no_result():
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
