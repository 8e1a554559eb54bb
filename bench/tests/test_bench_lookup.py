"""Every table of the harness is a lookup by name: a configuration's
limits, its dataset, its entry's kernels and each op's work count are
files found by their names, and a new configuration enters the benchmark
as new files alone."""
import hashlib
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench.harness import program
from bench.harness.data import make_data
from bench.harness.runner import build_kernels
from bench.harness.spec import BENCH, MANIFEST, ROOT, load_json
from bench.harness.work import op_work
from bench.reference import judge

# The limits each configuration had in the one file of all limits that
# these files replaced, digit for digit.
LIMITS = {
    "kddfull": {"broken": 0, "moved_share": 0.0003, "cost_gap": 1e-05,
                "center_step": 0.1},
    "susy-d5": {"broken": 0, "moved_share": 5e-05, "cost_gap": 1e-06,
                "center_step": 0.2},
    "kddfull-4site": {"broken": 0, "moved_share": 0.0003, "cost_gap": 3e-06,
                      "center_step": 0.1},
}

# SHA-256 of the rows and the planted flags of small CPU draws (torch 2.13
# on the CPU), taken from the generators before they moved to
# bench/datasets: the move changed no row.
ROWS = {
    "kddfull": ({"n": 5_000},
                "8d309eb28b58df6a6678a2a113447c63da0cc304b82caae090e476df62a97a92"),
    "susy-d5": ({"n": 5_000, "dataset_args": {"t": 50, "delta": 5.0}},
                "053e7fea6df219278d06d46aacb6307fd2b622610623e235b9d1573b7e292e4e"),
    "kddfull-4site": ({"n": 4_000},
                      "550519961c861a9ece30d6810ad84a0e59832ad4c725f6ced0b6b3cdaa1a6fc8"),
}


def _config(name, **over):
    return dict(load_json(BENCH / "configs" / f"{name}.json"), **over)


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_limits_are_read_from_the_configurations_file(name):
    assert judge.load_limits(name) == LIMITS[name]
    assert (BENCH / "reference" / "limits" / f"{name}.json").exists()


@pytest.mark.parametrize("name", sorted(ROWS))
def test_rows_are_those_of_the_generators_before_the_move(name):
    over, want = ROWS[name]
    x, truth = make_data(_config(name, **over), 2**31 + 12345, "cpu")
    h = hashlib.sha256(x.numpy().tobytes())
    h.update(truth.numpy().tobytes())
    assert h.hexdigest() == want


@pytest.mark.parametrize("lookup, missing", [
    (lambda: judge.load_limits("no-such-config"),
     "reference/limits/no-such-config.json"),
    (lambda: make_data({"dataset": "no_such_dataset", "n": 10, "d": 2}, 1,
                       "cpu"), "datasets/no_such_dataset.py"),
    (lambda: op_work("no_such_op", [(1, 1)], 4), "work/no_such_op.py"),
    (lambda: program.make_fit({"entry": "no_such_entry"},
                              torch.zeros((1, 1)), "cpu"),
     "entries/no_such_entry.py"),
], ids=["limits", "dataset", "op", "entry"])
def test_an_unknown_name_raises_naming_the_missing_file(lookup, missing):
    with pytest.raises(KeyError, match=missing):
        lookup()


def test_build_kernels_warms_through_the_entry(monkeypatch):
    cfg = _config("kddfull")
    calls = []
    monkeypatch.setattr(program.entry(cfg), "warm",
                        lambda device, d: calls.append((device.type, d)))
    assert build_kernels(torch.device("cpu"), cfg) >= 0
    assert calls == [("cpu", 34)]


# A fourth configuration and its cell, made of new files only: a dataset,
# an entry that reads only the keys it needs, a configuration, its limits,
# and the manifest's new entries.
NEW_FILES = {
    "datasets/gauss_like.py": '''
"""Dataset ``gauss_like``: Table 2's mixture of n_centers Gaussians in
[0, 1]^d, t rows shifted by U[-2, 2]^d."""
import torch


def make(n, d, gen, device, n_centers, sigma, t):
    centers = torch.rand((n_centers, d), generator=gen, device=device)
    labels = torch.arange(n, device=device) % n_centers
    x = centers[labels] + sigma * torch.randn((n, d), generator=gen,
                                              device=device)
    out = torch.randperm(n, generator=gen, device=device)[:t]
    x[out] += torch.rand((t, d), generator=gen, device=device) * 4.0 - 2.0
    truth = torch.zeros((n,), dtype=torch.bool, device=device)
    truth[out] = True
    return x, truth
''',
    "entries/one_process_defaults.py": '''
"""Entry ``one_process_defaults``: Algorithm 3's sites in one process,
with the port's own defaults for all but k, t and the sites."""
import torch


def make_fit(cfg, x, device):
    from repro_torch.core import simulate_coordinator
    from repro_torch.core.sampler import TorchSampler
    parts = torch.tensor_split(x, int(cfg["sites"]))

    def fit(seed):
        res = simulate_coordinator(parts, TorchSampler(seed), k=int(cfg["k"]),
                                   t=int(cfg["t"]), device=device)
        keys = ("summary_ids", "summary_weights", "summary_candidates",
                "centers", "outlier_ids", "cost", "comm_records", "phase_s")
        return {k: res[k] for k in keys}
    return fit
''',
    "configs/gauss-small.json": json.dumps({
        "name": "gauss-small", "entry": "one_process_defaults",
        "dataset": "gauss_like", "n": 20_000, "d": 5,
        "dataset_args": {"n_centers": 10, "sigma": 0.1, "t": 100},
        "k": 10, "t": 100, "sites": 4}),
    "reference/limits/gauss-small.json": json.dumps({
        "broken": 0, "moved_share": 1e-3, "cost_gap": 1e-5,
        "center_step": 0.1}),
}


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_is_new_files_only(tmp_path):
    shutil.copy(MANIFEST, tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    for rel, text in NEW_FILES.items():
        path = tmp_path / "bench" / rel
        assert not path.exists()
        path.write_text(text.lstrip())
    man = load_json(tmp_path / "BENCHMARK.json")
    man["configs"].append({
        "name": "gauss-small", "source": "https://arxiv.org/abs/1805.09495",
        "file": "bench/configs/gauss-small.json", "reduced": [],
        "why": "a fourth configuration"})
    man["workloads"].append({"name": "gauss.fit", "config": "gauss-small",
                             "traffic": "fits", "chips": 1,
                             "why": "a cell of new files"})
    man["end_to_end"].append({"name": "fit_s.gauss", "unit": "s",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["gauss.fit"]})
    man["per_layer"].append({
        "name": "site_summary_ms.gauss", "unit": "ms", "better": "lower",
        "source": "program_span",
        "layer": "core.summary and core.augmented: site summaries",
        "moves": "fit_s.gauss", "workloads": ["gauss.fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man, indent=1))

    code = (
        "import json, sys, time\n"
        "sys.path[:0] = [%r, %r]\n"
        "from bench.harness.runner import run_cell\n"
        "from bench.harness.spec import load_cell\n"
        "res, lines = run_cell(load_cell('gauss.fit'), 2**31 + 5, 1.0, "
        "False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(res))\n" % (str(tmp_path), str(ROOT / "src")))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert set(res["metrics"]) == {"fit_s.gauss", "records_per_fit",
                                   "setup_s"}
    assert res["metrics"]["fit_s.gauss"]["value"] > 0

    after = _digests(tmp_path)
    changed = {rel for rel in before if after.get(rel) != before[rel]}
    assert changed == {"BENCHMARK.json"}
    old, new = load_json(MANIFEST), load_json(tmp_path / "BENCHMARK.json")
    added = ("configs", "workloads", "end_to_end", "per_layer")
    for key in old:             # the manifest's entries were added to only
        assert (new[key][:len(old[key])] if key in added
                else new[key]) == old[key]
