"""BENCHMARK.json and the files it names: every name resolves to its
file, and the manifest keeps the limits of the benchmark's contract."""
import json
import re

import pytest

from bench.harness.spec import (BENCH, MANIFEST, ROOT, load_cell, load_json,
                                 load_metric)

MAN = load_json(MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys_and_sound_names(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) - {"workloads"} == ENTRY_KEYS[section]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_resolves_to_its_files(w):
    cell = load_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    assert w["chips"] in (1, 4)
    for m in cell.per_layer + cell.end_to_end:
        assert hasattr(load_metric(m["name"]), "read")
    assert (BENCH / "entries" / f"{cell.config['entry']}.py").exists()
    assert (BENCH / "datasets" / f"{cell.config['dataset']}.py").exists()
    assert (BENCH / "reference" / "limits" / f"{w['config']}.json").exists()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/")
        cfg = load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_bounds_and_run_length_fit_the_contract():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 180 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_every_per_layer_metric_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_limits_cover_every_config():
    from bench.reference.judge import NUMBERS, load_limits
    for c in MAN["configs"]:
        lim = load_limits(c["name"])
        assert set(lim) == set(NUMBERS) and lim["broken"] == 0


def test_files_under_paths_are_named_from_name_characters():
    bad = [p for p in BENCH.rglob("*")
           if "__pycache__" not in p.parts
           and not re.match(r"^[A-Za-z0-9_.\-/]+$",
                            str(p.relative_to(ROOT)))]
    assert not bad


def test_each_cell_reports_each_metric_it_is_named_for():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        cell = load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert sum(n.split(".")[0] == "fit_s" for n in reported) == 1
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                    [w["name"]])


def test_a_split_metric_reads_its_quantity():
    assert load_metric("fit_s.susy").read.__module__ == "bench_metrics_fit_s"
    with pytest.raises(KeyError):
        load_metric("no_such_metric.susy")
