"""A cell of ``BENCHMARK.json``, resolved by name to its files.

Nothing here knows a particular cell: a workload names a configuration and
a traffic mix, and each is a JSON file found by its name
(``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``); the
metrics a run reports are the manifest's, selected by the cell's name.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass(frozen=True)
class Cell:
    workload: str
    chips: int
    config_name: str
    config: dict        # bench/configs/<config>.json as it is run
    traffic: dict       # bench/traffic/<traffic>.json
    end_to_end: tuple   # the manifest's end-to-end metric entries of the cell
    per_layer: tuple    # the manifest's per-layer metric entries of the cell


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, manifest: Path = MANIFEST) -> Cell:
    """The cell named ``workload`` with its configuration, traffic and
    metrics; raises KeyError for a name the manifest does not have."""
    man = load_json(manifest)
    by_name = {w["name"]: w for w in man["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in {manifest.name}; "
                       f"have {sorted(by_name)}")
    w = by_name[workload]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    return Cell(
        workload=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        end_to_end=tuple(m for m in man["end_to_end"]
                         if _applies(m, workload)),
        per_layer=tuple(m for m in man["per_layer"] if _applies(m, workload)),
    )


@functools.cache
def load_named(kind: str, name: str):
    """The module ``bench/<kind>/<name>.py`` (a metric reader, an entry, a
    dataset, an op's work count): found by its name, so a later cell adds a
    file and edits none.  Loaded once a process; raises KeyError naming the
    missing file."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader of metric ``name``: ``bench/metrics/<name>.py``, or, for a
    metric split by the end-to-end metric it moves (``fit_s.susy``,
    ``site_summary_ms.susy``), the reader of its quantity, the name before
    the first dot, which reads the same thing in every cell."""
    if (BENCH / "metrics" / f"{name}.py").exists():
        return load_named("metrics", name)
    return load_named("metrics", name.split(".")[0])
