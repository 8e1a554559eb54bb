"""``python -m repro_torch`` (``api/cli.py``) on the CPU, against the
reference's CLI.

Each ``examples/`` artifact runs unchanged through ``main([...,
"--device", "cpu"])`` and prints the reference's lines — the same lines
with every number masked (the draws differ: the CLI runs the port's own
sampler) — ending in ``ok``.  ``run --save`` round-trips through
``Session.load``; bad artifacts are rejected with the reference's
``SystemExit`` messages.  ``stats``, ``trace`` and ``serve --clients /
--metrics-interval / --metrics-out / --trace-out`` print the reference's
lines too, and the snapshots and traces they write pass the reference's
stdlib checkers (``benchmarks/check_obs_snapshot.py``,
``benchmarks/check_trace.py``) unchanged.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import obs as jobs
from repro.api.cli import main as jax_main
from repro_torch import obs as tobs
from repro_torch.api import Session, pipeline_config
from repro_torch.api.cli import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)(e[-+]?\d+)?")


def _lines(text):
    return [NUMBER.sub("#", ln) for ln in text.strip().splitlines()]


@pytest.mark.parametrize("cmd,artifact", [
    ("run", "oneshot.json"),
    ("serve", "stream.toml"),
    ("serve", "stream_store.json"),
    ("bench-score", "oneshot.json"),
])
def test_examples_print_the_references_lines(cmd, artifact, capsys):
    args = [cmd, "--config", str(EXAMPLES / artifact)]
    if cmd == "bench-score":
        args += ["--repeat", "3"]
    main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    jax_main(args)
    want = capsys.readouterr().out
    assert got.strip().splitlines()[-1] == "ok"
    assert _lines(got) == _lines(want)


def test_run_save_and_load_round_trip(tmp_path, capsys):
    artifact = {
        "pipeline": pipeline_config(dim=3, k=4, t=12, sites=2).to_dict(),
        "data": {"kind": "gauss", "n_centers": 4, "per_center": 250,
                 "d": 3, "t": 12, "sigma": 0.1, "seed": 0},
    }
    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps(artifact))
    save_dir = tmp_path / "ckpt"
    main(["run", "--config", str(cfg_path), "--queries", "16",
          "--save", str(save_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "outliers:" in out and out.strip().endswith("ok")
    restored = Session.load(save_dir, device="cpu")
    assert restored.config.topology.sites == 2
    assert int(restored.model.version) == 1
    assert len(restored.score(torch.zeros((3, 3)).numpy())) == 3


def test_serve_checkpoint_and_bare_pipeline_file(tmp_path, capsys):
    # a bare PipelineConfig dict: data defaults to a gauss set matched to it
    cfg = pipeline_config(dim=3, k=4, t=12, topology="stream",
                          leaf_size=256, refresh_every=512)
    p = tmp_path / "bare.json"
    p.write_text(cfg.to_json())
    main(["serve", "--config", str(p), "--batch", "300",
          "--checkpoint", str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "checkpointed to" in out and out.strip().endswith("ok")
    assert Session.load(tmp_path / "ck", device="cpu").config == cfg


def test_cli_rejects_bad_artifacts(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"nope": 1}))
    with pytest.raises(SystemExit, match="pipeline"):
        main(["run", "--config", str(p), "--device", "cpu"])
    p.write_text(json.dumps({
        "pipeline": pipeline_config(dim=4, k=3, t=5).to_dict(),
        "data": {"kind": "gauss", "d": 3, "n_centers": 3, "per_center": 50,
                 "t": 5},
    }))
    with pytest.raises(SystemExit, match="dim"):
        main(["run", "--config", str(p), "--device", "cpu"])
    p.write_text(json.dumps({
        "pipeline": pipeline_config(dim=3, k=3, t=5).to_dict(),
        "data": {"kind": "blobs"}}))
    with pytest.raises(SystemExit, match="data.kind"):
        main(["run", "--config", str(p), "--device", "cpu"])
    p.write_text(json.dumps({
        "pipeline": pipeline_config(dim=3, k=3, t=5).to_dict(),
        "extra": {}}))
    with pytest.raises(SystemExit, match="unknown top-level keys"):
        main(["run", "--config", str(p), "--device", "cpu"])
    with pytest.raises(SystemExit, match="stream or sharded"):
        main(["serve", "--config", str(EXAMPLES / "oneshot.json"),
              "--device", "cpu"])


OUTPUTS = ("m.jsonl", "s.json", "t.json")


def check(script, *args):
    """Run one of the reference's stdlib checkers on a file; its exit code
    and output."""
    out = subprocess.run([sys.executable, str(ROOT / "benchmarks" / script),
                          *map(str, args)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    return out.returncode, out.stdout + out.stderr


def _run_both(argv, tmp_path, capsys):
    """``argv`` through the port's CLI (on the CPU) and the reference's,
    each under fresh metrics registries and writing its files into its own
    directory; returns {"port"|"ref": (stdout with the directory masked,
    directory)}."""
    outs = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]),
                            ("ref", jax_main, [])):
        d = tmp_path / name
        d.mkdir()
        args = [str(d / a) if a in OUTPUTS
                else str(EXAMPLES / a) if a.endswith((".toml", ".json"))
                else a for a in argv]
        with tobs.using_registry(tobs.MetricsRegistry()), \
                jobs.using_registry(jobs.MetricsRegistry()):
            fn(args + extra)
        outs[name] = (capsys.readouterr().out.replace(str(d), "DIR"), d)
    return outs


def _names(snap):
    return {kind: {tobs.split_key(k)[0] for k in snap[kind]}
            for kind in ("counters", "gauges", "histograms")}


@pytest.mark.parametrize("argv", [
    ["serve", "--config", "stream.toml", "--clients", "2",
     "--load-seconds", "0.5"],
    ["serve", "--config", "stream.toml", "--metrics-interval", "0",
     "--metrics-out", "m.jsonl"],
    ["serve", "--config", "stream.toml", "--trace-out", "t.json"],
    ["stats", "--config", "oneshot.json", "--out", "s.json"],
    ["trace", "--config", "oneshot.json", "--out", "t.json"],
])
def test_queue4_commands_and_flags_exit_naming_the_queue(argv, tmp_path,
                                                         capsys):
    """The commands and flags that exited naming queue 4 before the
    telemetry plane and the scheduler were ported: each now prints the
    reference CLI's lines (numbers masked), and the files it writes pass
    the reference's checkers."""
    outs = _run_both(argv, tmp_path, capsys)
    got, d = outs["port"]
    assert _lines(got) == _lines(outs["ref"][0])
    if argv[0] == "serve":
        assert got.strip().splitlines()[-1] == "ok"
    if "m.jsonl" in argv:
        lines = (d / "m.jsonl").read_text().splitlines()
        ref = (outs["ref"][1] / "m.jsonl").read_text().splitlines()
        assert len(lines) == len(ref) > 1
        (d / "last.json").write_text(lines[-1])
        rc, msg = check("check_obs_snapshot.py", "--snapshot",
                        d / "last.json", "--require", "serve.latency",
                        "--require", "phase.ingest")
        assert rc == 0, msg
    if "s.json" in argv:
        snap = json.loads((d / "s.json").read_text())
        assert _names(snap) == _names(
            json.loads((outs["ref"][1] / "s.json").read_text()))
        rc, msg = check("check_obs_snapshot.py", "--snapshot", d / "s.json",
                        "--require", "serve.latency", "--require",
                        "comm.records", "--require", "kernels.dispatch",
                        "--require", "phase.oneshot.second_level")
        assert rc == 0, msg
    if "t.json" in argv:
        need = (["serve.request", "serve.tick", "score.fused"]
                if argv[0] == "trace" else ["ingest.request", "refresh.fit"])
        rc, msg = check("check_trace.py", d / "t.json",
                        *[a for n in need for a in ("--require", n)])
        assert rc == 0, msg


def test_stats_prom_and_trace_jsonl(tmp_path, capsys):
    """``stats --format prom`` renders the snapshot as Prometheus text and
    ``trace --format jsonl`` writes one JSON record per span, as the
    reference's do."""
    with tobs.using_registry(tobs.MetricsRegistry()):
        main(["stats", "--config", str(EXAMPLES / "oneshot.json"),
              "--format", "prom", "--out", str(tmp_path / "p.txt"),
              "--device", "cpu"])
        main(["trace", "--config", str(EXAMPLES / "oneshot.json"),
              "--format", "jsonl", "--sample-rate", "0.5",
              "--out", str(tmp_path / "t.jsonl"), "--device", "cpu"])
        assert tobs.get_default_recorder().sample_rate == 0.5
    out = capsys.readouterr().out
    assert "wrote prom snapshot" in out and out.strip().endswith("ok")
    prom = (tmp_path / "p.txt").read_text()
    assert "# TYPE serve_latency histogram" in prom
    recs = [json.loads(ln)
            for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert recs and {"trace_id", "span_id", "parent_id", "ts",
                     "dur_s"} <= set(recs[0])


def test_python_dash_m_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--config",
         str(EXAMPLES / "oneshot.json"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert "jax" not in out.stderr


def test_serve_a_sharded_copy_of_the_stream_example(tmp_path, capsys):
    """``examples/stream.toml`` with ``kind = "sharded"`` and ``sites = 4``
    (what its own comment suggests): ``python -m repro_torch serve`` ends
    in ``ok`` and prints the reference CLI's lines."""
    text = (EXAMPLES / "stream.toml").read_text()
    assert 'kind = "stream"' in text
    p = tmp_path / "sharded.toml"
    p.write_text(text.replace('kind = "stream"',
                              'kind = "sharded"\nsites = 4'))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--config", str(p),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert "serving sharded topology" in out.stdout
    jax_main(["serve", "--config", str(p)])
    assert _lines(out.stdout) == _lines(capsys.readouterr().out)
