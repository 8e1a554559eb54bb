"""``python -m repro_torch`` — execute a pipeline described by a config file.

Port of ``repro.api.cli``.  A run artifact is JSON or TOML with two
sections::

    {
      "pipeline": { ... PipelineConfig.to_dict() ... },
      "data":     {"kind": "gauss", "n_centers": 5, "per_center": 400,
                   "d": 5, "t": 25, "sigma": 0.1, "seed": 0}
    }

(A file that is itself a bare ``PipelineConfig`` dict — has a ``problem``
key — also works; data then defaults to a small gauss set matched to the
problem.)  ``data.kind`` names a ``repro_torch.data.synthetic`` generator
(``gauss`` / ``drifting_gauss`` / ``kdd_like`` / ``susy_like``); the other
keys are its keyword arguments.  The reference's artifacts
(``examples/*.json|toml``) run unchanged; an artifact's ``"pallas"``
backend reads as ``"cuda"`` (``api/config.py``).

Subcommands, each with ``--device`` (default ``cuda``; ``cpu`` runs the
plain torch path):

* ``run``         — fit the pipeline on the data, report model / comm /
                    outlier quality, optionally ``--save`` the session;
* ``serve``       — stream the data in batches through a stream/sharded
                    session (cadence refreshes), score sample queries,
                    report latency, optionally ``--checkpoint``; with
                    ``--clients N`` it then saturates the async serving
                    scheduler (``repro_torch.serve``) with N open-loop
                    client threads and reports goodput / shed rate / p99;
                    configs with a ``store`` section additionally report
                    tiered spill / page-in and skipped-refresh activity;
* ``bench-score`` — fit, then measure the query path (p50/p99 latency and
                    throughput over ``--repeat`` rounds of ``--queries``);
* ``stats``       — fit + score like ``run``, then emit the full metrics
                    snapshot (``repro_torch.obs``) as JSON or Prometheus
                    text;
* ``trace``       — fit + score through the *async serving* path, then
                    export the flight recorder as Chrome trace-event JSON
                    (Perfetto / ``chrome://tracing``) or JSON-lines.

``serve --trace-out FILE`` dumps the same Chrome trace after streaming.

``serve --metrics-interval N`` additionally emits the live snapshot as one
JSON line every ~N seconds while streaming (``--metrics-out`` to redirect
the lines to a file; default stdout).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch import obs
from repro_torch.api.config import PipelineConfig
from repro_torch.api.session import Session
from repro_torch.serve import ShedReject, estimate_capacity, run_load

_DATA_KINDS = ("gauss", "drifting_gauss", "kdd_like", "susy_like")


def load_config_file(path) -> tuple[PipelineConfig, dict]:
    """Read a JSON/TOML run artifact -> (PipelineConfig, data spec)."""
    path = Path(path)
    text = path.read_text()
    if path.suffix.lower() == ".toml":
        try:
            import tomllib
        except ImportError:  # py3.10: tomllib landed in 3.11
            raise SystemExit(
                f"{path}: TOML configs need Python >= 3.11 (tomllib); "
                f"convert to JSON or upgrade")
        raw = tomllib.loads(text)
    else:
        raw = json.loads(text)
    if not isinstance(raw, dict):
        raise SystemExit(f"{path}: expected a config object at top level")
    if "pipeline" in raw:
        pipeline = PipelineConfig.from_dict(raw["pipeline"])
        data = raw.get("data", {})
        unknown = {k for k in raw if not k.startswith("$")} - {"pipeline",
                                                               "data"}
        if unknown:
            raise SystemExit(f"{path}: unknown top-level keys "
                             f"{sorted(unknown)}")
    elif "problem" in raw:
        pipeline = PipelineConfig.from_dict(raw)
        data = {}
    else:
        raise SystemExit(f"{path}: config needs a 'pipeline' (or bare "
                         f"'problem') section")
    return pipeline, data


def make_data(pipeline: PipelineConfig, spec: dict):
    """data spec -> (x (n,d) f32, outlier_ids or None)."""
    from repro_torch.data import synthetic

    spec = dict(spec)
    kind = spec.pop("kind", "gauss")
    if kind not in _DATA_KINDS:
        raise SystemExit(f"data.kind must be one of {_DATA_KINDS}, "
                         f"got {kind!r}")
    if kind == "gauss" and not spec:
        # bare-pipeline default: a small set matched to the problem
        p = pipeline.problem
        spec = dict(n_centers=p.k, per_center=400, d=p.dim, t=p.t,
                    seed=pipeline.seed)
    out = getattr(synthetic, kind)(**spec)
    if kind == "drifting_gauss":
        x, _phases, _centers = out
        out_ids = None
    else:
        x, out_ids = out
    if x.shape[1] != pipeline.problem.dim:
        raise SystemExit(
            f"data is {x.shape[1]}-dimensional but problem.dim="
            f"{pipeline.problem.dim}; make the config sections agree")
    return np.asarray(x, np.float32), out_ids


def _sample_queries(x, out_ids, n_queries: int, seed: int):
    """Up to ``n_queries`` rows: planted outliers first, inliers after."""
    rng = np.random.default_rng(seed)
    picks = []
    if out_ids is not None and len(out_ids):
        picks.append(out_ids[: n_queries // 2])
    inliers = (np.setdiff1d(np.arange(x.shape[0]), out_ids)
               if out_ids is not None else np.arange(x.shape[0]))
    want = n_queries - sum(len(p) for p in picks)
    picks.append(rng.choice(inliers, size=min(want, len(inliers)),
                            replace=False))
    ids = np.concatenate(picks)
    flags = (np.isin(ids, out_ids) if out_ids is not None
             else np.zeros(len(ids), bool))
    return x[ids], flags


def _report_scores(results, truth) -> None:
    flagged = np.array([r.is_outlier for r in results])
    print(f"  scored {len(results)} queries: {int(flagged.sum())} flagged "
          f"as outliers (score > 1)")
    if truth is not None and truth.any():
        tp = int((flagged & truth).sum())
        print(f"  planted outliers among queries: {int(truth.sum())}, "
              f"caught: {tp}, false alarms: {int((flagged & ~truth).sum())}")


def cmd_run(args) -> None:
    pipeline, data_spec = load_config_file(args.config)
    x, out_ids = make_data(pipeline, data_spec)
    topo = pipeline.topology
    print(f"pipeline: {topo.kind} topology, k={pipeline.problem.k} "
          f"t={pipeline.problem.t} metric={pipeline.problem.metric} "
          f"summarizer={pipeline.summarizer.name!r} "
          f"kernels={pipeline.kernels.backend!r}")
    print(f"data: {x.shape[0]} points in R^{x.shape[1]}"
          + (f", {len(out_ids)} planted outliers" if out_ids is not None
             else ""))
    t0 = time.perf_counter()
    session = Session(pipeline, device=args.device)
    model = session.fit(x)
    fit_s = time.perf_counter() - t0
    print(f"fit: model v{int(model.version)} in {fit_s:.2f}s "
          f"(cost {float(model.cost):.4g}, threshold "
          f"{float(model.threshold):.4g})")
    res = session.result
    if res is not None:
        print(f"  coordinator saw {res['comm_records']:.0f} summary records "
              f"({100 * res['comm_records'] / x.shape[0]:.2f}% of the data)")
        if out_ids is not None:
            from repro_torch.core.metrics import outlier_scores
            sc = outlier_scores(out_ids, res["summary_ids"],
                                res["outlier_ids"])
            print(f"  outliers: preRec={sc.pre_recall:.3f} "
                  f"prec={sc.precision:.3f} recall={sc.recall:.3f}")
    q, truth = _sample_queries(x, out_ids, args.queries, pipeline.seed)
    _report_scores(session.score(q), truth)
    if args.save:
        step = session.save(args.save)
        print(f"saved session (config embedded) to {args.save} @ step {step}")
    print("ok")


class _MetricsEmitter:
    """Periodic JSON-lines snapshots: one ``json.dumps(session.stats())``
    line per ~interval seconds, checked at batch boundaries (the serve
    loop is synchronous).  ``interval=None`` disables; path "-" = stdout."""

    def __init__(self, interval, path):
        self.interval = interval
        self._fh = None
        self._last = time.perf_counter()
        if interval is not None and path not in (None, "-"):
            self._fh = open(path, "a")

    def emit(self, session, *, force: bool = False) -> None:
        if self.interval is None:
            return
        now = time.perf_counter()
        if not force and now - self._last < self.interval:
            return
        self._last = now
        line = json.dumps({"ts": time.time(), **session.stats()},
                          sort_keys=True)
        print(line, file=self._fh or sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()


def _report_store(session) -> None:
    """One line of tiered-store + incremental-refresh activity, printed
    only when the config has a store section (quiet otherwise)."""
    if session.config.store is None:
        return
    counters = session.stats().get("counters", {})
    skipped = sum(v for k, v in counters.items()
                  if k.startswith("refresh.skipped{"))
    warm = sum(v for k, v in counters.items()
               if k.startswith("refresh.warm_starts{"))
    st = session.store_stats()
    if st is not None:
        print(f"  store: {st['spills']} spills "
              f"({st['spill_bytes'] / 2**20:.2f} MiB out), "
              f"{st['page_ins']} page-ins "
              f"({st['page_in_bytes'] / 2**20:.2f} MiB back)")
    print(f"  refresh: {int(skipped)} skipped (root unchanged), "
          f"{int(warm)} warm-started")


def cmd_serve(args) -> None:
    pipeline, data_spec = load_config_file(args.config)
    if pipeline.topology.kind == "oneshot":
        raise SystemExit("serve needs a stream or sharded topology; "
                         "use `run` for oneshot configs")
    x, out_ids = make_data(pipeline, data_spec)
    session = Session(pipeline, device=args.device)
    emitter = _MetricsEmitter(args.metrics_interval, args.metrics_out)
    n = x.shape[0]
    print(f"serving {pipeline.topology.kind} topology: streaming {n} points "
          f"in batches of {args.batch} "
          f"(refresh every {pipeline.topology.refresh_every})")
    t0 = time.perf_counter()
    for i in range(0, n, args.batch):
        session.ingest(x[i:i + args.batch])
        emitter.emit(session)
    if session.model is None or not session.model.version:
        session.refresh()
    ingest_s = time.perf_counter() - t0
    print(f"  ingested at {n / ingest_s:.0f} pts/s; model "
          f"v{int(session.model.version)}")
    q, truth = _sample_queries(x, out_ids, args.queries, pipeline.seed)
    _report_scores(session.score(q), truth)
    stats = session.latency_stats()
    print(f"  query latency: p50 {stats['p50_ms']:.2f} ms, "
          f"p99 {stats['p99_ms']:.2f} ms over {stats['count']} requests")
    _report_store(session)
    if args.clients:
        _serve_load_phase(session, x, args)
        emitter.emit(session)
    if session.last_fit is not None:
        print(f"  last refresh: v{session.last_fit.version} fit in "
              f"{session.last_fit.fit_s * 1e3:.1f} ms on "
              f"{session.last_fit.records_folded} records; model age "
              f"{session.engine.seconds_since_install():.2f}s")
    if args.checkpoint:
        step = session.save(args.checkpoint)
        print(f"checkpointed to {args.checkpoint} @ step {step}; "
              f"Session.load() restores topology + policies from it alone")
    if args.trace_out:
        path = session.dump_trace(args.trace_out)
        print(f"wrote Chrome trace to {path} "
              f"(load in Perfetto or chrome://tracing)")
    # final snapshot after everything (incl. checkpoint metrics) happened
    emitter.emit(session, force=True)
    emitter.close()
    print("ok")


def _serve_load_phase(session, x, args) -> None:
    """``serve --clients N``: saturate the async scheduler with an
    open-loop multi-client load phase and report goodput / shed / p99."""
    sched = session.serve()
    spec = sched.spec
    rng = np.random.default_rng(session.config.seed + 7)
    queries = x[rng.choice(x.shape[0], size=min(4096, x.shape[0]),
                           replace=False)]
    offered = args.offered_rps
    if offered is None:
        cap = estimate_capacity(sched, queries, duration_s=0.3)
        offered = 1.5 * cap   # past saturation: show admission control work
        print(f"  load: capacity ~{cap:.0f} rows/s (closed-loop); "
              f"offering 1.5x = {offered:.0f} rows/s")
    print(f"  load: {args.clients} clients, {args.load_seconds}s, "
          f"queue_bound={spec.queue_bound} shed_policy={spec.shed_policy} "
          f"batch_window={spec.batch_window_ms}ms")
    rep = run_load(sched, queries, offered_rps=offered,
                   clients=args.clients, duration_s=args.load_seconds,
                   seed=session.config.seed)
    print(f"  load: offered {rep['offered_rps']:.0f} rows/s -> goodput "
          f"{rep['goodput_rps']:.0f} rows/s, shed rate "
          f"{rep['shed_rate']:.1%} ({rep['shed']}/{rep['submitted']})")
    if rep["p99_ms"] is not None:
        print(f"  load: completed-request latency p50 {rep['p50_ms']:.2f} ms"
              f", p99 {rep['p99_ms']:.2f} ms")
    session.close()


def cmd_bench_score(args) -> None:
    pipeline, data_spec = load_config_file(args.config)
    x, _ = make_data(pipeline, data_spec)
    session = Session(pipeline, device=args.device)
    session.fit(x)
    rng = np.random.default_rng(pipeline.seed)
    lat = []
    scored = 0
    t0 = time.perf_counter()
    for _ in range(args.repeat):
        q = x[rng.choice(x.shape[0], size=args.queries, replace=True)]
        t1 = time.perf_counter()
        results = session.score(q)
        lat.append(time.perf_counter() - t1)
        scored += len(results)
    wall = time.perf_counter() - t0
    per_batch = np.asarray(lat)
    print(f"bench-score [{pipeline.topology.kind}]: {scored} queries in "
          f"{wall:.2f}s = {scored / wall:.0f} q/s")
    print(f"  batch({args.queries}) p50 {np.percentile(per_batch, 50) * 1e3:.2f} ms, "
          f"p99 {np.percentile(per_batch, 99) * 1e3:.2f} ms")
    stats = session.latency_stats()
    print(f"  per-request p50 {stats['p50_ms']:.2f} ms, "
          f"p99 {stats['p99_ms']:.2f} ms")
    print("ok")


def cmd_stats(args) -> None:
    """Exercise the pipeline end to end, then emit the telemetry snapshot
    — the quickest way to see every metric the layers report."""
    pipeline, data_spec = load_config_file(args.config)
    x, out_ids = make_data(pipeline, data_spec)
    session = Session(pipeline, device=args.device)
    session.fit(x)
    q, _ = _sample_queries(x, out_ids, args.queries, pipeline.seed)
    session.score(q)
    snap = session.stats()
    if args.format == "prom":
        out = obs.render_prometheus(snap)
    else:
        out = json.dumps(snap, indent=2, sort_keys=True) + "\n"
    if args.out in (None, "-"):
        sys.stdout.write(out)
    else:
        Path(args.out).write_text(out)
        print(f"wrote {args.format} snapshot to {args.out}")


def cmd_trace(args) -> None:
    """Exercise the pipeline end to end *through the async serving
    scheduler*, then export the flight recorder — the quickest way to a
    Perfetto-loadable timeline of ingest -> refresh -> stitched serve
    requests (admission / queue wait / tick / fused score / drain)."""
    pipeline, data_spec = load_config_file(args.config)
    x, out_ids = make_data(pipeline, data_spec)
    session = Session(pipeline, device=args.device)
    if args.sample_rate is not None:
        # CLI override wins over the artifact's tracing section
        obs.configure_tracing(sample_rate=args.sample_rate)
    session.fit(x)
    q, truth = _sample_queries(x, out_ids, args.queries, pipeline.seed)
    results = list(session.score_stream(q, timeout=120.0))
    session.close()
    scored = [r for r in results if not isinstance(r, ShedReject)]
    _report_scores(scored, truth if len(scored) == len(results) else None)
    stats = obs.get_default_recorder().snapshot_section()
    print(f"  flight recorder: {stats['recorded']} spans across "
          f"{stats['traces']} traces (sample_rate={stats['sample_rate']}, "
          f"dropped={stats['dropped']})")
    path = session.dump_trace(args.out, fmt=args.format)
    print(f"wrote {args.format} trace to {path}"
          + (" (load in Perfetto or chrome://tracing)"
             if args.format == "chrome" else ""))
    print("ok")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Execute a declarative clustering pipeline config.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="fit a config on its data and report")
    p_run.add_argument("--config", required=True, help="JSON/TOML artifact")
    p_run.add_argument("--queries", type=int, default=64,
                       help="sample queries to score after the fit")
    p_run.add_argument("--save", default=None,
                       help="directory to checkpoint the fitted session")
    p_run.add_argument("--device", default="cuda",
                       help="torch device to run on (cuda, cpu)")
    p_run.set_defaults(fn=cmd_run)

    p_srv = sub.add_parser("serve",
                           help="stream the data through a stream/sharded "
                                "session and report latency")
    p_srv.add_argument("--config", required=True)
    p_srv.add_argument("--batch", type=int, default=2048,
                       help="ingest batch size (cadence refreshes apply)")
    p_srv.add_argument("--queries", type=int, default=64)
    p_srv.add_argument("--checkpoint", default=None,
                       help="directory to checkpoint the serving session")
    p_srv.add_argument("--metrics-interval", type=float, default=None,
                       metavar="SECONDS",
                       help="emit the live metrics snapshot as one JSON "
                            "line every ~N seconds while streaming")
    p_srv.add_argument("--metrics-out", default="-",
                       help="destination for --metrics-interval lines "
                            "(file path, or '-' for stdout)")
    p_srv.add_argument("--clients", type=int, default=0,
                       help="after streaming, drive the async serving "
                            "scheduler with N open-loop client threads and "
                            "report goodput / shed rate / p99 (0 = skip)")
    p_srv.add_argument("--load-seconds", type=float, default=2.0,
                       help="duration of the --clients load phase")
    p_srv.add_argument("--offered-rps", type=float, default=None,
                       help="offered load (rows/s) for the --clients phase; "
                            "default: 1.5x a measured capacity estimate")
    p_srv.add_argument("--trace-out", default=None, metavar="FILE",
                       help="after streaming, dump the flight recorder as "
                            "Chrome trace-event JSON to FILE")
    p_srv.add_argument("--device", default="cuda",
                       help="torch device to run on (cuda, cpu)")
    p_srv.set_defaults(fn=cmd_serve)

    p_bs = sub.add_parser("bench-score", help="measure the query path")
    p_bs.add_argument("--config", required=True)
    p_bs.add_argument("--queries", type=int, default=256,
                      help="queries per round")
    p_bs.add_argument("--repeat", type=int, default=20, help="rounds")
    p_bs.add_argument("--device", default="cuda",
                      help="torch device to run on (cuda, cpu)")
    p_bs.set_defaults(fn=cmd_bench_score)

    p_st = sub.add_parser("stats",
                          help="fit + score a config, then emit the full "
                               "repro_torch.obs metrics snapshot")
    p_st.add_argument("--config", required=True)
    p_st.add_argument("--queries", type=int, default=64,
                      help="sample queries to score before the snapshot")
    p_st.add_argument("--format", choices=("json", "prom"), default="json",
                      help="snapshot encoding (plain JSON or Prometheus "
                           "exposition text)")
    p_st.add_argument("--out", default="-",
                      help="file path, or '-' for stdout")
    p_st.add_argument("--device", default="cuda",
                      help="torch device to run on (cuda, cpu)")
    p_st.set_defaults(fn=cmd_stats)

    p_tr = sub.add_parser("trace",
                          help="fit + score a config through the async "
                               "serving path, then export the flight "
                               "recorder (Chrome trace / JSONL)")
    p_tr.add_argument("--config", required=True)
    p_tr.add_argument("--queries", type=int, default=64,
                      help="sample queries to score through score_stream")
    p_tr.add_argument("--format", choices=("chrome", "jsonl"),
                      default="chrome", help="trace encoding")
    p_tr.add_argument("--sample-rate", type=float, default=None,
                      help="head-sampling rate override (default: the "
                           "config's tracing section, else 1.0)")
    p_tr.add_argument("--out", default="trace.json",
                      help="output file path")
    p_tr.add_argument("--device", default="cuda",
                      help="torch device to run on (cuda, cpu)")
    p_tr.set_defaults(fn=cmd_trace)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
