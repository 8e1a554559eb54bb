"""One verb set over every topology: the ``Session`` facade.

Port of ``repro.api.session``.  ``Session(config)`` builds and drives the
layer the config's topology names — ``simulate_coordinator`` /
``distributed_cluster`` (oneshot, through :class:`OneshotEngine`),
``StreamService`` (stream) or ``ShardedStreamService`` (sharded) — behind
one interface:

    fit(points)      ingest + refresh in one call; returns the ModelState
    ingest(points)   feed raw points (stream topologies refresh on cadence)
    refresh()        (re)fit the serving model on everything ingested
    score(queries)   nearest-center distance / outlier score per query row
    save(dir)        checkpoint everything, config embedded in the manifest
    Session.load(dir)  rebuild topology + policies from the manifest alone

The facade adds **no math of its own**: the stream topologies delegate
verbs verbatim to the services, and the oneshot engine calls the same
coordinator entry points a direct caller would, with the same sampler
(``TorchSampler(config.seed)`` unless a ``sampler`` is given: the tests
pass ``JaxReplaySampler(jax.random.key(seed))``, the reference's draws).
Samplers are values, so every oneshot refresh starts from the same one
and refreshing twice with no new data gives the same model bit for bit.

Oneshot scoring: the coordinator returns centers and outlier ids but no
serving model, so after the fit the engine derives one with the rule the
stream service uses (threshold = the largest inlier distance among the
summary records); queries then flow through ``ServingFrontEnd``'s
micro-batched read path, giving both topologies the same ``QueryResult``
surface and latency accounting.  ``save`` / ``load`` write the
reference's ``oneshot-session-v1`` layout leaf for leaf (and a stream or
sharded session the service's), so a checkpoint of either package's
``Session`` loads in the other's.

``topology.use_shard_map`` runs the oneshot fit as a collective: every
rank of an initialized ``torch.distributed`` group of ``sites`` ranks
(``repro_torch.core.collective.init_sites``) drives its own ``Session``
on the same rows, and ``distributed_cluster`` copies only the rank's own
block to its device.

Serving under concurrent clients: ``serve()`` attaches the
continuous-batching scheduler (``repro_torch.serve.ServingScheduler``,
configured by ``config.serving``); ``score_stream`` / ``submit_stream``
admit rows from any thread, and once a scheduler is attached the
synchronous verbs take its ``engine_lock``.  ``stats()`` is the process
metrics snapshot and ``dump_trace`` writes the flight recorder
(``repro_torch.obs``); a config's ``tracing`` section configures that
recorder.  Entry points take ``device=`` and default to ``"cuda"``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device
from repro_torch.api.config import PipelineConfig
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.collective import sites_group
from repro_torch.core.distributed import (distributed_cluster,
                                          simulate_coordinator)
from repro_torch.core.sampler import Sampler, TorchSampler
from repro_torch.kernels.pdist.ops import min_argmin
from repro_torch.serve.scheduler import (ScoreTicket, ServingScheduler,
                                         ShedReject)
from repro_torch.stream.service import (ModelState, QueryResult,
                                        ServiceConfig, ServingFrontEnd,
                                        StreamService)
from repro_torch.stream.sharded import ShardedStreamService

RESULT_KEYS = ("centers", "outlier_ids", "summary_ids", "summary_weights",
               "comm_records", "cost")


class OneshotEngine(ServingFrontEnd):
    """Algorithm 3 behind the serving-front-end verb set.

    ``ingest`` accumulates raw rows; ``refresh`` runs the coordinator on
    everything accumulated (a pure function of the ingested points and the
    sampler — refreshing twice with no new data reproduces the same model
    bit for bit); the inherited read path serves queries on ``device``.
    The coordinator result (the reference's six keys: centers, outlier
    ids, summary ids and weights, communication, cost) stays available as
    ``.result``.
    """

    _topology = "oneshot"

    def __init__(self, pipeline: PipelineConfig, *, device="cuda",
                 sampler: Optional[Sampler] = None):
        topo = pipeline.topology
        if topo.kind != "oneshot":
            raise ValueError(f"OneshotEngine needs topology.kind='oneshot', "
                             f"got {topo.kind!r}")
        p = pipeline.problem
        # ServingFrontEnd only needs the shared serving knobs; reusing the
        # stream dataclass keeps the read/checkpoint glue identical
        super().__init__(ServiceConfig(
            dim=p.dim, k=p.k, t=p.t, metric=p.metric,
            micro_batch=topo.micro_batch, second_iters=pipeline.second_iters,
            policy=pipeline.kernels, summarizer=pipeline.summarizer,
            seed=pipeline.seed), device)
        self.pipeline = pipeline
        self.sampler = (sampler if sampler is not None
                        else TorchSampler(pipeline.seed))
        self._rows: list[np.ndarray] = []
        self.result: Optional[dict] = None

    # ------------------------------------------------------------ write path
    def ingest(self, points, weights=None) -> None:
        self.poll_refresh()
        x, w = self._validate_points(points, weights)
        if w is not None:
            raise ValueError("oneshot topology clusters raw (unit-weight) "
                             "points; weighted records are a stream concept")
        self._rows.append(x)

    @property
    def total_ingested(self) -> int:
        return int(sum(r.shape[0] for r in self._rows))

    def _root_records(self) -> int:
        # the oneshot "root" is every raw row the coordinator will see
        return self.total_ingested

    # ------------------------------------------------------------ refresh fit
    def _fit_closure(self, version: int):
        if not self._rows:
            raise RuntimeError("refresh() before any point was ingested")
        x = (self._rows[0] if len(self._rows) == 1
             else np.concatenate(self._rows))
        self._rows = [x]          # compact the buffer while we have it
        return functools.partial(self._fit, x, version)

    def _fit(self, x: np.ndarray, version: int) -> ModelState:
        # one host->card copy of the rows, but under use_shard_map, where
        # each rank copies only its own block (distributed_cluster)
        xd = (x if self.pipeline.topology.use_shard_map
              else torch.as_tensor(x, device=self.device))
        res = _run_oneshot(xd, self.pipeline, device=self.device,
                           sampler=self.sampler)
        self.result = {k: res[k] for k in RESULT_KEYS}
        return _model_from_result(xd, res, self.pipeline, version,
                                  device=self.device)

    # ------------------------------------------------------------ checkpoint
    def _result_arrays(self) -> dict:
        r = self.result or {}
        return {
            "summary_ids": np.asarray(
                r.get("summary_ids", np.zeros(0)), np.int64),
            "summary_weights": np.asarray(
                r.get("summary_weights", np.zeros(0)), np.float32),
            "outlier_ids": np.asarray(
                r.get("outlier_ids", np.zeros(0)), np.int64),
            "comm_records": np.float64(r.get("comm_records", 0.0)),
        }

    def save(self, manager: CheckpointManager, step: int, *,
             blocking: bool = True, extra_meta: Optional[dict] = None) -> None:
        self.join_refresh()
        x = (np.concatenate(self._rows) if self._rows
             else np.zeros((0, self.cfg.dim), np.float32))
        r = self.result
        n_sum = 0 if r is None else len(r["summary_ids"])
        n_out = 0 if r is None else len(r["outlier_ids"])
        state = {"x": x, "model": self._model_arrays(),
                 "result": self._result_arrays(),
                 "counters": {"next_id": np.int64(self._next_id)}}
        manager.save(step, state, blocking=blocking,
                     meta={**(extra_meta or {}),
                           "format": "oneshot-session-v1",
                           "n_rows": int(x.shape[0]),
                           "n_summary": n_sum, "n_outliers": n_out})

    @classmethod
    def restore(cls, pipeline: PipelineConfig, manager: CheckpointManager,
                step: int | None = None, *, device="cuda",
                sampler: Optional[Sampler] = None) -> "OneshotEngine":
        meta = manager.read_meta(step)
        fmt = meta.get("format")
        if fmt != "oneshot-session-v1":
            raise ValueError(
                f"checkpoint format {fmt!r} is not a oneshot session "
                f"checkpoint — restore it with the layer that wrote it")
        eng = cls(pipeline, device=device, sampler=sampler)
        n_sum, n_out = int(meta["n_summary"]), int(meta["n_outliers"])
        skel = {"x": np.zeros((int(meta["n_rows"]), pipeline.problem.dim),
                              np.float32),
                "model": eng._model_skeleton(eng.cfg),
                "result": {"summary_ids": np.zeros(n_sum, np.int64),
                           "summary_weights": np.zeros(n_sum, np.float32),
                           "outlier_ids": np.zeros(n_out, np.int64),
                           "comm_records": np.float64(0)},
                "counters": {"next_id": np.int64(0)}}
        state, _ = manager.restore(skel, step)
        x = np.asarray(state["x"], np.float32)
        eng._rows = [x] if x.shape[0] else []
        eng._next_id = int(state["counters"]["next_id"])
        eng._install_model_arrays(state["model"])
        if eng.model is not None:   # a fit happened: rebuild .result from
            r = state["result"]     # the persisted arrays + the model
            eng.result = {
                "centers": eng.model.centers.cpu().numpy(),
                "outlier_ids": np.asarray(r["outlier_ids"]),
                "summary_ids": np.asarray(r["summary_ids"]),
                "summary_weights": np.asarray(r["summary_weights"]),
                "comm_records": float(r["comm_records"]),
                "cost": float(eng.model.cost),
            }
        return eng


def _run_oneshot(x, pipeline: PipelineConfig, *, device="cuda",
                 sampler: Optional[Sampler] = None) -> dict:
    """Algorithm 3 over ``x`` split into ``topology.sites`` contiguous parts
    — the coordinator entry point a direct caller would drive, keyed by
    ``TorchSampler(pipeline.seed)`` unless a ``sampler`` is given.

    Host-simulated (``np.array_split`` sizes, ``simulate_coordinator``):
    returns the reference's six result keys plus the port's
    ``summary_candidates``, ``site_records``, ``site_rounds`` and
    ``phase_s``.  Under ``topology.use_shard_map`` (``distributed_cluster``
    over the initialized group of ``sites`` ranks, called on every rank
    with the same ``x``): the six keys plus ``phase_s``."""
    p, topo = pipeline.problem, pipeline.topology
    dev = resolve_device(device)
    sampler = sampler if sampler is not None else TorchSampler(pipeline.seed)
    common = dict(k=p.k, t=p.t, partition=topo.partition,
                  summarizer=pipeline.summarizer,
                  second_iters=pipeline.second_iters, metric=p.metric,
                  policy=pipeline.kernels)
    if topo.use_shard_map:
        return _run_shard_map(x, topo.sites, sampler, common, dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    res = simulate_coordinator(torch.tensor_split(x, topo.sites), sampler,
                               **common, device=dev)
    return {key: res[key] for key in
            RESULT_KEYS + ("summary_candidates", "site_records",
                           "site_rounds", "phase_s")}


def _run_shard_map(x, s: int, sampler: Sampler, common: dict,
                   dev: torch.device) -> dict:
    if x.shape[0] % s:
        raise ValueError(
            f"topology.use_shard_map needs len(points) divisible by "
            f"sites={s}, got {x.shape[0]} rows; pad or drop the remainder")
    group = sites_group(s)
    if group is None:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"topology.use_shard_map needs an initialized torch.distributed "
            f"group of {s} ranks for {s} sites "
            f"(repro_torch.core.collective.init_sites), have {have}; drop "
            f"use_shard_map to run host-simulated")
    res = distributed_cluster(x.reshape(s, -1, x.shape[1]), sampler, group,
                              **common, device=dev)
    out = res.outlier_ids.cpu().numpy()
    sid = res.summary_ids.cpu().numpy()
    keep = sid >= 0
    return {
        "centers": res.centers.cpu().numpy(),
        "outlier_ids": out[out >= 0],
        "summary_ids": sid[keep],
        "summary_weights": res.summary_weights.cpu().numpy()[keep],
        "comm_records": float(res.comm_records),
        "cost": float(res.cost),
        "phase_s": res.phase_s,
    }


def _model_from_result(x, res: dict, pipeline: PipelineConfig,
                       version: int, *, device="cuda") -> ModelState:
    """Serving model from a coordinator result — the threshold is the
    largest inlier distance among the summary records the second level was
    fit on, as in ``stream.service.fit_model``."""
    p = pipeline.problem
    dev = resolve_device(device)
    ids = np.asarray(res["summary_ids"], np.int64)
    if isinstance(x, torch.Tensor):
        pts = x.to(dev, torch.float32)[torch.as_tensor(ids, device=dev)]
    else:   # rows on the host (a memmap too): copy only the summary's
        pts = torch.from_numpy(np.asarray(x[ids], np.float32)).to(dev)
    centers = torch.as_tensor(res["centers"], dtype=torch.float32,
                              device=dev).contiguous()
    d_sum, _ = min_argmin(pts, centers, metric=p.metric,
                          policy=pipeline.kernels)
    inlier = ~np.isin(res["summary_ids"], res["outlier_ids"])
    d_sum = d_sum.cpu().numpy()
    threshold = float(d_sum[inlier].max()) if inlier.any() else 0.0

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return ModelState(
        centers=centers,
        threshold=scalar(np.float32(max(threshold, 1e-12)), torch.float32),
        cost=scalar(np.float32(res["cost"]), torch.float32),
        version=scalar(version, torch.int32),
        trained_weight=scalar(np.float32(x.shape[0]), torch.float32))


class Session:
    """The one front door: construct from a :class:`PipelineConfig`, then
    ``fit`` / ``ingest`` / ``refresh`` / ``score`` / ``save`` regardless of
    topology.  ``session.engine`` exposes the underlying layer
    (``StreamService``, ``ShardedStreamService`` or ``OneshotEngine``) as
    the escape hatch for layer-specific surface.  ``sampler`` (default
    ``TorchSampler(config.seed)``) keys the engine's draws."""

    def __init__(self, config: PipelineConfig, *, device="cuda",
                 sampler: Optional[Sampler] = None, _engine=None):
        self.config = config
        self._serving: Optional[ServingScheduler] = None
        self._attach_lock = threading.Lock()
        if config.tracing is not None:
            # pin the process flight recorder to the artifact's knobs
            # (sampling, ring, seed) before the engine captures handles
            obs.apply_trace_spec(config.tracing)
        if _engine is not None:
            self.engine = _engine
        elif config.topology.kind == "stream":
            self.engine = StreamService(config.service_config(),
                                        sampler=sampler, device=device)
        elif config.topology.kind == "sharded":
            self.engine = ShardedStreamService(config.sharded_config(),
                                               sampler=sampler, device=device)
        else:
            self.engine = OneshotEngine(config, device=device,
                                        sampler=sampler)

    # ------------------------------------------------------------ serving
    @property
    def serving(self) -> Optional[ServingScheduler]:
        """The attached async scheduler — None until the first
        :meth:`score_stream` call (or explicit :meth:`serve`)."""
        return self._serving

    def serve(self) -> ServingScheduler:
        """Attach (and return) the continuous-batching scheduler for this
        session's engine, configured by ``config.serving`` (defaults apply
        when the config has no serving section).  Idempotent; once a
        scheduler is attached, the synchronous verbs route through its
        ``engine_lock`` so direct ``score``/``refresh`` calls and worker
        ticks never interleave on the engine.  Safe to race: concurrent
        first callers attach exactly one scheduler."""
        if self._serving is None:
            with self._attach_lock:
                if self._serving is None:
                    self._serving = ServingScheduler(self.engine,
                                                     self.config.serving)
        return self._serving

    def score_stream(self, queries, *, tenant: str = "default",
                     timeout: Optional[float] = None,
                     ) -> Iterator[Union[QueryResult, ShedReject]]:
        """Score rows through the async serving path.

        Rows are admitted (and possibly shed) *now*, on the caller's
        thread — many threads calling ``score_stream`` concurrently share
        one scheduler, and their rows coalesce into common worker ticks.
        Returns an iterator yielding, per row in order, the engine's
        ``QueryResult`` or a typed :class:`ShedReject`; iterate to block
        on completion.  Scores are bit-identical to :meth:`score`.
        """
        tickets = self.serve().submit(queries, tenant=tenant)
        return (t.result(timeout) for t in tickets)

    def submit_stream(self, queries, *, tenant: str = "default",
                      ) -> "list[ScoreTicket]":
        """Like :meth:`score_stream` but returns the raw tickets, for
        callers that want ``done()`` polling or per-ticket latency."""
        return self.serve().submit(queries, tenant=tenant)

    def close(self) -> None:
        """Drain and stop the serving scheduler, if one is attached.
        The session's synchronous verbs keep working afterwards."""
        with self._attach_lock:
            serving, self._serving = self._serving, None
        if serving is not None:
            serving.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _engine_guard(self):
        """The scheduler's engine lock when serving is attached (direct
        verbs must not interleave with worker ticks), else a no-op."""
        if self._serving is not None:
            return self._serving.engine_lock
        return contextlib.nullcontext()

    # ------------------------------------------------------------ verbs
    def ingest(self, points, weights=None, *, site: int | None = None) -> None:
        """Feed raw points.  ``site=`` pins a batch to one site (sharded
        topology only — elsewhere routing is not a concept)."""
        if site is None:
            with self._engine_guard():
                self.engine.ingest(points, weights)
        elif self.config.topology.kind != "sharded":
            raise ValueError(
                f"site= routing needs topology.kind='sharded', this "
                f"session is {self.config.topology.kind!r}")
        else:
            with self._engine_guard():
                self.engine.ingest(points, weights, site=site)

    def refresh(self, *, blocking: bool = True) -> Optional[ModelState]:
        """(Re)fit the serving model on everything ingested so far."""
        with self._engine_guard():
            return self.engine.refresh(blocking=blocking)

    def fit(self, points=None, weights=None) -> ModelState:
        """``ingest`` (optional) + blocking ``refresh`` in one call."""
        if points is not None:
            self.ingest(points, weights)
        with self._engine_guard():
            return self.engine.refresh(blocking=True)

    def score(self, queries) -> list:
        """Score query rows against the current model; returns the same
        ``QueryResult`` records every topology's read path produces."""
        with self._engine_guard():
            return self.engine.score(queries)

    def latency_stats(self) -> dict:
        return self.engine.latency_stats()

    def store_stats(self) -> Optional[dict]:
        """The tiered store's movement tallies summed over this session's
        trees — ``{"spills", "page_ins", "spill_bytes", "page_in_bytes"}``
        — or None when the config has no tiered store (oneshot topology, no
        ``store`` section, or an untiered spec).  Per-series detail lives
        in :meth:`stats` under ``store.*``."""
        if hasattr(self.engine, "tree"):
            trees = [self.engine.tree]
        else:
            trees = list(getattr(self.engine, "trees", []))
        stores = [t._store for t in trees if t._store is not None]
        if not stores:
            return None
        totals: dict = {}
        for st in stores:
            for k, v in st.stats().items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def stats(self) -> dict:
        """The process metrics snapshot (``repro_torch.obs``): one plain
        dict of every counter, gauge and latency/phase histogram the layers
        under this session reported — serve latency, ingest/refresh/score
        phase timings, tree activity, comm records+bytes per site,
        kernel-backend dispatch counts, checkpoint durations.
        JSON-serializable as-is; render for Prometheus with
        ``repro_torch.obs.render_prometheus``.

        The snapshot is process-wide by design (one registry, like any
        exporter) — two sessions of the same topology share series.
        """
        return obs.snapshot()

    def dump_trace(self, path, fmt: str = "chrome"):
        """Write the flight recorder's buffered spans to ``path``.

        ``fmt="chrome"`` (default) writes Chrome trace-event JSON — load
        it in Perfetto or ``chrome://tracing`` to see each request/refresh
        as one stitched timeline.  ``fmt="jsonl"`` writes one JSON record
        per span/event.  Returns the path written.  The recorder is
        process-wide, like :meth:`stats`.
        """
        return obs.dump_trace(path, fmt=fmt)

    @property
    def last_fit(self):
        """:class:`repro_torch.stream.service.FitStats` of the most recent
        installed refresh (duration, records folded) — None before the
        first fit.  Staleness is ``engine.seconds_since_install()``."""
        return self.engine.last_fit

    @property
    def model(self) -> Optional[ModelState]:
        return self.engine.model

    @property
    def result(self) -> Optional[dict]:
        """Oneshot coordinator detail (outlier/summary ids, comm records);
        None for the stream topology, whose model is the serving state."""
        return getattr(self.engine, "result", None)

    # ------------------------------------------------------------ persistence
    def save(self, directory, *, step: int | None = None,
             blocking: bool = True) -> int:
        """Checkpoint the full session under ``directory``.

        The serialized ``PipelineConfig`` is embedded in the checkpoint
        manifest, so :meth:`load` reconstructs topology and policies with
        no caller-side state.  Returns the step written."""
        manager = CheckpointManager(directory)
        if step is None:
            latest = manager.latest_step()
            step = (latest + 1) if latest is not None else 1
        with self._engine_guard():
            self.engine.save(
                manager, step, blocking=blocking,
                extra_meta={"pipeline_config": self.config.to_dict()})
        return step

    @classmethod
    def load(cls, directory, *, step: int | None = None, device="cuda",
             sampler_from_key_data: Optional[Callable] = None) -> "Session":
        """Rebuild a session from a checkpoint alone: the manifest's
        embedded config selects the topology and policies, then the
        matching layer restores its state on ``device`` (post-restore
        scores are bit-identical to the saved session's).  A stream
        or sharded session's samplers are rebuilt by
        ``sampler_from_key_data`` (default ``TorchSampler.from_key_data``);
        a oneshot session keeps no sampler state and refits from
        ``TorchSampler(config.seed)``."""
        manager = CheckpointManager(directory)
        meta = manager.read_meta(step)
        cfg_dict = meta.get("pipeline_config")
        if cfg_dict is None:
            raise ValueError(
                f"checkpoint in {directory} has no embedded pipeline config "
                f"(was it written by Session.save?); restore it with the "
                f"layer-specific restore() it was written by")
        config = PipelineConfig.from_dict(cfg_dict)
        kind = config.topology.kind
        if kind == "stream":
            engine = StreamService.restore(
                config.service_config(), manager, step,
                sampler_from_key_data=sampler_from_key_data, device=device)
        elif kind == "sharded":
            engine = ShardedStreamService.restore(
                config.sharded_config(), manager, step,
                sampler_from_key_data=sampler_from_key_data, device=device)
        else:
            engine = OneshotEngine.restore(config, manager, step,
                                           device=device)
        return cls(config, _engine=engine)
