"""Online scoring front end over the stream tree.

Port of ``repro.stream.service``.  ``ServingFrontEnd`` is shared with the
multi-site ``ShardedStreamService`` (``stream/sharded.py``).

Write path: ``ingest`` feeds raw points into the merge-and-reduce tree;
every ``refresh_every`` ingested points (or on demand) the tree root —
the union of all live weighted summaries — is re-clustered with weighted
k-means-- (the paper's coordinator step) into a versioned ``ModelState``.

Read path: ``submit`` enqueues assign/score requests; ``drain`` serves the
queue in fixed-size micro-batches through ONE fused ``score`` dispatch
each (min-distance → argmin → dist/threshold in a single pass; backend
selection via ``ServiceConfig.policy``).  The queue holds whole submitted
*blocks*, not per-row tuples, so enqueue and batch assembly are O(blocks)
array copies.  Every micro-batch is padded to the same static shape.

Double-buffered refresh (``async_refresh=True``): a cadence refresh
snapshots the tree root on the ingest thread, then fits the next
``ModelState`` on a worker thread while ingest keeps running and queries
keep scoring against the *old* model; the new model is installed at the
next ingest/drain boundary (``poll_refresh``).  The fit is a pure function
of (root snapshot, version, model sampler), so the async model is
bit-identical to what a blocking refresh at the same boundary would have
produced — only the install time moves.  A fit ends with its tensors
complete on the card (``_timed_fit``) before another thread may install
them.

Outlier scoring: a request's score is d(x, nearest center) / threshold,
where threshold is the largest inlier distance seen when the model was
fit; score > 1 flags the point as an outlier under the current model.

Restart story: ``save``/``restore`` round-trip the tree + model + service
counters through ``CheckpointManager`` in the reference's layout (the
model sampler is the ``model_key`` leaf of two uint32 words), so a
restored service returns bit-identical scores and draws what the
uninterrupted one draws; a checkpoint written by either package restores
in the other.

``model_from_arrays`` carries a model fitted by the reference across.

Telemetry is the reference's (``repro_torch.obs``): per-request latency
in the bounded ``serve.latency{topology=...}`` histogram, the ``ingest``,
``refresh.*`` and ``score.*`` phase spans under the ``ingest.request`` and
``refresh`` root traces (an async refresh carries its trace across the
worker thread), the ``ingest.points`` / ``score.requests`` /
``refresh.*`` counters, the ``model.seconds_since_install`` gauge and the
drift monitors.  A span that covers device work ends where the code
already waits for the device: ``refresh.fit`` at ``_complete``,
``score.fused`` at the copies of its results to the host.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.kmeans_mm import kmeans_minus_minus
from repro_torch.core.sampler import Sampler, TorchSampler
from repro_torch.kernels.dispatch import KernelPolicy, get_default_policy
from repro_torch.kernels.score.ops import score as fused_score
from repro_torch.store.spec import StoreSpec
from repro_torch.stream.tree import StreamTree, TreeConfig
from repro_torch.summarize.base import (SummarizerPolicy,
                                        get_default_summarizer)

# recent latency samples the ``serve.latency`` histogram keeps for its
# percentiles
LATENCY_RING = obs.DEFAULT_RING


@dataclasses.dataclass(frozen=True)
class BaseServiceConfig:
    """Fields shared by every serving front end (single-host and sharded)."""

    dim: int
    k: int
    t: int
    leaf_size: int = 2048
    refresh_every: int = 8192        # raw points between model refreshes
    micro_batch: int = 256           # static query-batch shape
    second_iters: int = 25
    metric: str = "l2sq"
    # None = capture the process default (set_default_policy) at construction
    policy: Optional[KernelPolicy] = None
    # None = capture the process default (set_default_summarizer); selects
    # the tree's summary algorithm (leaf reduction + merge-reduce)
    summarizer: Optional[SummarizerPolicy] = None
    window: Optional[int] = None
    async_refresh: bool = False      # fit cadence models off the ingest path
    seed: int = 0
    # None = classic behavior (all-resident tree, every refresh refits).
    # A StoreSpec adds disk tiering and/or incremental refresh; model
    # samplers are then derived from the tree's root epoch instead of the
    # version, so an unchanged root provably refits to the identical model —
    # which is what makes skipping it safe (see _fit_closure).
    store: Optional[StoreSpec] = None

    def __post_init__(self):
        if self.policy is None:
            object.__setattr__(self, "policy", get_default_policy())
        if self.summarizer is None:
            object.__setattr__(self, "summarizer", get_default_summarizer())


@dataclasses.dataclass(frozen=True)
class ServiceConfig(BaseServiceConfig):
    def tree_config(self) -> TreeConfig:
        return TreeConfig(
            dim=self.dim, k=self.k, t=self.t, leaf_size=self.leaf_size,
            metric=self.metric, policy=self.policy,
            summarizer=self.summarizer,
            window=self.window, seed=self.seed, store=self.store)


class ModelState(NamedTuple):
    centers: torch.Tensor     # (k, d) f32
    threshold: torch.Tensor   # () f32 — max inlier distance at fit time
    cost: torch.Tensor        # () f32 — weighted second-level objective
    version: torch.Tensor     # () i32 — 0 means "no model yet"
    trained_weight: torch.Tensor  # () f32 — mass the model was fit on


class FitStats(NamedTuple):
    """The most recent installed refresh.  ``installed_at`` is a
    ``time.perf_counter`` stamp; compare against it, don't interpret it as
    wall-clock."""
    version: int
    records_folded: int      # live root records the model was fit on
    fit_s: float             # wall time of the second-level fit
    installed_at: float


class QueryResult(NamedTuple):
    request_id: int
    center: int              # nearest-center index
    distance: float
    outlier_score: float     # distance / threshold; > 1 -> outlier
    is_outlier: bool
    latency_s: float


def _score_batch(x, centers, threshold, *, metric, policy):
    # one registry dispatch for the whole read path (pdist + argmin +
    # threshold divide); for the non-quantized backends the fused op is
    # bit-identical to the composed min_argmin + divide
    return fused_score(x, centers, threshold, metric=metric, policy=policy)


def fit_model(pts, wts, valid, sampler, version, *, k, t, iters, metric,
              policy, init_centers=None) -> ModelState:
    """Second-level weighted k-means-- on a (padded) root -> ModelState.

    Pure function of its inputs — the one coordinator step every serving
    path (sync or async refresh) funnels through.  ``init_centers``
    warm-starts the Lloyd loop from the previous model's centers (the
    incremental-refresh path; ``sampler`` is then unused).
    """
    sol = kmeans_minus_minus(
        pts, wts, valid, sampler, k=k, t=float(t), iters=iters,
        metric=metric, policy=policy, init_centers=init_centers)
    inlier = valid & ~sol.outlier
    threshold = torch.where(inlier, sol.distances, float("-inf")).max()
    threshold = torch.clamp(threshold, min=1e-12).to(torch.float32)
    trained = torch.sum(wts * valid).to(torch.float32)
    dev = pts.device
    return ModelState(
        centers=sol.centers, threshold=threshold,
        cost=sol.cost.to(torch.float32),
        version=torch.tensor(version, dtype=torch.int32, device=dev),
        trained_weight=trained)


def model_from_arrays(md: dict, device="cuda") -> ModelState:
    """The port's ``ModelState`` on ``device`` from the dict the reference's
    ``ServingFrontEnd._model_arrays`` produces (``centers``, ``threshold``,
    ``cost``, ``version``, ``trained_weight``; numpy or array-likes)."""
    dev = resolve_device(device)

    def leaf(name, dtype):
        return torch.tensor(np.asarray(md[name]), dtype=dtype, device=dev)

    return ModelState(
        centers=leaf("centers", torch.float32).contiguous(),
        threshold=leaf("threshold", torch.float32),
        cost=leaf("cost", torch.float32),
        version=leaf("version", torch.int32),
        trained_weight=leaf("trained_weight", torch.float32))


def _complete(model: ModelState) -> None:
    """Wait until ``model``'s tensors are written: an event recorded on
    this thread's current stream, after the fit's last launch, and waited
    on (the reference's ``jax.block_until_ready``)."""
    dev = model.centers.device
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()


class ServingFrontEnd:
    """Micro-batched read path + double-buffered model state.

    Subclasses own the write path and provide ``_fit_closure(version)``: a
    zero-arg callable, with all inputs already snapshotted on the calling
    thread, that computes the next ``ModelState``.  The front end decides
    *when* it runs (inline for blocking refreshes, on a worker thread for
    async ones) and installs the result.  Queries are scored on ``device``.

    Telemetry: per-request latency goes to the bounded
    ``serve.latency{topology=...}`` histogram in the process metrics
    registry; refresh phases are traced (``phase.refresh.gather|fit|
    install``); the last installed refresh is summarized in ``last_fit``
    (:class:`FitStats`) with a live ``model.seconds_since_install``
    staleness gauge.  Metrics are keyed per *topology*, so two services of
    the same class in one process share series — the registry is
    process-level, like any Prometheus exporter.
    """

    _topology = "serve"   # subclasses: "stream" | "sharded" | "oneshot"

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Optional[ModelState] = None
        # block-granular: (first_id, rows (b, d) f32, t_enqueue) per submit
        # call — request ids are consecutive within a block
        self._queue: deque = deque()
        self._queued_rows = 0
        self._next_id = 0
        self._lat = obs.histogram("serve.latency", topology=self._topology)
        self._worker: Optional[threading.Thread] = None
        self._worker_box: list = []
        self._backlog = False
        self._next_version = 0
        self._since_refresh = 0
        # incremental refresh: the root epoch the serving model was fit on
        # (None = no epoch-tracked fit yet) and the epoch of the fit in
        # flight, handed from _fit_closure to _install
        self._last_fit_epoch = None
        self._pending_fit_epoch = None
        self.last_fit: Optional[FitStats] = None
        # (recorder, ctx, t_start) of the in-flight async refresh trace
        self._refresh_trace: tuple = (None, None, 0.0)
        self._monitors = obs.get_default_registry().monitors
        obs.gauge("model.seconds_since_install",
                  topology=self._topology).set_fn(self.seconds_since_install)

    # ------------------------------------------------------------ write path
    def _validate_points(self, points, weights):
        x = np.asarray(points, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.cfg.dim:
            raise ValueError(f"expected (n, {self.cfg.dim}) points, "
                             f"got {x.shape}")
        w = None if weights is None else np.asarray(weights,
                                                    np.float32).reshape(-1)
        if w is not None and w.shape[0] != x.shape[0]:
            raise ValueError(f"{w.shape[0]} weights for {x.shape[0]} points")
        return x, w

    def _ingest_cadenced(self, x, w, sink) -> None:
        """Feed (x, w) to ``sink(chunk_x, chunk_w)`` in chunks bounded by
        the refresh cadence, so one huge call still refreshes on schedule
        rather than once at the end."""
        i, n = 0, x.shape[0]
        # one trace per ingest call: chunk + tree spans nest under it,
        # while any cadence refresh it triggers opens its own trace
        with obs.root_trace("ingest.request", topology=self._topology,
                            points=n):
            while i < n:
                take = min(self.cfg.refresh_every - self._since_refresh,
                           n - i)
                if take <= 0:   # e.g. restored with a smaller refresh_every
                    self._cadence_refresh()
                    continue
                with obs.trace("ingest", topology=self._topology):
                    sink(x[i:i + take], None if w is None else w[i:i + take])
                obs.counter("ingest.points",
                            topology=self._topology).inc(take)
                self._since_refresh += take
                i += take
                if self._since_refresh >= self.cfg.refresh_every:
                    self._cadence_refresh()

    def _cadence_refresh(self) -> None:
        self.refresh(blocking=not self.cfg.async_refresh)

    # ------------------------------------------------------------ refresh
    def _fit_closure(self, version: int) -> Optional[Callable[[], ModelState]]:
        """Snapshot the root and return the deferred fit — or None to skip
        (incremental refresh proved the installed model is already it)."""
        raise NotImplementedError

    def _root_records(self) -> int:
        """Live root records a refresh fits on (telemetry only)."""
        return 0

    def _timed_fit(self, fit: Callable[[], ModelState]):
        """Run the fit, its tensors complete on the device before this
        returns (a model is published to another thread only so).
        Returns (model, fit wall seconds)."""
        t0 = time.perf_counter()
        with obs.trace("refresh.fit", topology=self._topology):
            model = fit()
            _complete(model)
        return model, time.perf_counter() - t0

    def _install(self, model: ModelState, fit_s: float,
                 records: int) -> None:
        with obs.trace("refresh.install", topology=self._topology):
            self.model = model
            if self._pending_fit_epoch is not None:
                self._last_fit_epoch = self._pending_fit_epoch
                self._pending_fit_epoch = None
            self.last_fit = FitStats(
                version=int(model.version), records_folded=int(records),
                fit_s=float(fit_s), installed_at=time.perf_counter())
        obs.counter("refresh.count", topology=self._topology).inc()
        obs.counter("refresh.records_folded",
                    topology=self._topology).inc(int(records))
        # re-anchor the drift monitors to the newly installed model: the
        # healthy outlier fraction is the paper's z/n budget — the share
        # of the trained mass the fit was allowed to discard
        t = getattr(self.cfg, "t", None)
        if t is not None:
            self._monitors.set_outlier_budget(
                self._topology,
                float(t) / max(float(model.trained_weight), 1.0))
        self._monitors.set_staleness_source(self._topology,
                                            self.seconds_since_install)

    def refresh(self, *, blocking: bool = True) -> Optional[ModelState]:
        """Fit a new model on the current root.

        blocking=True (default) installs it before returning; False hands
        the fit to a worker thread (the root snapshot is still taken here,
        synchronously) and returns None — the model appears at the next
        ``poll_refresh``/``drain``/``ingest`` boundary.  An async refresh
        requested while one is already in flight is coalesced: it re-fires
        on the newest root as soon as the in-flight fit lands.  Either way
        the cadence counter restarts.

        With ``cfg.store.incremental_refresh`` and an unchanged root since
        the last fit, ``_fit_closure`` returns None and the refresh is
        *skipped*: the serving model — provably bit-identical to what a
        refit would install — stays, the version does not advance, and
        the skip is counted (``refresh.skipped``).
        """
        if blocking:
            self.join_refresh()
            self._next_version += 1
            with obs.root_trace("refresh", topology=self._topology,
                                version=self._next_version):
                with obs.trace("refresh.gather", topology=self._topology):
                    fit = self._fit_closure(self._next_version)
                    records = self._root_records()
                if fit is None:
                    self._skip_refresh()
                    return self.model
                model, fit_s = self._timed_fit(fit)
                self._install(model, fit_s, records)
            self._since_refresh = 0
            return model
        if self._worker is not None:
            self._backlog = True
        else:
            self._spawn_fit()
        self._since_refresh = 0
        return None

    def _end_refresh_trace(self, status: str = "ok",
                           error: Optional[BaseException] = None) -> None:
        """Record the async refresh trace's root span at install time."""
        rec, tctx, t_start = self._refresh_trace
        self._refresh_trace = (None, None, 0.0)
        if tctx is None:
            return
        attrs: dict = {"topology": self._topology}
        if error is not None:
            attrs["error"] = type(error).__name__
        rec.record_span("refresh", tctx, t0=t_start, t1=obs.now(),
                        span_id=tctx.span_id, parent_id=None, status=status,
                        force=status == "error", attrs=attrs)

    def _skip_refresh(self) -> None:
        """Account an incremental-refresh skip: the root is unchanged, so
        the installed model already equals what a refit would produce."""
        self._next_version -= 1   # the skipped fit never claimed a version
        self._pending_fit_epoch = None
        obs.counter("refresh.skipped", topology=self._topology).inc()
        self._since_refresh = 0

    def _spawn_fit(self) -> None:
        self._next_version += 1
        # the refresh trace opens here and is carried explicitly across
        # the worker-thread boundary (gather on this thread, fit on the
        # worker, install + root span back on the polling thread)
        rec = obs.get_default_recorder()
        tctx = rec.new_trace()
        self._refresh_trace = (rec, tctx, obs.now())
        with obs.use_context(tctx):
            with obs.trace("refresh.gather", topology=self._topology):
                fit = self._fit_closure(self._next_version)
                records = self._root_records()
        if fit is None:
            self._skip_refresh()
            self._end_refresh_trace("skipped")
            return
        box: list = []

        def run():
            with obs.use_context(tctx):
                try:
                    model, fit_s = self._timed_fit(fit)
                    box.append(("ok", model, fit_s, records))
                except BaseException as e:  # surfaced at poll/join
                    box.append(("err", e, 0.0, 0))

        self._worker_box = box
        self._worker = threading.Thread(
            target=run, name="stream-refresh", daemon=True)
        self._worker.start()

    def poll_refresh(self) -> bool:
        """Install a finished background fit, if any.  Returns True iff the
        serving model changed.  Re-raises a failed fit's exception here, on
        the caller's thread."""
        w = self._worker
        if w is None or w.is_alive():
            return False
        w.join()
        status, payload, fit_s, records = self._worker_box[0]
        self._worker, self._worker_box = None, []
        if status == "err":
            self._backlog = False   # don't respawn on top of a failed fit
            self._end_refresh_trace("error", payload)
            raise payload
        _, tctx, _ = self._refresh_trace
        with obs.use_context(tctx):
            self._install(payload, fit_s, records)
        self._end_refresh_trace()
        if self._backlog:
            self._backlog = False
            self._spawn_fit()
        return True

    def join_refresh(self) -> None:
        """Block until no refresh is in flight (incl. a coalesced backlog)."""
        while self._worker is not None:
            self._worker.join()
            self.poll_refresh()

    @property
    def refresh_in_flight(self) -> bool:
        return self._worker is not None

    # ------------------------------------------------------------ read path
    def submit(self, points) -> list[int]:
        """Enqueue query rows; returns their request ids."""
        # validate here, where the caller can handle it — a bad row that
        # reaches drain() would crash mid-batch after requests were
        # already dequeued
        x, _ = self._validate_points(points, None)
        now = time.perf_counter()
        with obs.trace("score.enqueue", topology=self._topology):
            n = x.shape[0]
            ids = list(range(self._next_id, self._next_id + n))
            self._queue.append((self._next_id, x, now))
            self._queued_rows += n
            self._next_id += n
        obs.counter("score.requests", topology=self._topology).inc(len(ids))
        return ids

    def discard_pending(self) -> int:
        """Drop every submitted-but-undrained request; returns the count.
        The serving scheduler calls this when a tick fails after
        ``submit`` — rows left queued would be drained by the *next* tick
        and misalign its results."""
        n = self._queued_rows
        self._queue.clear()
        self._queued_rows = 0
        return n

    def drain(self, max_requests: Optional[int] = None) -> list[QueryResult]:
        """Serve queued requests in micro-batches against the current model."""
        self.poll_refresh()
        if self.model is None:
            self.join_refresh()   # a first async refresh may be in flight
        if self.model is None:
            raise RuntimeError("no model yet — call refresh() first")
        cfg = self.cfg
        out: list[QueryResult] = []
        budget = self._queued_rows if max_requests is None else max_requests
        with obs.trace("score.drain", topology=self._topology):
            while self._queue and budget > 0:
                with obs.trace("score.batch", topology=self._topology):
                    take = min(cfg.micro_batch, self._queued_rows, budget)
                    xb = np.zeros((cfg.micro_batch, cfg.dim), np.float32)
                    # slice whole blocks into the pad buffer; a block that
                    # overhangs the batch is split, its tail re-queued
                    runs, filled = [], 0
                    while filled < take:
                        rid0, rows, t0 = self._queue[0]
                        r = min(rows.shape[0], take - filled)
                        xb[filled:filled + r] = rows[:r]
                        runs.append((rid0, r, t0))
                        if r == rows.shape[0]:
                            self._queue.popleft()
                        else:
                            self._queue[0] = (rid0 + r, rows[r:], t0)
                        filled += r
                    self._queued_rows -= take
                    budget -= take
                with obs.trace("score.fused", topology=self._topology):
                    dist, amin, score = _score_batch(
                        torch.from_numpy(xb).to(self.device),
                        self.model.centers, self.model.threshold,
                        metric=cfg.metric, policy=cfg.policy)
                    # the copies to the host wait for the kernel
                    dist, amin, score = (a.cpu().numpy()
                                         for a in (dist, amin, score))
                done = time.perf_counter()
                i = 0
                for rid0, r, t0 in runs:
                    lat = done - t0
                    self._lat.observe(lat, r)
                    for j in range(i, i + r):
                        out.append(QueryResult(
                            request_id=rid0 + (j - i), center=int(amin[j]),
                            distance=float(dist[j]),
                            outlier_score=float(score[j]),
                            is_outlier=bool(score[j] > 1.0), latency_s=lat))
                    i += r
        if out:
            self._monitors.observe_scores(
                self._topology, len(out),
                sum(1 for r in out if r.is_outlier))
        return out

    def score(self, points) -> list[QueryResult]:
        """Synchronous convenience: submit + drain in one call."""
        self.submit(points)
        return self.drain()

    def latency_stats(self) -> dict:
        """Request count and p50/p99 latency in ms, read from the
        ``serve.latency`` histogram: percentiles exact (``np.percentile``)
        over its ring of the most recent ``LATENCY_RING`` requests (the
        full snapshot — buckets, p95, min/max — lives in
        ``obs.snapshot()``)."""
        if self._lat.count == 0:
            return {"count": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}
        return {"count": int(self._lat.count),
                "p50_ms": float(self._lat.percentile(50)) * 1e3,
                "p99_ms": float(self._lat.percentile(99)) * 1e3}

    def reset_latency_stats(self) -> None:
        """Zero the ``serve.latency`` histogram (benchmark epochs)."""
        self._lat.reset()

    def seconds_since_install(self) -> Optional[float]:
        """Age of the serving model — None before the first refresh.  Also
        exported live as the ``model.seconds_since_install`` gauge."""
        if self.last_fit is None:
            return None
        return time.perf_counter() - self.last_fit.installed_at

    # ------------------------------------------------------------ checkpoint
    def _model_arrays(self) -> dict:
        m = self.model
        if m is None:
            return self._model_skeleton(self.cfg)
        return {"centers": m.centers, "threshold": m.threshold,
                "cost": m.cost, "version": m.version,
                "trained_weight": m.trained_weight}

    @staticmethod
    def _model_skeleton(cfg) -> dict:
        return {"centers": np.zeros((cfg.k, cfg.dim), np.float32),
                "threshold": np.float32(0), "cost": np.float32(0),
                "version": np.int32(0), "trained_weight": np.float32(0)}

    def _install_model_arrays(self, md: dict) -> None:
        if int(md["version"]) > 0:
            self.model = model_from_arrays(md, device=self.device)
        self._next_version = int(md["version"])


class StreamService(ServingFrontEnd):
    """The single-host service: one :class:`StreamTree` on ``device``.

    ``sampler`` (default ``TorchSampler(cfg.seed)``) is split once into the
    tree's sampler and the model sampler, as the reference splits its key.
    """

    _topology = "stream"

    def __init__(self, cfg: ServiceConfig, sampler: Optional[Sampler] = None,
                 device="cuda"):
        super().__init__(cfg, device)
        sampler = sampler if sampler is not None else TorchSampler(cfg.seed)
        kt, self._model_key = sampler.split(2)
        self.tree = StreamTree(cfg.tree_config(), kt, device=self.device)

    def _root_records(self) -> int:
        return self.tree.num_records

    # ------------------------------------------------------------ write path
    def ingest(self, points, weights=None) -> None:
        self.poll_refresh()
        x, w = self._validate_points(points, weights)
        self._ingest_cadenced(x, w, self.tree.ingest)

    def _fit_closure(self, version: int):
        """Snapshot the tree root now; fit later (possibly on a worker).

        With ``cfg.store`` set, the fit's sampler is derived from the tree's
        ``root_epoch`` instead of the model version: an unchanged root then
        provably refits to the bit-identical model, which licenses both the
        incremental-refresh *skip* (return None) and the opt-in warm start
        from the previous centers when little of the root changed.
        """
        cfg = self.cfg
        if self.tree.num_records == 0:
            raise RuntimeError("refresh() before any point was ingested")
        store, init = cfg.store, None
        if store is not None:
            # touch the incremental-refresh series so a store-configured
            # run always exposes them (at zero until the first skip)
            obs.counter("refresh.skipped", topology=self._topology).inc(0)
            obs.counter("refresh.warm_starts",
                        topology=self._topology).inc(0)
            epoch = self.tree.root_epoch
            if (store.incremental_refresh and self.model is not None
                    and epoch == self._last_fit_epoch):
                return None
            key = self._model_key.fold_in(epoch)
            if (store.warm_start_frac > 0.0 and self.model is not None
                    and self._last_fit_epoch is not None):
                changed, total = self.tree.changed_weight_since(
                    self._last_fit_epoch)
                if changed <= store.warm_start_frac * total:
                    init = self.model.centers
                    obs.counter("refresh.warm_starts",
                                topology=self._topology).inc()
            self._pending_fit_epoch = epoch
        else:
            key = self._model_key.fold_in(version)
        pts, wts, valid = (torch.from_numpy(a).to(self.device)
                           for a in self.tree.packed_root())
        return functools.partial(
            fit_model, pts, wts, valid, key, version, k=cfg.k, t=cfg.t,
            iters=cfg.second_iters, metric=cfg.metric, policy=cfg.policy,
            init_centers=init)

    # ------------------------------------------------------------ checkpoint
    def _state(self) -> dict:
        self.join_refresh()   # a half-fitted model must not race the snapshot
        return {
            "tree": self.tree.pack_state(),
            "model": self._model_arrays(),
            "counters": {
                "since_refresh": np.int64(self._since_refresh),
                "next_id": np.int64(self._next_id),
                "last_fit_epoch": np.int64(
                    -1 if self._last_fit_epoch is None
                    else self._last_fit_epoch),
                "model_key": np.asarray(self._model_key.key_data(),
                                        np.uint32),
            },
        }

    def _skeleton(self) -> dict:
        cfg = self.cfg
        return {
            "tree": StreamTree.skeleton_state(cfg.tree_config()),
            "model": self._model_skeleton(cfg),
            "counters": {"since_refresh": np.int64(0), "next_id": np.int64(0),
                         "last_fit_epoch": np.int64(-1),
                         "model_key": np.zeros((2,), np.uint32)},
        }

    def save(self, manager: CheckpointManager, step: int, *,
             blocking: bool = True, extra_meta: Optional[dict] = None) -> None:
        """``extra_meta``: caller facts merged into the manifest meta."""
        manager.save(step, self._state(), blocking=blocking,
                     meta={**(extra_meta or {}), "format": "stream-service-v1"})

    @classmethod
    def restore(cls, cfg: ServiceConfig, manager: CheckpointManager,
                step: int | None = None, *,
                sampler_from_key_data: Optional[Callable] = None,
                device="cuda") -> "StreamService":
        """The service a checkpoint holds, on ``device``.
        ``sampler_from_key_data`` rebuilds the tree's and the model's
        samplers from their ``(2,)`` uint32 words (default
        :meth:`TorchSampler.from_key_data`)."""
        fmt = manager.read_meta(step).get("format")
        if fmt is not None and fmt != "stream-service-v1":
            raise ValueError(
                f"checkpoint format {fmt!r} is not a single-host stream "
                f"checkpoint — restore it with the service that wrote it")
        rebuild = sampler_from_key_data or TorchSampler.from_key_data
        svc = cls(cfg, device=device)
        state, _ = manager.restore(svc._skeleton(), step)
        svc.tree = StreamTree.from_state(cfg.tree_config(), state["tree"],
                                         sampler_from_key_data=rebuild,
                                         device=svc.device)
        svc._since_refresh = int(state["counters"]["since_refresh"])
        svc._next_id = int(state["counters"]["next_id"])
        lfe = int(state["counters"]["last_fit_epoch"])
        svc._last_fit_epoch = None if lfe < 0 else lfe
        svc._model_key = rebuild(
            np.asarray(state["counters"]["model_key"], np.uint32))
        svc._install_model_arrays(state["model"])
        return svc
