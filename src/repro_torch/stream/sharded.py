"""Multi-site sharded streaming service: per-site trees + all_gather roots.

Port of ``repro.stream.sharded``.  Topology (Algorithm 3 lifted onto the
stream):

    site 0: raw points --> leaf buffer --> StreamTree (merge-and-reduce)
    site 1: raw points --> leaf buffer --> StreamTree          |
      ...                                                      | packed roots
    site s: raw points --> leaf buffer --> StreamTree          v
                                       one all_gather of fixed-shape roots
                                                               |
                       replicated weighted k-means--  <--------+
                                   (one global ModelState on every site)

Each site ingests its shard of the stream completely locally — leaf
reduction, merge-and-reduce, window eviction never leave the site.  On the
refresh cadence every site contributes its tree root, padded to one static
record capacity, to a single all_gather (the paper's one round of
communication, through ``repro_torch.core.collective``), and the
second-level weighted k-means-- runs replicated on the union, so a global
outlier that looks locally unremarkable is still caught, exactly as in the
one-shot Algorithm 3.

Execution paths, same math (``last_refresh.path`` records which ran):

* ``"host-sim"`` (default): the service owns all ``s`` trees, the gather is
  a concatenation in site order — bit-identical to what the collective
  delivers — and communication is *accounted* (records and bytes) rather
  than performed;
* ``"shard_map"`` (the reference's name for its collective path): with
  ``cfg.use_shard_map`` set and an initialized ``torch.distributed`` group
  of exactly ``n_sites`` ranks (``collective.init_sites``), every rank runs
  this service on the same stream, rank r ships ``trees[r]``'s packed root
  through ``gather_sites``, and every rank fits the gathered roots.  A
  rank's trees for the other sites keep its routing and accounting the
  host-sim path's, as the reference's one process owns every site's tree.

The read path (micro-batched scoring, latency accounting) and the
double-buffered async refresh are inherited from ``ServingFrontEnd``.

Communication cost per refresh is exactly the packed roots: s sites x
root_rows records x (4d + 4 + 1) bytes — reported per refresh in
``last_refresh`` and through ``obs.record_comm`` (``topology=sharded``),
with one ``refresh.site_root`` span per site's root snapshot; each site's
tree carries its ``site`` label.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.collective import (gather_sites, gathered_bytes,
                                         payload_bytes, sites_group)
from repro_torch.core.distributed import local_budget
from repro_torch.core.sampler import Sampler, TorchSampler
from repro_torch.stream.service import (BaseServiceConfig, ServingFrontEnd,
                                        fit_model)
from repro_torch.stream.tree import StreamTree, TreeConfig
from repro_torch.stream.weighted import _bucket


@dataclasses.dataclass(frozen=True)
class ShardedServiceConfig(BaseServiceConfig):
    """``BaseServiceConfig`` (all serving knobs, incl. ``refresh_every`` and
    ``window`` which are GLOBAL raw-point counts here) plus the multi-site
    topology fields only the sharded service has."""

    n_sites: int = 4
    site_budget: str = "full"        # "full": t per site (window/adversarial
    #                                  safe); "paper": 2t/s (cheaper roots)
    use_shard_map: bool = False      # real collective when a group allows

    def site_t(self) -> int:
        if self.site_budget == "full":
            return self.t
        if self.site_budget == "paper":
            return local_budget(self.t, self.n_sites, "random")
        raise ValueError(f"unknown site_budget {self.site_budget!r}")

    def site_tree_config(self) -> TreeConfig:
        w = self.window
        if w is not None:
            # each site sees ~1/s of the stream, so a site-local window of
            # ceil(W/s) tracks the last ~W global points
            w = -(-w // self.n_sites)
        return TreeConfig(
            dim=self.dim, k=self.k, t=self.site_t(),
            leaf_size=self.leaf_size, metric=self.metric,
            policy=self.policy, summarizer=self.summarizer, window=w,
            seed=self.seed, store=self.store)


class RefreshStats(NamedTuple):
    """Communication accounting for one gathered refresh."""
    version: int
    path: str                 # "shard_map" | "host-sim"
    root_rows: int            # static per-site packed-root rows
    per_site_records: tuple   # live (valid) records each site contributed
    comm_records: int         # total valid records gathered (paper's measure)
    comm_bytes: int           # total bytes one all_gather moves (padded)
    payload_bytes: int        # one site's padded contribution in bytes


class ShardedStreamService(ServingFrontEnd):
    """One ``StreamTree`` per site on ``device``; one all_gather of roots
    per refresh.

    ``sampler`` (default ``TorchSampler(cfg.seed)``) is split once into the
    trees' sampler (site i's tree draws from its ``fold_in(i)``) and the
    model sampler, as the reference splits its key.
    """

    _topology = "sharded"

    def __init__(self, cfg: ShardedServiceConfig,
                 sampler: Optional[Sampler] = None, device="cuda"):
        if cfg.n_sites < 1:
            raise ValueError(f"n_sites must be >= 1, got {cfg.n_sites}")
        super().__init__(cfg, device)
        sampler = sampler if sampler is not None else TorchSampler(cfg.seed)
        kt, self._model_key = sampler.split(2)
        site_cfg = cfg.site_tree_config()
        self.trees = [StreamTree(site_cfg, kt.fold_in(i), device=self.device)
                      for i in range(cfg.n_sites)]
        for i, tr in enumerate(self.trees):
            tr.obs_labels["site"] = i
        self._routed = 0             # round-robin cursor over sites
        self.last_refresh: Optional[RefreshStats] = None

    def _root_records(self) -> int:
        return self.num_records

    # ------------------------------------------------------------ write path
    def ingest(self, points, weights=None, site: int | None = None) -> None:
        """Feed raw points.

        ``site=None`` (dispatcher model): rows are interleaved round-robin
        over sites, continuing across calls, so every site sees an unbiased
        1/s sample of the stream.  ``site=i`` pins the whole batch to site i
        — the multi-host reality, where each host ingests only the traffic
        that reached it.
        """
        self.poll_refresh()
        cfg = self.cfg
        x, w = self._validate_points(points, weights)
        if site is not None:
            if not 0 <= site < cfg.n_sites:
                raise ValueError(
                    f"site {site} out of range [0, {cfg.n_sites})")
            sink = self.trees[site].ingest
        else:
            def sink(xc, wc):
                lanes = (self._routed + np.arange(xc.shape[0])) % cfg.n_sites
                for j in range(cfg.n_sites):
                    m = lanes == j
                    if m.any():
                        self.trees[j].ingest(xc[m],
                                             None if wc is None else wc[m])
                self._routed += xc.shape[0]
        self._ingest_cadenced(x, w, sink)

    # ------------------------------------------------------------ refresh fit
    def _collective_group(self):
        """The group the refresh gathers over, or None (host-sim)."""
        if self.cfg.use_shard_map:
            return sites_group(self.cfg.n_sites)
        return None

    def refresh(self, *, blocking: bool = True):
        """``ServingFrontEnd.refresh``; on the collective path an async
        refresh first joins the one in flight instead of coalescing with
        it: every rank must run every gathered refresh, in the same order,
        and whether a fit is still in flight depends on each rank's
        timing."""
        if not blocking and self._collective_group() is not None:
            self.join_refresh()
        return super().refresh(blocking=blocking)

    def _fit_closure(self, version: int):
        """Snapshot every site's packed root now; gather + fit later.

        With ``cfg.store`` set the fit's sampler derives from the per-site
        root epochs (monotone, so the tuple repeats iff no site's root
        moved): an unchanged gathered root refits bit-identically,
        licensing the incremental-refresh skip.  The opt-in warm start is
        host-sim only, as in the reference.
        """
        cfg = self.cfg
        recs = [tr.num_records for tr in self.trees]
        if sum(recs) == 0:
            raise RuntimeError("refresh() before any point was ingested")
        store, init = cfg.store, None
        epochs = tuple(tr.root_epoch for tr in self.trees)
        if store is not None:
            # touch the incremental-refresh series so a store-configured
            # run always exposes them (at zero until the first skip)
            obs.counter("refresh.skipped", topology=self._topology).inc(0)
            obs.counter("refresh.warm_starts",
                        topology=self._topology).inc(0)
            if (store.incremental_refresh and self.model is not None
                    and epochs == self._last_fit_epoch):
                return None
            self._pending_fit_epoch = epochs
        # one static row count for every site: the all_gather payload shape
        rows = _bucket(max(max(recs), 1))
        # per-site gather spans: inside refresh.gather, so one refresh
        # trace stitches every site's root snapshot under a single root
        roots = []
        for i, tr in enumerate(self.trees):
            with obs.trace("refresh.site_root", topology="sharded", site=i):
                roots.append(tr.packed_root(rows))
        group = self._collective_group()
        use_sm = group is not None
        one_site = roots[0]
        site_bytes = payload_bytes(one_site)
        self.last_refresh = RefreshStats(
            version=version,
            path="shard_map" if use_sm else "host-sim",
            root_rows=rows,
            per_site_records=tuple(recs),
            comm_records=int(sum(recs)),
            comm_bytes=gathered_bytes(one_site, cfg.n_sites),
            payload_bytes=site_bytes)
        # every site ships the same padded root shape, hence equal bytes
        obs.record_comm(recs, [site_bytes] * cfg.n_sites, topology="sharded")
        if store is not None:
            # epoch-keyed: the same roots refit to the same model.  The sum
            # is strictly monotone in the per-site epochs, so it collides
            # only when every site's root is unchanged.
            key = self._model_key.fold_in(sum(epochs))
            if (store.warm_start_frac > 0.0 and self.model is not None
                    and self._last_fit_epoch is not None and not use_sm):
                parts = [tr.changed_weight_since(e) for tr, e
                         in zip(self.trees, self._last_fit_epoch)]
                changed = sum(c for c, _ in parts)
                total = sum(t_ for _, t_ in parts)
                if changed <= store.warm_start_frac * total:
                    init = self.model.centers
                    obs.counter("refresh.warm_starts",
                                topology=self._topology).inc()
        else:
            key = self._model_key.fold_in(version)
        fit = functools.partial(
            fit_model, sampler=key, version=version, k=cfg.k, t=cfg.t,
            iters=cfg.second_iters, metric=cfg.metric, policy=cfg.policy,
            init_centers=init)

        def on_device(arrays):
            return [torch.from_numpy(a).to(self.device) for a in arrays]

        if not use_sm:
            # host-sim: concatenation in site order is exactly what the
            # collective delivers to every participant
            pts, wts, val = (np.concatenate(leaf) for leaf in zip(*roots))
            return functools.partial(fit, *on_device((pts, wts, val)))
        # collective: this rank ships its own site's root; the gather runs
        # with the fit (on the refresh worker when the refresh is async)
        mine = on_device(roots[dist.get_rank(group)])
        return lambda: fit(*gather_sites(tuple(mine), group))

    # ------------------------------------------------------------ aggregates
    @property
    def num_records(self) -> int:
        return sum(tr.num_records for tr in self.trees)

    @property
    def total_weight(self) -> float:
        return float(sum(tr.total_weight for tr in self.trees))

    @property
    def total_ingested(self) -> int:
        return sum(tr.total_ingested for tr in self.trees)

    # ------------------------------------------------------------ checkpoint
    def _state(self) -> dict:
        self.join_refresh()
        return {
            "sites": {f"site_{i:03d}": tr.pack_state()
                      for i, tr in enumerate(self.trees)},
            "model": self._model_arrays(),
            "counters": {
                "since_refresh": np.int64(self._since_refresh),
                "next_id": np.int64(self._next_id),
                "routed": np.int64(self._routed),
                "last_fit_epochs": (
                    np.full((self.cfg.n_sites,), -1, np.int64)
                    if self._last_fit_epoch is None
                    else np.asarray(self._last_fit_epoch, np.int64)),
                "model_key": np.asarray(self._model_key.key_data(),
                                        np.uint32),
            },
        }

    def _skeleton(self) -> dict:
        cfg = self.cfg
        site_cfg = cfg.site_tree_config()
        return {
            "sites": {f"site_{i:03d}": StreamTree.skeleton_state(site_cfg)
                      for i in range(cfg.n_sites)},
            "model": self._model_skeleton(cfg),
            "counters": {"since_refresh": np.int64(0), "next_id": np.int64(0),
                         "routed": np.int64(0),
                         "last_fit_epochs": np.full((cfg.n_sites,), -1,
                                                    np.int64),
                         "model_key": np.zeros((2,), np.uint32)},
        }

    def save(self, manager: CheckpointManager, step: int, *,
             blocking: bool = True, extra_meta: Optional[dict] = None) -> None:
        """``extra_meta``: caller facts merged into the manifest meta (the
        ``Session`` facade embeds its serialized ``PipelineConfig`` here)."""
        manager.save(step, self._state(), blocking=blocking,
                     meta={**(extra_meta or {}),
                           "format": "sharded-stream-v1",
                           "n_sites": self.cfg.n_sites})

    @classmethod
    def restore(cls, cfg: ShardedServiceConfig, manager: CheckpointManager,
                step: int | None = None, *,
                sampler_from_key_data: Optional[Callable] = None,
                device="cuda") -> "ShardedStreamService":
        """The service a checkpoint of either package holds, on ``device``.
        ``sampler_from_key_data`` rebuilds the trees' and the model's
        samplers from their ``(2,)`` uint32 words (default
        :meth:`TorchSampler.from_key_data`)."""
        meta = manager.read_meta(step)
        fmt = meta.get("format")
        if fmt is not None and fmt != "sharded-stream-v1":
            raise ValueError(
                f"checkpoint format {fmt!r} is not a sharded stream "
                f"checkpoint — restore it with the service that wrote it")
        ck_sites = meta.get("n_sites")
        if ck_sites is not None and ck_sites != cfg.n_sites:
            raise ValueError(
                f"checkpoint was written by {ck_sites} sites but the "
                f"restoring config has n_sites={cfg.n_sites}; per-site trees "
                f"cannot be re-sharded — restore with the writer's topology")
        rebuild = sampler_from_key_data or TorchSampler.from_key_data
        svc = cls(cfg, device=device)
        state, _ = manager.restore(svc._skeleton(), step)
        site_cfg = cfg.site_tree_config()
        svc.trees = [
            StreamTree.from_state(site_cfg, state["sites"][f"site_{i:03d}"],
                                  sampler_from_key_data=rebuild,
                                  device=svc.device)
            for i in range(cfg.n_sites)]
        for i, tr in enumerate(svc.trees):
            tr.obs_labels["site"] = i
        svc._since_refresh = int(state["counters"]["since_refresh"])
        svc._next_id = int(state["counters"]["next_id"])
        svc._routed = int(state["counters"]["routed"])
        lfe = np.asarray(state["counters"]["last_fit_epochs"])
        svc._last_fit_epoch = (tuple(int(e) for e in lfe)
                               if (lfe >= 0).all() else None)
        svc._model_key = rebuild(
            np.asarray(state["counters"]["model_key"], np.uint32))
        svc._install_model_arrays(state["model"])
        return svc
