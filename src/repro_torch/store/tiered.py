"""Tiered summary store: hot (resident) summaries + a disk spill tier.

Port of ``repro.store.tiered``.  The merge-and-reduce tree's deep levels
are cold, immutable, fixed-shape blobs: once a level-l summary is built it
is only ever read again when a merge consumes it or a refresh gathers the
root.  ``TieredStore`` keeps a configurable hot set resident on the tree's
device (:class:`repro_torch.store.StoreSpec` — levels ``<= hot_levels``
and/or total payload ``<= hot_bytes``) and moves everything else through
:class:`repro_torch.checkpoint.manager.CheckpointManager` to disk: one
checkpoint step per spilled summary, crc-verified npy leaves, atomic
publish, and the manager's single async writer thread doubling as the
spill worker (a spill copies the summary to the host, enqueues the write
and returns; the write happens off the ingest path).

Demand paging is transient: ``page_in`` faults a spilled summary back onto
the device exactly when ``_merge_pair`` / ``root()`` / ``pack_state``
touch it and returns it *without* re-admitting it to the hot set — the
caller either consumes it immediately (merge, then ``discard``) or drops
the reference (root gather), so resident bytes stay bounded by the hot
budget plus one summary.

The store never changes *values*: a paged-in summary is field-for-field
identical to what was spilled (float32/bool payloads round-trip exactly;
``n_rounds`` / ``total_weight`` are carried verbatim), so the tree root —
and every downstream score — is bit-identical to an untiered tree.
Telemetry is the reference's: the ``store.spill`` / ``store.page_in``
spans, the ``store.*`` movement counters and residency gauges, labelled
by the owning tree's ``obs_labels``.
"""
from __future__ import annotations

import shutil
import tempfile
import weakref
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.store.spec import StoreSpec
from repro_torch.stream.weighted import WeightedSummary

_COUNTERS = ("store.spills", "store.page_ins", "store.spill_bytes",
             "store.page_in_bytes")


def summary_nbytes(summ: WeightedSummary) -> int:
    """Payload bytes a summary holds resident (points + weights + mask)."""
    return int(sum(a.numel() * a.element_size()
                   for a in (summ.points, summ.weights, summ.is_candidate)))


class TieredStore:
    """Spill/page-in engine for one tree's summaries.

    ``nodes`` passed to :meth:`enforce` / :meth:`sync` are
    ``repro_torch.stream.tree.TreeNode`` objects (duck-typed: the store
    reads ``summary`` / ``level`` / ``n_records`` / ``nbytes`` and owns
    ``spill_step``).  Each spilled summary becomes one checkpoint step
    under a per-store temp subdirectory, so two trees (or a restore of
    the same tree) sharing ``spec.directory`` never collide.  Paged-in
    summaries land on ``device`` (the tree's).
    """

    def __init__(self, spec: StoreSpec, *, dim: int,
                 labels: Optional[dict] = None, device="cuda"):
        self.spec = spec
        self.dim = dim
        self.labels = labels if labels is not None else {}
        self.device = resolve_device(device)
        if spec.directory is None:
            base = Path(tempfile.mkdtemp(prefix="repro-store-"))
            cleanup_root = base
        else:
            base = Path(spec.directory)
            base.mkdir(parents=True, exist_ok=True)
            cleanup_root = None
        self.dir = Path(tempfile.mkdtemp(prefix="tier-", dir=base))
        self.manager = CheckpointManager(self.dir, keep_last=0)
        self._next_step = 0
        # local tallies mirror the obs counters so tests/benches can read
        # them even with the metrics plane disabled
        self.spills = 0
        self.page_ins = 0
        self.spill_bytes = 0
        self.page_in_bytes = 0
        self._finalizer = weakref.finalize(
            self, shutil.rmtree, str(cleanup_root or self.dir),
            ignore_errors=True)

    # ------------------------------------------------------------ movement
    def spill(self, nd) -> None:
        """Serialize ``nd``'s summary to the disk tier (async) and drop the
        resident copy.  The manager's writer thread is the spill worker;
        enqueueing joins at most the one previous in-flight write."""
        summ = nd.summary
        with obs.trace("store.spill", **self.labels):
            payload = {
                "points": summ.points.to(torch.float32),
                "weights": summ.weights.to(torch.float32),
                "is_candidate": summ.is_candidate.to(torch.bool),
                "n_rounds": np.int64(summ.n_rounds),
                "total_weight": np.float64(summ.total_weight),
            }
            step = self._next_step
            self._next_step += 1
            self.manager.save(step, payload, blocking=False)
        nd.spill_step = step
        nd.summary = None
        self.spills += 1
        self.spill_bytes += nd.nbytes
        obs.counter("store.spills", **self.labels).inc()
        obs.counter("store.spill_bytes", **self.labels).inc(nd.nbytes)

    def page_in(self, nd) -> WeightedSummary:
        """Fault ``nd``'s spilled summary back from disk (crc-verified).

        Transient: the node stays cold — the caller consumes the returned
        summary and drops it (or discards the node), so the hot budget is
        exceeded by at most one summary at a time."""
        n, d = nd.n_records, self.dim
        like = {
            "points": np.zeros((n, d), np.float32),
            "weights": np.zeros((n,), np.float32),
            "is_candidate": np.zeros((n,), bool),
            "n_rounds": np.int64(0),
            "total_weight": np.float64(0),
        }
        with obs.trace("store.page_in", **self.labels):
            state, _ = self.manager.restore(like, nd.spill_step)
        self.page_ins += 1
        self.page_in_bytes += nd.nbytes
        obs.counter("store.page_ins", **self.labels).inc()
        obs.counter("store.page_in_bytes", **self.labels).inc(nd.nbytes)
        return WeightedSummary(
            points=torch.as_tensor(state["points"], device=self.device),
            weights=torch.as_tensor(state["weights"], device=self.device),
            is_candidate=torch.as_tensor(state["is_candidate"],
                                         device=self.device),
            n_rounds=int(state["n_rounds"]),
            total_weight=float(state["total_weight"]))

    def discard(self, nd) -> None:
        """Forget a node the tree dropped (merged away or evicted): delete
        its spill blob, if any, so the disk tier never grows stale steps."""
        if getattr(nd, "spill_step", None) is None:
            return
        self.manager.wait()   # its write may still be in flight
        shutil.rmtree(self.dir / f"step_{nd.spill_step:09d}",
                      ignore_errors=True)
        nd.spill_step = None

    # ------------------------------------------------------------ policy
    def enforce(self, nodes) -> None:
        """Apply the hot budget: spill any resident summary the level rule
        marks cold, then — if a byte budget is set — spill
        deepest-then-oldest residents until under it.  Deepest first
        because level-0 nodes merge soonest: spilling them would fault
        straight back in on the next flush."""
        spec = self.spec
        if spec.hot_levels is not None:
            for nd in nodes:
                if nd.summary is not None and nd.level > spec.hot_levels:
                    self.spill(nd)
        if spec.hot_bytes is not None:
            resident = [nd for nd in nodes if nd.summary is not None]
            resident_bytes = sum(nd.nbytes for nd in resident)
            order = sorted(range(len(resident)),
                           key=lambda i: (-resident[i].level, i))
            for i in order:
                if resident_bytes <= spec.hot_bytes:
                    break
                resident_bytes -= resident[i].nbytes
                self.spill(resident[i])
        self.sync(nodes)

    def sync(self, nodes) -> None:
        """Recompute the residency gauges from the live node list (and make
        sure every store series exists, at zero, from the first flush on)."""
        reg = obs.get_default_registry()
        if not reg.enabled:
            return
        for name in _COUNTERS:
            reg.counter(name, **self.labels)
        hot = [nd for nd in nodes if nd.summary is not None]
        cold = [nd for nd in nodes if getattr(nd, "spill_step", None)
                is not None]
        reg.gauge("store.hot_bytes", **self.labels).set(
            sum(nd.nbytes for nd in hot))
        reg.gauge("store.hot_nodes", **self.labels).set(len(hot))
        reg.gauge("store.cold_bytes", **self.labels).set(
            sum(nd.nbytes for nd in cold))
        reg.gauge("store.cold_nodes", **self.labels).set(len(cold))

    # ------------------------------------------------------------ admin
    def stats(self) -> dict:
        """Movement tallies (metrics-plane-independent, for tests and the
        smoke run)."""
        return {"spills": self.spills, "page_ins": self.page_ins,
                "spill_bytes": self.spill_bytes,
                "page_in_bytes": self.page_in_bytes}

    def flush(self) -> None:
        """Join the spill worker (re-raising any writer error)."""
        self.manager.wait()

    def close(self) -> None:
        """Join the writer and delete this store's on-disk tier."""
        try:
            self.manager.wait()
        finally:
            self._finalizer()
