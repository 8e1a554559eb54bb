"""Merge-and-reduce buffer tree over weighted summaries.

Port of ``repro.stream.tree``.  Ingest path: raw points accumulate in a
host-side leaf buffer; every ``leaf_size`` points the buffer is reduced to
a level-0 weighted summary on the tree's device (by default Algorithm 1 at
full outlier budget t; ``TreeConfig.summarizer`` selects any registered
``repro_torch.summarize`` algorithm for both the leaf reduction and the
merge-reduce step).  Whenever two summaries share a level, the older pair
is merged (concatenate) and reduced (the summarizer re-run on the union)
into one level-(l+1) summary — the classic binary-counter coreset tree, so
a stream of n points holds at most O(log(n / leaf_size)) live summaries of
O(m + 8t) records each: O(m log n) memory total.  Mass conservation — the
summarize-registry contract — is what makes any registered summarizer safe
to slot in here.

Sliding window (optional): with ``window=W`` set, merges are capped so no
summary spans more than max(leaf_size, W // 4) raw points, and summaries
whose newest point has fallen out of the window are evicted whole.  The
model then tracks the last ~W points with eviction granularity <= W/4.

Tiered storage (optional): with ``TreeConfig.store`` set to a tiered
:class:`repro_torch.store.StoreSpec`, summaries beyond the hot budget
spill to disk through :class:`repro_torch.store.TieredStore` and are
demand-paged back exactly when a merge, ``root()`` or ``pack_state()``
touches them — the root stays bit-identical to the all-resident tree, only
residency moves.  The tree also tracks a monotone ``root_epoch`` (bumped on
every mutation that changes ``root()``) plus per-node creation epochs,
which is what lets the serving layer skip or warm-start provably-redundant
refreshes.

Randomness: a :class:`~repro_torch.core.sampler.Sampler` takes the place
of the reference's key; the tree splits it once per leaf flush and once
per merge, in the reference's order, so a replaying sampler gives the
reference's tree bit for bit.

Checkpointing: the tree's state packs into a *fixed-shape* dict of numpy
arrays (``pack_state``/``from_state``), leaf for leaf the reference's —
the sampler's state is the ``(2,)`` uint32 ``key_data`` leaf — so
``CheckpointManager`` saves and restores it in either package.  Spilled
summaries are paged in for the pack (a checkpoint is self-contained) and
the restored tree re-applies its hot budget.

``root()``, ``packed_root()`` and ``pack_state()`` return numpy, as the
reference's do.  Telemetry is the reference's: the ``ingest.leaf_flush``
and ``ingest.merge_reduce`` spans, the ``tree.*`` counters and gauges,
labelled by ``obs_labels`` (the sharded service adds each site's id).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, TYPE_CHECKING

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.sampler import Sampler, TorchSampler
from repro_torch.kernels.dispatch import KernelPolicy, get_default_policy
from repro_torch.store.spec import StoreSpec
from repro_torch.stream.weighted import WeightedSummary, _bucket
from repro_torch.summarize.base import (SummarizerPolicy,
                                        get_default_summarizer, record_bound,
                                        reduce_summaries, summarize)

if TYPE_CHECKING:   # runtime import is lazy: repro_torch.store.tiered
    from repro_torch.store.tiered import TieredStore   # imports this package


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    dim: int
    k: int
    t: int
    leaf_size: int = 2048
    alpha: float = 2.0
    beta: float = 0.45
    metric: str = "l2sq"
    # None = capture the process default (set_default_policy) at construction
    policy: Optional[KernelPolicy] = None
    # None = capture the process default (set_default_summarizer); the
    # default "auto" resolves to the paper summarizer
    summarizer: Optional[SummarizerPolicy] = None
    window: Optional[int] = None     # raw points; None = full stream
    max_summaries: int = 64          # checkpoint slots; force-merge beyond
    max_points: int = 2 ** 34        # stream-length bound for the record cap
    seed: int = 0
    # None = everything resident (the classic in-memory tree); a tiered
    # StoreSpec spills cold levels to disk behind the same root
    store: Optional[StoreSpec] = None

    def __post_init__(self):
        if self.policy is None:
            object.__setattr__(self, "policy", get_default_policy())
        if self.summarizer is None:
            object.__setattr__(self, "summarizer", get_default_summarizer())


def record_cap(cfg: TreeConfig) -> int:
    """Static per-summary record capacity for checkpoint packing.

    Delegates to the selected summarizer's registered ``record_bound`` —
    for the paper summarizer: centers <= rounds * m where rounds depends
    only on the mass (<= the mass bound below) and candidates carry >= 1
    mass each in tree use (raw points enter with unit weight), so <= 8t.

    With a sliding window the mass bound tightens: no summary can carry
    more mass than the live stream, which eviction keeps under
    ``window + merge-span + flush slack`` (unit weights).  The force-merge
    loop in ``_compact`` ignores the span cap, so the tightening only
    applies when the checkpoint slot budget provably keeps force-merge
    from firing (every node carries >= leaf_size mass, so the node count
    never exceeds live_mass // leaf_size).  Non-windowed configs keep the
    ``cfg.max_points`` stream-length bound unchanged.
    """
    max_points = cfg.max_points
    if cfg.window is not None:
        span = max(cfg.leaf_size, cfg.window // 4)
        live = cfg.window + span + 2 * cfg.leaf_size
        if live // cfg.leaf_size + 1 <= cfg.max_summaries:
            max_points = min(max_points, live)
    return record_bound(cfg.summarizer, metric=cfg.metric, k=cfg.k, t=cfg.t,
                        alpha=cfg.alpha, beta=cfg.beta,
                        max_points=max_points, leaf_size=cfg.leaf_size)


@dataclasses.dataclass
class TreeNode:
    summary: Optional[WeightedSummary]   # None while spilled to the store
    level: int
    min_seq: int    # [min_seq, max_seq): raw-point sequence ids spanned
    max_seq: int
    count: int      # raw points spanned
    # metadata that must survive a spill (the store rebuilds the summary
    # from these + the on-disk blob) and feed refresh reuse decisions
    epoch: int = 0           # tree root_epoch when this node was created
    n_records: int = 0       # summary rows (== summary.points.shape[0])
    nbytes: int = 0          # resident payload bytes of the summary
    weight: float = 0.0      # summary mass (WeightedSummary.total_weight)
    spill_step: Optional[int] = None   # store step id while spilled


def _empty_state(cfg: TreeConfig, cap: int) -> dict:
    """``pack_state``'s layout at zero: the reference's leaves and shapes."""
    S = cfg.max_summaries
    return {
        "points": np.zeros((S, cap, cfg.dim), np.float32),
        "weights": np.zeros((S, cap), np.float32),
        "is_candidate": np.zeros((S, cap), bool),
        "valid": np.zeros((S, cap), bool),
        "level": np.full((S,), -1, np.int32),
        "min_seq": np.zeros((S,), np.int64),
        "max_seq": np.zeros((S,), np.int64),
        "count": np.zeros((S,), np.int64),
        "node_epoch": np.zeros((S,), np.int64),
        "root_epoch": np.int64(0),
        "buffer": np.zeros((cfg.leaf_size, cfg.dim), np.float32),
        "buffer_w": np.zeros((cfg.leaf_size,), np.float32),
        "buffer_n": np.int64(0),
        "flushed": np.int64(0),
        "total_ingested": np.int64(0),
        "key_data": np.zeros((2,), np.uint32),
    }


class StreamTree:
    """Mergeable summary tree: the leaf buffer in host numpy, summaries as
    tensors on ``device``."""

    def __init__(self, cfg: TreeConfig, sampler: Optional[Sampler] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sampler = (sampler if sampler is not None
                        else TorchSampler(cfg.seed))
        self.nodes: List[TreeNode] = []      # chronological order
        self._buf = np.zeros((cfg.leaf_size, cfg.dim), np.float32)
        self._buf_w = np.zeros((cfg.leaf_size,), np.float32)
        self._buf_n = 0
        self._flushed = 0                    # raw points reduced into leaves
        self.total_ingested = 0
        self._cap = record_cap(cfg)
        self._epoch = 0                      # bumped whenever root() changes
        # the spill tier is created lazily, on the first budget enforcement:
        # skeleton/throwaway trees never touch disk
        self._store: Optional[TieredStore] = None
        # telemetry labels; owners may add context after construction (the
        # sharded service tags each site's tree with its site id)
        self.obs_labels: dict = {"summarizer": cfg.summarizer.name}

    # ------------------------------------------------------------ ingest
    def ingest(self, points, weights=None) -> None:
        x = np.asarray(points, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.cfg.dim:
            raise ValueError(f"expected dim {self.cfg.dim}, got {x.shape[1]}")
        w = (np.ones((x.shape[0],), np.float32) if weights is None
             else np.asarray(weights, np.float32).reshape(-1))
        if w.shape[0] != x.shape[0]:
            raise ValueError(
                f"{w.shape[0]} weights for {x.shape[0]} points — a silent "
                f"truncation here would break mass conservation")
        if x.shape[0]:
            self._epoch += 1   # buffered rows are part of root()
        i = 0
        while i < x.shape[0]:
            take = min(self.cfg.leaf_size - self._buf_n, x.shape[0] - i)
            self._buf[self._buf_n:self._buf_n + take] = x[i:i + take]
            self._buf_w[self._buf_n:self._buf_n + take] = w[i:i + take]
            self._buf_n += take
            self.total_ingested += take
            i += take
            if self._buf_n == self.cfg.leaf_size:
                self._flush_leaf()

    def _next_key(self) -> Sampler:
        self.sampler, sk = self.sampler.split(2)
        return sk

    def _flush_leaf(self) -> None:
        cfg = self.cfg
        with obs.trace("ingest.leaf_flush", **self.obs_labels):
            summ = summarize(
                self._buf[:self._buf_n], self._buf_w[:self._buf_n],
                self._next_key(), k=cfg.k, t=cfg.t, alpha=cfg.alpha,
                beta=cfg.beta, metric=cfg.metric, policy=cfg.summarizer,
                kernel_policy=cfg.policy, device=self.device)
        obs.counter("tree.leaf_flushes", **self.obs_labels).inc()
        self._check_cap(summ)
        self._epoch += 1
        self.nodes.append(self._make_node(
            summ, level=0, min_seq=self._flushed,
            max_seq=self._flushed + self._buf_n, count=self._buf_n))
        self._flushed += self._buf_n
        self._buf_n = 0
        self._evict()
        self._compact()
        self._enforce_store()
        self._update_gauges()

    def _update_gauges(self) -> None:
        reg = obs.get_default_registry()
        if not reg.enabled:
            return
        reg.gauge("tree.records", **self.obs_labels).set(self.num_records)
        reg.gauge("tree.summaries", **self.obs_labels).set(len(self.nodes))
        reg.gauge("tree.max_level", **self.obs_labels).set(
            max((nd.level for nd in self.nodes), default=0))

    def _check_cap(self, summ: WeightedSummary) -> None:
        if summ.points.shape[0] > self._cap:
            raise RuntimeError(
                f"summary has {summ.points.shape[0]} records > static cap "
                f"{self._cap}; raise TreeConfig.max_points or check weights "
                f"(sub-unit weights break the 8t candidate-count bound)")

    # ------------------------------------------------------------ store
    def _make_node(self, summ: WeightedSummary, *, level: int, min_seq: int,
                   max_seq: int, count: int) -> TreeNode:
        from repro_torch.store.tiered import summary_nbytes
        return TreeNode(
            summary=summ, level=level, min_seq=min_seq, max_seq=max_seq,
            count=count, epoch=self._epoch,
            n_records=int(summ.points.shape[0]),
            nbytes=summary_nbytes(summ),
            weight=float(summ.total_weight))

    @property
    def store(self) -> Optional[TieredStore]:
        """The spill tier, created on first use (None until then, and
        forever when the config has no tiered store)."""
        cfg = self.cfg
        if self._store is None and cfg.store is not None and cfg.store.tiered:
            from repro_torch.store.tiered import TieredStore
            self._store = TieredStore(cfg.store, dim=cfg.dim,
                                      labels=self.obs_labels,
                                      device=self.device)
        return self._store

    def _enforce_store(self) -> None:
        if self.cfg.store is not None and self.cfg.store.tiered:
            self.store.enforce(self.nodes)

    def _node_summary(self, nd: TreeNode) -> WeightedSummary:
        """The node's summary, demand-paged from the spill tier if cold
        (transient — the node stays cold; see TieredStore.page_in)."""
        if nd.summary is not None:
            return nd.summary
        return self._store.page_in(nd)

    def _discard_node(self, nd: TreeNode) -> None:
        if nd.spill_step is not None:
            self._store.discard(nd)

    @property
    def root_epoch(self) -> int:
        """Monotone counter, bumped on every mutation that changes
        ``root()`` (ingest, flush, merge, evict).  Equal epochs imply an
        identical root, which is what licenses skipping a refresh."""
        return self._epoch

    def level_epochs(self) -> dict[int, int]:
        """Per-level dirty epoch: the newest node-creation epoch at each
        live level (diagnostics for the incremental-refresh decisions)."""
        out: dict[int, int] = {}
        for nd in self.nodes:
            out[nd.level] = max(out.get(nd.level, 0), nd.epoch)
        return out

    def changed_weight_since(self, epoch: int) -> tuple[float, float]:
        """(mass created after ``epoch``, total live mass) — from node
        metadata + the buffer, no page-ins.  The serving layer compares
        the ratio against ``StoreSpec.warm_start_frac``."""
        buf = float(self._buf_w[:self._buf_n].sum()) if self._buf_n else 0.0
        changed = buf + sum(nd.weight for nd in self.nodes
                            if nd.epoch > epoch)
        total = buf + sum(nd.weight for nd in self.nodes)
        return changed, total

    # ------------------------------------------------------------ merge
    def _evict(self) -> None:
        if self.cfg.window is None:
            return
        cutoff = self.total_ingested - self.cfg.window
        keep = [nd for nd in self.nodes if nd.max_seq > cutoff]
        if len(keep) < len(self.nodes):
            obs.counter("tree.evictions",
                        **self.obs_labels).inc(len(self.nodes) - len(keep))
            self._epoch += 1
            for nd in self.nodes:
                if nd.max_seq <= cutoff:
                    self._discard_node(nd)   # spilled blob leaves with it
        self.nodes = keep

    def _merge_pair(self, i: int, j: int) -> None:
        a, b = self.nodes[i], self.nodes[j]
        cfg = self.cfg
        with obs.trace("ingest.merge_reduce", **self.obs_labels):
            # demand-page spilled operands exactly here, where the merge
            # actually consumes them
            summ = reduce_summaries(
                [self._node_summary(a), self._node_summary(b)],
                self._next_key(), k=cfg.k, t=cfg.t,
                alpha=cfg.alpha, beta=cfg.beta, metric=cfg.metric,
                policy=cfg.summarizer, kernel_policy=cfg.policy)
        obs.counter("tree.merges", **self.obs_labels).inc()
        self._check_cap(summ)
        self._epoch += 1
        self.nodes[i] = self._make_node(
            summ, level=max(a.level, b.level) + 1,
            min_seq=min(a.min_seq, b.min_seq),
            max_seq=max(a.max_seq, b.max_seq),
            count=a.count + b.count)
        del self.nodes[j]
        self._discard_node(a)
        self._discard_node(b)

    def _max_span(self) -> Optional[int]:
        if self.cfg.window is None:
            return None
        return max(self.cfg.leaf_size, self.cfg.window // 4)

    def _compact(self) -> None:
        span = self._max_span()
        while True:
            by_level: dict[int, list[int]] = {}
            for i, nd in enumerate(self.nodes):
                by_level.setdefault(nd.level, []).append(i)
            pair = None
            for lvl in sorted(by_level):
                ids = by_level[lvl]
                if len(ids) < 2:
                    continue
                i, j = ids[0], ids[1]   # oldest two of this level
                if span is not None and \
                        self.nodes[i].count + self.nodes[j].count > span:
                    continue
                pair = (i, j)
                break
            if pair is None:
                break
            self._merge_pair(*pair)
        # checkpoint slots are finite: collapse the two oldest summaries
        # regardless of level rather than overflow.
        while len(self.nodes) > self.cfg.max_summaries:
            self._merge_pair(0, 1)

    # ------------------------------------------------------------ read
    def root(self, include_buffer: bool = True):
        """Union of all live summaries (+ the unreduced buffer as unit-ish
        weighted raw records): numpy (points (s,d), weights (s,),
        is_candidate).  Spilled summaries are paged in transiently — the
        concatenation is bit-identical to the all-resident tree's."""
        summs = [self._node_summary(nd) for nd in self.nodes]
        pts = [s.points for s in summs]
        wts = [s.weights for s in summs]
        cand = [s.is_candidate for s in summs]
        host = []
        if pts:
            host = [torch.cat(a).cpu().numpy() for a in (pts, wts, cand)]
        if include_buffer and self._buf_n:
            buf = (self._buf[:self._buf_n], self._buf_w[:self._buf_n],
                   np.zeros((self._buf_n,), bool))
            host = ([np.concatenate([h, b]) for h, b in zip(host, buf)]
                    if host else [b.copy() for b in buf])
        if not host:
            return (np.zeros((0, self.cfg.dim), np.float32),
                    np.zeros((0,), np.float32), np.zeros((0,), bool))
        return tuple(host)

    def packed_root(self, rows: int | None = None,
                    include_buffer: bool = True):
        """``root()`` padded to a static row count.

        Returns ``(points (rows, d) f32, weights (rows,) f32,
        valid (rows,) bool)`` with zero rows / zero weight / False beyond the
        live records — exactly the (points, weights, valid) triple the
        second-level ``kmeans_minus_minus`` consumes.  ``rows`` defaults to
        the shared power-of-two bucket of the live record count, as in the
        reference (whose k-means++ draw, over one logit per row, depends on
        it).
        """
        pts, wts, _ = self.root(include_buffer)
        s = pts.shape[0]
        rows = _bucket(max(s, 1)) if rows is None else rows
        if s > rows:
            raise ValueError(f"{s} live records exceed packed capacity {rows}")
        out_p = np.zeros((rows, self.cfg.dim), np.float32)
        out_w = np.zeros((rows,), np.float32)
        out_v = np.zeros((rows,), bool)
        out_p[:s] = pts
        out_w[:s] = wts
        out_v[:s] = True
        return out_p, out_w, out_v

    @property
    def total_weight(self) -> float:
        _, w, _ = self.root()
        return float(w.sum())

    @property
    def num_records(self) -> int:
        # node metadata, not the summaries: must not fault spilled nodes in
        return sum(nd.n_records for nd in self.nodes) + self._buf_n

    # ------------------------------------------------------------ state
    def pack_state(self) -> dict:
        """Fixed-shape dict of the full tree state (CheckpointManager-safe),
        leaf for leaf the reference's."""
        cfg, S = self.cfg, self.cfg.max_summaries
        if len(self.nodes) > S:
            raise RuntimeError(f"{len(self.nodes)} summaries > {S} slots")
        st = _empty_state(cfg, self._cap)
        for i, nd in enumerate(self.nodes):
            summ = self._node_summary(nd)   # checkpoints are self-contained
            s = summ.points.shape[0]
            st["points"][i, :s] = summ.points.cpu().numpy()
            st["weights"][i, :s] = summ.weights.cpu().numpy()
            st["is_candidate"][i, :s] = summ.is_candidate.cpu().numpy()
            st["valid"][i, :s] = True
            st["level"][i] = nd.level
            st["min_seq"][i], st["max_seq"][i] = nd.min_seq, nd.max_seq
            st["count"][i] = nd.count
            st["node_epoch"][i] = nd.epoch
        st.update(
            root_epoch=np.int64(self._epoch),
            buffer=self._buf.copy(), buffer_w=self._buf_w.copy(),
            buffer_n=np.int64(self._buf_n), flushed=np.int64(self._flushed),
            total_ingested=np.int64(self.total_ingested),
            key_data=np.asarray(self.sampler.key_data(), np.uint32))
        return st

    @classmethod
    def skeleton_state(cls, cfg: TreeConfig) -> dict:
        """Zero state with the shapes pack_state produces — the ``tree_like``
        argument CheckpointManager.restore needs."""
        return _empty_state(cfg, record_cap(cfg))

    @classmethod
    def from_state(cls, cfg: TreeConfig, state: dict, *,
                   sampler_from_key_data: Optional[Callable] = None,
                   device="cuda") -> "StreamTree":
        """The tree ``state`` packs, on ``device``.  ``sampler_from_key_data``
        rebuilds the sampler from the ``key_data`` words (default
        :meth:`TorchSampler.from_key_data`)."""
        g = {k: np.asarray(v) for k, v in state.items()}
        rebuild = sampler_from_key_data or TorchSampler.from_key_data
        tree = cls(cfg, rebuild(g["key_data"].astype(np.uint32)),
                   device=device)
        tree._buf = g["buffer"].astype(np.float32).copy()
        tree._buf_w = g["buffer_w"].astype(np.float32).copy()
        tree._buf_n = int(g["buffer_n"])
        tree._flushed = int(g["flushed"])
        tree.total_ingested = int(g["total_ingested"])
        tree._epoch = int(g["root_epoch"])
        dev = tree.device
        for i in range(cfg.max_summaries):
            if int(g["level"][i]) < 0:
                continue
            v = g["valid"][i]
            w = g["weights"][i][v].astype(np.float32)
            summ = WeightedSummary(
                points=torch.as_tensor(g["points"][i][v].astype(np.float32),
                                       device=dev),
                weights=torch.as_tensor(w, device=dev),
                is_candidate=torch.as_tensor(
                    g["is_candidate"][i][v].astype(bool), device=dev),
                n_rounds=0,
                total_weight=float(w.sum()))
            nd = tree._make_node(
                summ, level=int(g["level"][i]),
                min_seq=int(g["min_seq"][i]), max_seq=int(g["max_seq"][i]),
                count=int(g["count"][i]))
            nd.epoch = int(g["node_epoch"][i])
            tree.nodes.append(nd)
        tree._enforce_store()   # restored nodes re-obey the hot budget
        return tree
