"""Declarative pipeline configuration: one artifact describing a whole run.

Port of ``repro.api.config``.  ``PipelineConfig`` is the one front door:

* **problem** — what is being clustered: ``dim`` / ``k`` / ``t`` (the
  paper's z, the outlier budget) / ``metric``;
* **summarizer** — the :class:`repro_torch.summarize.SummarizerPolicy`
  selecting the per-site / per-leaf summary algorithm;
* **kernels** — the :class:`repro_torch.kernels.dispatch.KernelPolicy`
  selecting compute backends and tile sizes;
* **topology** — how the data reaches the coordinator: ``oneshot``
  (Algorithm 3 over a partitioned dataset), ``stream`` (single-host
  merge-and-reduce tree), or ``sharded`` (one tree per site, gathered
  roots), with the sites / window / cadence knobs that shape each.

Everything is a frozen dataclass of JSON-scalar fields, validated at
construction as the reference validates it (the same rules, the same
messages, the ``sharded`` kind and ``use_shard_map`` included), with an
exact ``to_dict`` / ``from_dict`` / JSON round-trip, so an artifact valid in
one package is valid in the other, and ``to_json()`` is the reference's
image byte for byte for every config.

**Backend names.** The port's kernels are the Pallas kernels' counterparts,
so ``_kernels_from`` reads an artifact's ``"pallas"`` backend as ``"cuda"``
and ``to_dict`` writes ``"cuda"`` back as ``"pallas"``: an artifact either
package writes loads in the other.  A ``KernelPolicy(backend="pallas")``
built in code still raises.

The stream layers' configs are *derived views*: :meth:`service_config`
projects a ``PipelineConfig`` onto ``repro_torch.stream.ServiceConfig``,
:meth:`sharded_config` onto ``ShardedServiceConfig``; the oneshot topology
maps onto ``simulate_coordinator``'s / ``distributed_cluster``'s keywords
(``api/session.py``).
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, Optional

from repro_torch.kernels.dispatch import (KernelPolicy, get_default_policy,
                                          BACKENDS)
from repro_torch.kernels.pdist.ref import METRICS
from repro_torch.obs.tracing import TraceSpec
from repro_torch.serve.spec import SHED_POLICIES, ServingSpec
from repro_torch.store.spec import StoreSpec
from repro_torch.stream.service import ServiceConfig
from repro_torch.stream.sharded import ShardedServiceConfig
from repro_torch.summarize.base import (SummarizerPolicy,
                                        get_default_summarizer,
                                        select_summarizer)

TOPOLOGIES = ("oneshot", "stream", "sharded")
PARTITIONS = ("random", "adversarial")
SITE_BUDGETS = ("full", "paper")

_CONFIG_VERSION = 2

# version N -> migration upgrading a version-N payload dict to N+1; the
# from_dict loop walks these until the payload reaches _CONFIG_VERSION.
# A version with no registered migration (older than any we still read,
# or newer than this build) is a hard error, exactly as before.
_MIGRATIONS: dict[int, Callable[[dict], dict]] = {}


def register_config_migration(from_version: int):
    """Decorator registering ``fn(payload) -> payload`` that upgrades a
    version-``from_version`` config payload (the ``to_dict`` image minus
    the ``version`` key) to version ``from_version + 1``.  Migrations
    chain: a v1 artifact read by a v3 build runs v1->v2 then v2->v3."""
    def deco(fn: Callable[[dict], dict]) -> Callable[[dict], dict]:
        _MIGRATIONS[from_version] = fn
        return fn
    return deco


@register_config_migration(1)
def _migrate_v1_to_v2(d: dict) -> dict:
    # v2 added the optional "store" section (tiered summary store +
    # incremental refresh).  A v1 payload is already a valid v2 payload —
    # absent "store" means no store, same semantics the v1 build had.
    warnings.warn(
        "reading a version-1 pipeline config; upgrading to version 2 "
        "(re-serialize with to_dict()/to_json() to persist the upgrade)",
        UserWarning, stacklevel=4)
    return d


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _int_field(name: str, v, lo: int) -> None:
    _require(isinstance(v, int) and not isinstance(v, bool) and v >= lo,
             f"{name} must be an int >= {lo}, got {v!r}")


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """What is being clustered: (k, t)-means/median with outliers in R^dim."""

    dim: int
    k: int
    t: int                  # outlier budget (the paper's z)
    metric: str = "l2sq"

    def __post_init__(self):
        _int_field("problem.dim", self.dim, 1)
        _int_field("problem.k", self.k, 1)
        _int_field("problem.t", self.t, 0)
        _require(self.metric in METRICS,
                 f"problem.metric must be one of {METRICS}, "
                 f"got {self.metric!r}")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """How data reaches the coordinator; knobs outside a kind's column must
    stay at their defaults (a windowed oneshot or a 3-site stream is a
    configuration error, not a silently-ignored field)."""

    kind: str = "oneshot"            # oneshot | stream | sharded
    sites: int = 1                   # oneshot partitions / sharded sites
    window: Optional[int] = None     # stream/sharded sliding window (raw pts)
    refresh_every: int = 8192        # stream/sharded model cadence (raw pts)
    leaf_size: int = 2048            # stream/sharded tree leaf
    micro_batch: int = 256           # scoring batch shape (all kinds)
    async_refresh: bool = False      # stream/sharded double-buffered refresh
    partition: str = "random"        # oneshot per-site budget mode
    site_budget: str = "full"        # sharded per-site root budget
    use_shard_map: bool = False      # oneshot/sharded: real collective

    def __post_init__(self):
        _require(self.kind in TOPOLOGIES,
                 f"topology.kind must be one of {TOPOLOGIES}, "
                 f"got {self.kind!r}")
        _int_field("topology.sites", self.sites, 1)
        _int_field("topology.refresh_every", self.refresh_every, 1)
        _int_field("topology.leaf_size", self.leaf_size, 1)
        _int_field("topology.micro_batch", self.micro_batch, 1)
        if self.window is not None:
            _int_field("topology.window", self.window, 1)
        _require(self.partition in PARTITIONS,
                 f"topology.partition must be one of {PARTITIONS}, "
                 f"got {self.partition!r}")
        _require(self.site_budget in SITE_BUDGETS,
                 f"topology.site_budget must be one of {SITE_BUDGETS}, "
                 f"got {self.site_budget!r}")
        if self.kind == "oneshot":
            _require(self.window is None,
                     "topology.window is a stream/sharded knob; a oneshot "
                     "run has no stream to window")
            _require(not self.async_refresh,
                     "topology.async_refresh is a stream/sharded knob")
            for name in ("refresh_every", "leaf_size"):
                default = type(self).__dataclass_fields__[name].default
                _require(getattr(self, name) == default,
                         f"topology.{name} is a stream/sharded tree knob; "
                         f"a oneshot run clusters everything in one pass "
                         f"(leave it at the default, {default})")
        if self.kind == "stream":
            _require(self.sites == 1,
                     "topology.sites > 1 needs kind='sharded' "
                     "(a single-host stream has exactly one site)")
            _require(not self.use_shard_map,
                     "topology.use_shard_map is a oneshot/sharded knob")
        if self.kind != "oneshot":
            _require(self.partition == "random",
                     "topology.partition is a oneshot knob")
        if self.kind != "sharded":
            _require(self.site_budget == "full",
                     "topology.site_budget is a sharded knob")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The one declarative description of a clustering pipeline.

    ``summarizer`` / ``kernels`` default to the process-wide policies
    *captured at construction* (same rule as the stream configs), so a
    serialized config is always concrete — ``to_dict`` never emits a
    "whatever the process default happens to be" placeholder.
    """

    problem: ProblemSpec
    topology: TopologySpec = TopologySpec()
    summarizer: Optional[SummarizerPolicy] = None
    kernels: Optional[KernelPolicy] = None
    second_iters: int = 25           # second-level k-means-- iterations
    seed: int = 0
    # None = serve with ServingSpec() defaults when score_stream is used;
    # set explicitly to pin admission control / batching in the artifact
    serving: Optional[ServingSpec] = None
    # None = process-default flight recorder (env knobs); set explicitly
    # to pin sampling / ring size in the artifact — applied to the
    # telemetry plane when a Session is constructed from this config
    tracing: Optional[TraceSpec] = None
    # None = keep every tree level resident and refit on every refresh
    # (the pre-v2 behavior, bit for bit); set a StoreSpec to bound hot
    # memory (spill cold levels, demand-page them back) and/or skip /
    # warm-start refreshes whose root did not change (stream/sharded only)
    store: Optional[StoreSpec] = None

    def __post_init__(self):
        _require(isinstance(self.problem, ProblemSpec),
                 f"problem must be a ProblemSpec, got {self.problem!r}")
        _require(isinstance(self.topology, TopologySpec),
                 f"topology must be a TopologySpec, got {self.topology!r}")
        _require(self.serving is None
                 or isinstance(self.serving, ServingSpec),
                 f"serving must be a ServingSpec or None, "
                 f"got {self.serving!r}")
        _require(self.tracing is None
                 or isinstance(self.tracing, TraceSpec),
                 f"tracing must be a TraceSpec or None, "
                 f"got {self.tracing!r}")
        _require(self.store is None or isinstance(self.store, StoreSpec),
                 f"store must be a StoreSpec or None, got {self.store!r}")
        if self.store is not None:
            _require(self.topology.kind != "oneshot",
                     "store is a stream/sharded knob: a oneshot run keeps "
                     "no tree to tier and refits from raw points every "
                     "time, so a store section would be silently inert")
        if self.summarizer is None:
            object.__setattr__(self, "summarizer", get_default_summarizer())
        if self.kernels is None:
            object.__setattr__(self, "kernels", get_default_policy())
        _int_field("second_iters", self.second_iters, 1)
        _require(isinstance(self.seed, int) and not isinstance(self.seed, bool),
                 f"seed must be an int, got {self.seed!r}")
        # the summarizer must actually serve this problem (an explicit name
        # that cannot is a config error now, not a runtime surprise later) ...
        p = self.problem
        spec = select_summarizer(self.summarizer, metric=p.metric,
                                 k=p.k, t=p.t)
        # ... and a shard_map oneshot additionally needs its fixed-shape
        # site path (host-driven summarizers only run host-simulated)
        if self.topology.kind == "oneshot" and self.topology.use_shard_map:
            _require(spec.site_summary is not None,
                     f"summarizer {spec.name!r} is host-driven (no "
                     f"fixed-shape site path) and cannot run under "
                     f"topology.use_shard_map; drop use_shard_map to run "
                     f"it host-simulated")

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """Exact, JSON-scalar dict image (``from_dict`` inverts it).  The
        ``serving`` section appears only when set — configs written before
        it existed stay byte-identical."""
        d = {
            "version": _CONFIG_VERSION,
            "problem": dataclasses.asdict(self.problem),
            "topology": dataclasses.asdict(self.topology),
            "summarizer": {
                "name": self.summarizer.name,
                "params": [[k, v] for k, v in self.summarizer.params],
            },
            "kernels": {**dataclasses.asdict(self.kernels),
                        "backend": _backend_to(self.kernels.backend)},
            "second_iters": self.second_iters,
            "seed": self.seed,
        }
        if self.serving is not None:
            d["serving"] = dataclasses.asdict(self.serving)
        if self.tracing is not None:
            d["tracing"] = dataclasses.asdict(self.tracing)
        if self.store is not None:
            d["store"] = dataclasses.asdict(self.store)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        """Inverse of :meth:`to_dict`; unknown or missing keys raise.

        Older serialized configs are upgraded in place through the
        registered migration chain (with a warning per hop); a version
        with no migration path to this build's still raises."""
        if not isinstance(d, dict):
            raise ValueError(f"expected a config dict, got {type(d).__name__}")
        d = dict(d)
        version = d.pop("version", _CONFIG_VERSION)
        while version != _CONFIG_VERSION:
            migrate = _MIGRATIONS.get(version)
            if migrate is None:
                raise ValueError(
                    f"config version {version!r} is not supported "
                    f"(this build reads version {_CONFIG_VERSION}"
                    + (f"; migrations exist from versions "
                       f"{sorted(_MIGRATIONS)}" if _MIGRATIONS else "")
                    + ")")
            d = migrate(dict(d))
            version += 1
        try:
            problem = d.pop("problem")
            topology = d.pop("topology", {})
            summarizer = d.pop("summarizer", None)
            kernels = d.pop("kernels", None)
            second_iters = d.pop("second_iters", 25)
            seed = d.pop("seed", 0)
            serving = d.pop("serving", None)
            tracing = d.pop("tracing", None)
            store = d.pop("store", None)
        except KeyError as e:
            raise ValueError(f"config is missing required section {e}")
        if d:
            raise ValueError(f"unknown config keys {sorted(d)}; expected "
                             f"problem/topology/summarizer/kernels/"
                             f"second_iters/seed/serving/tracing/store")
        return cls(
            problem=_spec_from(ProblemSpec, "problem", problem),
            topology=_spec_from(TopologySpec, "topology", topology),
            summarizer=_summarizer_from(summarizer),
            kernels=_kernels_from(kernels),
            second_iters=second_iters,
            seed=seed,
            serving=_serving_from(serving),
            tracing=_tracing_from(tracing),
            store=_store_from(store),
        )

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        return cls.from_dict(json.loads(text))

    # --------------------------------------------------------- derived views
    def service_config(self) -> ServiceConfig:
        """Project onto the single-host stream layer (kind == 'stream')."""
        _require(self.topology.kind == "stream",
                 f"service_config() needs topology.kind='stream', "
                 f"got {self.topology.kind!r}")
        return ServiceConfig(**self._base_service_kwargs())

    def sharded_config(self) -> ShardedServiceConfig:
        """Project onto the multi-site stream layer (kind == 'sharded')."""
        _require(self.topology.kind == "sharded",
                 f"sharded_config() needs topology.kind='sharded', "
                 f"got {self.topology.kind!r}")
        return ShardedServiceConfig(
            **self._base_service_kwargs(),
            n_sites=self.topology.sites,
            site_budget=self.topology.site_budget,
            use_shard_map=self.topology.use_shard_map,
        )

    def _base_service_kwargs(self) -> dict:
        p, topo = self.problem, self.topology
        return dict(
            dim=p.dim, k=p.k, t=p.t, metric=p.metric,
            leaf_size=topo.leaf_size, refresh_every=topo.refresh_every,
            micro_batch=topo.micro_batch, second_iters=self.second_iters,
            policy=self.kernels, summarizer=self.summarizer,
            window=topo.window, async_refresh=topo.async_refresh,
            seed=self.seed, store=self.store)


def _spec_from(cls, section: str, d) -> object:
    if not isinstance(d, dict):
        raise ValueError(f"config section {section!r} must be a dict, "
                         f"got {d!r}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown {section} keys {sorted(unknown)}; "
                         f"expected a subset of {sorted(known)}")
    return cls(**d)


def _summarizer_from(d) -> Optional[SummarizerPolicy]:
    if d is None or isinstance(d, SummarizerPolicy):
        return d
    if isinstance(d, str):
        return SummarizerPolicy(d)
    if not isinstance(d, dict) or set(d) - {"name", "params"}:
        raise ValueError(f"summarizer must be a name or a "
                         f"{{name, params}} dict, got {d!r}")
    params = d.get("params", ())
    try:
        pairs = tuple((str(k), v) for k, v in params)
    except (TypeError, ValueError):
        raise ValueError(f"summarizer params must be [key, value] pairs, "
                         f"got {params!r}")
    return SummarizerPolicy(d.get("name", "auto"), pairs)


def _serving_from(d) -> Optional[ServingSpec]:
    if d is None or isinstance(d, ServingSpec):
        return d
    if isinstance(d, str):
        # bare policy name: "shed" / "wait" with default bounds
        if d not in SHED_POLICIES:
            raise ValueError(f"serving must be a shed policy in "
                             f"{SHED_POLICIES} or a ServingSpec dict, "
                             f"got {d!r}")
        return ServingSpec(shed_policy=d)
    return _spec_from(ServingSpec, "serving", d)


def _store_from(d) -> Optional[StoreSpec]:
    if d is None or isinstance(d, StoreSpec):
        return d
    if isinstance(d, bool):
        # bare flag: store=True enables incremental refresh with no
        # tiering (everything stays resident); store=False is no store
        return StoreSpec() if d else None
    if isinstance(d, int):
        # bare int: hot-level budget with the other knobs defaulted
        return StoreSpec(hot_levels=d)
    return _spec_from(StoreSpec, "store", d)


def _tracing_from(d) -> Optional[TraceSpec]:
    if d is None or isinstance(d, TraceSpec):
        return d
    if isinstance(d, bool):
        # bare flag: tracing=False turns the flight recorder off
        return TraceSpec(enabled=d)
    if isinstance(d, (int, float)):
        # bare number: head-sampling rate with default ring/seed
        return TraceSpec(sample_rate=float(d))
    return _spec_from(TraceSpec, "tracing", d)


def _backend_from(name):
    # an artifact's "pallas" names the TPU kernels; the port's counterparts
    # are the "cuda" kernels
    return "cuda" if name == "pallas" else name


def _backend_to(name):
    # the inverse of _backend_from, for the artifact the port writes
    return "pallas" if name == "cuda" else name


def _kernels_from(d) -> Optional[KernelPolicy]:
    if d is None or isinstance(d, KernelPolicy):
        return d
    if isinstance(d, str):
        return KernelPolicy(backend=_backend_from(d))
    if not isinstance(d, dict) or set(d) - {"backend", "block_n", "autotune"}:
        raise ValueError(f"kernels must be a backend name in {BACKENDS} or a "
                         f"{{backend, block_n, autotune}} dict, got {d!r}")
    return KernelPolicy(backend=_backend_from(d.get("backend", "auto")),
                        block_n=d.get("block_n"),
                        autotune=bool(d.get("autotune", False)))


def pipeline_config(
    *,
    dim: int,
    k: int,
    t: int,
    metric: str = "l2sq",
    topology: str = "oneshot",
    summarizer=None,
    kernels=None,
    second_iters: int = 25,
    seed: int = 0,
    serving=None,
    tracing=None,
    store=None,
    **topology_kwargs,
) -> PipelineConfig:
    """Flat-keyword constructor — the ergonomic front door.

    ``topology`` is the kind; any remaining keywords are ``TopologySpec``
    fields (``sites=``, ``window=``, ``refresh_every=``, ...).
    ``summarizer`` / ``kernels`` also accept bare names
    (``summarizer="coreset"``, ``kernels="cuda"``; ``"pallas"`` reads as
    ``"cuda"``); ``serving`` accepts a
    :class:`repro_torch.serve.ServingSpec`, a ``{queue_bound, ...}`` dict,
    or a bare shed policy name (``serving="wait"``); ``tracing`` accepts a
    :class:`repro_torch.obs.TraceSpec`, a ``{sample_rate, ...}`` dict, a
    bare sampling rate (``tracing=0.1``) or flag (``tracing=False``);
    ``store`` accepts a :class:`repro_torch.store.StoreSpec`, a
    ``{hot_levels, ...}`` dict, a bare hot-level budget (``store=2``) or
    flag (``store=True`` = incremental refresh without tiering).

        cfg = pipeline_config(dim=5, k=20, t=500, topology="sharded",
                              sites=4, window=100_000, store=2)
    """
    return PipelineConfig(
        problem=ProblemSpec(dim=dim, k=k, t=t, metric=metric),
        topology=_spec_from(TopologySpec, "topology",
                            {"kind": topology, **topology_kwargs}),
        summarizer=_summarizer_from(summarizer),
        kernels=_kernels_from(kernels),
        second_iters=second_iters,
        seed=seed,
        serving=_serving_from(serving),
        tracing=_tracing_from(tracing),
        store=_store_from(store),
    )
