"""Online health monitors over the telemetry plane.

Port of ``repro.obs.monitors`` (the reference's text; it imports no JAX).

The paper's contract is quantitative: a (k, z)-fit flags roughly z of
the n trained points as outliers, so the *live* outlier fraction of a
healthy stream should hover near the configured ``z / n`` budget.  When
it leaves that band the data has drifted (or a site has gone bad —
exactly the detection signal robust-aggregation schemes assume exists).
These monitors watch that, plus two serving-health invariants, and emit
typed :class:`Alert` records into ``snapshot()`` (schema v2):

- :class:`OutlierRateMonitor` — EWMA of the observed outlier fraction
  of scored queries vs a multiplicative band around the configured
  ``z / trained_weight`` fraction.
- :class:`StalenessMonitor` — model age (``seconds_since_install``) vs
  a freshness SLO; a stale model silently mis-scores drifted data.
- :class:`ShedRateMonitor` — EWMA of the admission shed fraction vs a
  burn threshold; sustained shedding means capacity, not a blip.

A :class:`MonitorHub` instance hangs off each ``MetricsRegistry`` so
``using_registry`` isolates monitor state exactly like metric state.
All monitors are passive: layers feed them observations, and alerts are
evaluated lazily at ``snapshot()`` time.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "Alert",
    "OutlierRateMonitor",
    "StalenessMonitor",
    "ShedRateMonitor",
    "MonitorHub",
]


class Alert(NamedTuple):
    """One triggered monitor condition, stable enough to snapshot."""

    name: str
    severity: str
    message: str
    value: float
    threshold: float
    labels: Tuple[Tuple[str, str], ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "severity": self.severity,
            "message": self.message,
            "value": round(float(self.value), 6),
            "threshold": round(float(self.threshold), 6),
            "labels": dict(self.labels),
        }


class OutlierRateMonitor:
    """EWMA outlier fraction vs the configured z/n band.

    The budget is ``t / trained_weight`` — the fraction of the trained
    mass the fit was allowed to discard — installed by the service at
    every model refresh.  The band is multiplicative
    (``[budget / band, budget * band]``) with an absolute floor on the
    high side so a tiny budget doesn't page on one noisy outlier.
    """

    def __init__(self, *, alpha: float = 0.2, band_factor: float = 4.0,
                 min_count: int = 64, abs_floor: float = 0.02) -> None:
        self.alpha = float(alpha)
        self.band_factor = float(band_factor)
        self.min_count = int(min_count)
        self.abs_floor = float(abs_floor)
        self._ewma: Optional[float] = None
        self._seen = 0
        self._budget: Optional[float] = None

    def set_budget(self, frac: float) -> None:
        self._budget = float(frac)

    def observe(self, n: int, n_outliers: int) -> None:
        if n <= 0:
            return
        frac = n_outliers / n
        if self._ewma is None:
            self._ewma = frac
        else:
            self._ewma = self.alpha * frac + (1.0 - self.alpha) * self._ewma
        self._seen += n

    def evaluate(self, labels: Tuple[Tuple[str, str], ...]) -> List[Alert]:
        if (self._budget is None or self._ewma is None
                or self._seen < self.min_count):
            return []
        hi = max(self._budget * self.band_factor, self.abs_floor)
        lo = self._budget / self.band_factor
        if self._ewma > hi:
            return [Alert(
                "outlier_rate_high", "warn",
                f"observed outlier rate {self._ewma:.4f} exceeds band "
                f"[{lo:.4f}, {hi:.4f}] around budget {self._budget:.4f} "
                f"(z/n): stream has drifted from the trained model",
                self._ewma, hi, labels)]
        if self._budget > 0.0 and self._ewma < lo:
            return [Alert(
                "outlier_rate_low", "info",
                f"observed outlier rate {self._ewma:.4f} is below band "
                f"[{lo:.4f}, {hi:.4f}] around budget {self._budget:.4f} "
                f"(z/n): threshold may be too loose for current traffic",
                self._ewma, lo, labels)]
        return []


class StalenessMonitor:
    """Model age vs a freshness SLO."""

    def __init__(self, *, slo_s: float = 600.0) -> None:
        self.slo_s = float(slo_s)
        self._age_fn: Optional[Callable[[], Optional[float]]] = None

    def set_source(self, fn: Callable[[], Optional[float]]) -> None:
        self._age_fn = fn

    def evaluate(self, labels: Tuple[Tuple[str, str], ...]) -> List[Alert]:
        if self._age_fn is None:
            return []
        try:
            age = self._age_fn()
        except Exception:
            return []
        if age is None or age <= self.slo_s:
            return []
        return [Alert(
            "model_staleness", "warn",
            f"model installed {age:.1f}s ago exceeds freshness SLO "
            f"{self.slo_s:.1f}s; scores may not reflect current data",
            float(age), self.slo_s, labels)]


class ShedRateMonitor:
    """EWMA shed fraction of admission decisions vs a burn threshold.

    Each admission outcome (admit=0, shed=1) nudges the EWMA; a batch of
    ``a`` admits followed by ``s`` sheds is applied in closed form so
    the scheduler's hot path pays O(1) per call.
    """

    def __init__(self, *, alpha: float = 0.05, burn_max: float = 0.1,
                 min_events: int = 32) -> None:
        self.alpha = float(alpha)
        self.burn_max = float(burn_max)
        self.min_events = int(min_events)
        self._ewma = 0.0
        self._events = 0

    def observe(self, admitted: int, shed: int) -> None:
        if admitted <= 0 and shed <= 0:
            return
        keep = 1.0 - self.alpha
        if admitted > 0:
            self._ewma *= keep ** admitted
        if shed > 0:
            decay = keep ** shed
            self._ewma = self._ewma * decay + (1.0 - decay)
        self._events += admitted + shed

    def evaluate(self, labels: Tuple[Tuple[str, str], ...]) -> List[Alert]:
        if self._events < self.min_events or self._ewma <= self.burn_max:
            return []
        return [Alert(
            "shed_burn", "warn",
            f"admission shed rate EWMA {self._ewma:.4f} exceeds burn "
            f"threshold {self.burn_max:.4f}: sustained overload, add "
            f"capacity or tighten quotas",
            self._ewma, self.burn_max, labels)]


class MonitorHub:
    """Per-registry collection of monitors, one per (kind, topology).

    Thread-safe; every mutator is called from hot paths (drain, the
    scheduler's admission loop), every reader from ``snapshot()``.
    """

    def __init__(self, *, outlier_alpha: float = 0.2,
                 outlier_band: float = 4.0,
                 outlier_min_count: int = 64,
                 staleness_slo_s: float = 600.0,
                 shed_burn_max: float = 0.1,
                 shed_alpha: float = 0.05,
                 shed_min_events: int = 32) -> None:
        self._lock = threading.Lock()
        self._outlier_alpha = outlier_alpha
        self._outlier_band = outlier_band
        self._outlier_min_count = outlier_min_count
        self._staleness_slo_s = staleness_slo_s
        self._outlier: Dict[str, OutlierRateMonitor] = {}
        self._staleness: Dict[str, StalenessMonitor] = {}
        self._shed = ShedRateMonitor(alpha=shed_alpha,
                                     burn_max=shed_burn_max,
                                     min_events=shed_min_events)

    def _outlier_for(self, topology: str) -> OutlierRateMonitor:
        mon = self._outlier.get(topology)
        if mon is None:
            mon = self._outlier.setdefault(
                topology,
                OutlierRateMonitor(alpha=self._outlier_alpha,
                                   band_factor=self._outlier_band,
                                   min_count=self._outlier_min_count))
        return mon

    def set_outlier_budget(self, topology: str, frac: float) -> None:
        with self._lock:
            self._outlier_for(topology).set_budget(frac)

    def observe_scores(self, topology: str, n: int, n_outliers: int) -> None:
        with self._lock:
            self._outlier_for(topology).observe(n, n_outliers)

    def set_staleness_source(self, topology: str,
                             fn: Callable[[], Optional[float]]) -> None:
        with self._lock:
            mon = self._staleness.get(topology)
            if mon is None:
                mon = self._staleness.setdefault(
                    topology, StalenessMonitor(slo_s=self._staleness_slo_s))
            mon.set_source(fn)

    def observe_admission(self, admitted: int, shed: int) -> None:
        with self._lock:
            self._shed.observe(admitted, shed)

    def evaluate(self) -> List[Alert]:
        with self._lock:
            alerts: List[Alert] = []
            for topo in sorted(self._outlier):
                alerts.extend(self._outlier[topo].evaluate(
                    (("topology", topo),)))
            for topo in sorted(self._staleness):
                alerts.extend(self._staleness[topo].evaluate(
                    (("topology", topo),)))
            alerts.extend(self._shed.evaluate(()))
        return alerts

    def snapshot_alerts(self) -> List[Dict[str, Any]]:
        """The ``alerts`` section of ``snapshot()`` schema v2."""
        return [a.to_dict() for a in self.evaluate()]
