"""Prometheus text-format rendering of a metrics snapshot (stdlib-only).

Port of ``repro.obs.prom`` (the reference's text).

Renders the ONE plain dict produced by
:meth:`repro_torch.obs.MetricsRegistry.snapshot` as Prometheus exposition text
(text/plain; version=0.0.4), so a scrape endpoint — or just
``python -m repro_torch stats --format prom`` piped to a file — feeds the same
numbers every other consumer sees.  No client library: the format is a
few lines of string assembly, and the container must not grow deps.

Mapping:

* counters   -> ``<name>_total{labels} value`` (TYPE counter)
* gauges     -> ``<name>{labels} value`` (TYPE gauge; unset/None skipped)
* histograms -> ``<name>_bucket{le="..."}`` cumulative series plus
  ``_sum``/``_count`` (TYPE histogram); the exact p50/p95/p99 ride along
  as ``<name>_quantile{quantile="0.5"}`` gauges since Prometheus
  histograms cannot carry precomputed quantiles.

Metric names are sanitized to ``[a-zA-Z_][a-zA-Z0-9_]*`` (dots become
underscores: ``phase.refresh.fit`` -> ``phase_refresh_fit``).
"""
from __future__ import annotations

import re

from repro_torch.obs.registry import split_key

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    s = _NAME_OK.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_escape(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Snapshot dict -> Prometheus exposition text (one trailing newline)."""
    lines: list[str] = []
    typed: set[str] = set()

    def head(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, value in snapshot.get("counters", {}).items():
        raw, labels = split_key(key)
        name = _prom_name(raw) + "_total"
        head(name, "counter")
        lines.append(f"{name}{_prom_labels(labels)} {_fmt(value)}")

    for key, value in snapshot.get("gauges", {}).items():
        if value is None:
            continue
        raw, labels = split_key(key)
        name = _prom_name(raw)
        head(name, "gauge")
        lines.append(f"{name}{_prom_labels(labels)} {_fmt(value)}")

    for key, h in snapshot.get("histograms", {}).items():
        raw, labels = split_key(key)
        name = _prom_name(raw)
        head(name, "histogram")
        for le, cum in h.get("buckets", {}).items():
            lines.append(
                f"{name}_bucket{_prom_labels(labels, {'le': le})} {cum}")
        lines.append(f"{name}_sum{_prom_labels(labels)} {_fmt(h.get('sum'))}")
        lines.append(
            f"{name}_count{_prom_labels(labels)} {h.get('count', 0)}")
        for q, field in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            v = h.get(field)
            if v is not None:
                qname = name + "_quantile"
                head(qname, "gauge")
                lines.append(
                    f"{qname}{_prom_labels(labels, {'quantile': q})} "
                    f"{_fmt(v)}")
    return "\n".join(lines) + "\n"
