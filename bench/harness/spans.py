"""What the per-layer readers of the program's own spans and counters
share (``bench/metrics/draw_ms.py``, ``draw_rows_per_fit.py``,
``seeding_ms.py``).

While ``torch.profiler`` records the window (``trace.DeviceTrace``), the
port records each fit's span tree in its flight recorder
(``repro_torch.obs``: a trace of its own a fit, rooted at ``oneshot.fit``,
stamped on the profiler's clock) and counts its draws (``sampler.draws``,
``sampler.rows``); before the window, and untraced, it records and counts
nothing.  A reader reads this process's recorder and registry, so in a
cell on several cards it reads rank 0.  A program that has no such span or
counter reads None.
"""
from __future__ import annotations

from collections import defaultdict

FIT = "oneshot.fit"


def fits() -> list:
    """One list of span records a fit of the window: every trace of the
    flight recorder whose root is a ``oneshot.fit`` span, where the ring
    kept the whole tree (a fit that started before the oldest record the
    ring still holds may have lost spans)."""
    from repro_torch import obs
    rec = obs.get_default_recorder()
    records = rec.records()
    oldest = (min(r["t1"] for r in records)
              if records and rec.snapshot_section()["dropped"] else None)
    by_trace = defaultdict(list)
    for r in records:
        if r["kind"] == "span":
            by_trace[r["trace_id"]].append(r)
    out = []
    for spans in by_trace.values():
        roots = [r for r in spans
                 if r["name"] == FIT and r["parent_id"] is None]
        if len(roots) == 1 and (oldest is None or roots[0]["t0"] >= oldest):
            out.append(spans)
    return out


def span_ms(name: str):
    """Mean host milliseconds a fit spends inside spans named ``name``
    (their own bounds, on the program's clock; spans of one name do not
    nest)."""
    got = fits()
    if not got:
        return None
    total = sum(r["t1"] - r["t0"] for spans in got for r in spans
                if r["name"] == name)
    return 1e3 * total / len(got)


def counter_per_fit(run, name: str):
    """The program's counter ``name``, summed over its labels, over the
    window's fits: it counts only while the profiler records, so all of
    it is the window's."""
    from repro_torch import obs
    counters = obs.get_default_registry().snapshot()["counters"]
    vals = [v for key, v in counters.items()
            if obs.split_key(key)[0] == name]
    if not vals or not run.answers:
        return None
    return sum(vals) / len(run.answers)
