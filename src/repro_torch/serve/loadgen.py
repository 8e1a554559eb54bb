"""Open-loop multi-client load generator for the serving scheduler.

Port of ``repro.serve.loadgen`` (the reference's text; it imports no JAX).

Drives N client threads against one :class:`ServingScheduler` at a target
*offered* load (rows/s) and reports what actually happened: goodput
(completed rows/s), shed rate, and client-observed latency percentiles.
Open-loop pacing is the point — each client submits on a wall-clock
schedule whether or not earlier requests finished, so offered load can
exceed capacity and the report shows how admission control spends the
excess (shed rate up, p99 bounded) instead of the closed-loop illusion
where offered load silently collapses to capacity.

Used by ``python -m repro_torch serve --clients N`` and by
``chip_smoke.py``'s serving phase (the goodput-vs-offered-load ladder).
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.scheduler import ServingScheduler


def estimate_capacity(scheduler: ServingScheduler, queries: np.ndarray, *,
                      duration_s: float = 0.5, burst: int = 256,
                      seed: int = 0) -> float:
    """Closed-loop throughput estimate (rows/s): one client submits a
    burst, waits for it, repeats.  An upper-bound anchor for placing the
    open-loop ladder's rungs."""
    rng = np.random.default_rng(seed)
    done = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration_s:
        rows = queries[rng.integers(0, len(queries), size=burst)]
        for t in scheduler.submit(rows):
            t.result(timeout=60.0)
        done += burst
    return done / (time.perf_counter() - t0)


def run_load(scheduler: ServingScheduler, queries: np.ndarray, *,
             offered_rps: float, clients: int = 4, duration_s: float = 2.0,
             tenants: Optional[Sequence[str]] = None,
             seed: int = 0) -> dict:
    """Offer ``offered_rps`` rows/s from ``clients`` threads for
    ``duration_s``; returns one plain JSON-able report dict.

    ``tenants`` maps client i to ``tenants[i % len(tenants)]`` (default:
    every client is the ``"default"`` tenant).  The report's
    ``per_tenant`` section breaks submitted/completed/shed down by tenant
    — the fairness check reads it.
    """
    per_client = offered_rps / clients
    # target ~250 submit calls/s/client so pacing stays sleep-limited,
    # with small bursts so the queue sees a steady arrival process
    burst = max(1, int(round(per_client / 250)))
    interval = burst / per_client
    all_tickets: list[list] = [[] for _ in range(clients)]
    start = time.perf_counter()
    end = start + duration_s

    def client(ci: int) -> None:
        rng = np.random.default_rng(seed + 1000 + ci)
        tenant = tenants[ci % len(tenants)] if tenants else "default"
        next_t = time.perf_counter()
        mine = all_tickets[ci]
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            mine.extend(scheduler.submit(
                queries[rng.integers(0, len(queries), size=burst)],
                tenant=tenant))
            next_t += interval
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    scheduler.flush(timeout=120.0)
    wall_s = time.perf_counter() - start

    lat: list[float] = []
    per_tenant: dict[str, dict] = {}
    completed = shed = 0
    for mine in all_tickets:
        for t in mine:
            entry = per_tenant.setdefault(
                t.tenant, {"submitted": 0, "completed": 0, "shed": 0})
            entry["submitted"] += 1
            if t.shed:
                shed += 1
                entry["shed"] += 1
            else:
                t.result(timeout=60.0)   # re-raises worker errors
                completed += 1
                entry["completed"] += 1
                lat.append(t.latency_s)
    submitted = completed + shed
    arr = np.asarray(lat, np.float64)
    return {
        "offered_rps": round(float(offered_rps), 1),
        "clients": clients,
        "duration_s": round(duration_s, 3),
        "wall_s": round(wall_s, 3),
        "submitted": submitted,
        "completed": completed,
        "shed": shed,
        "goodput_rps": round(completed / wall_s, 1),
        "shed_rate": round(shed / submitted, 4) if submitted else 0.0,
        "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3)
        if arr.size else None,
        "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3)
        if arr.size else None,
        "per_tenant": per_tenant,
    }
