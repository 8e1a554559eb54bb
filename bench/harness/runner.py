"""One run of one cell: set-up, the measured window of fits, the trace,
the judgement, and the result line.

A cell on one chip runs in this process.  A cell on c chips runs c ranks
of one NCCL group: this process is rank 0, and it spawns ranks 1..c-1,
each on its own card; rank 0 decides when the window ends and tells the
others before every fit, and alone judges and prints.  Every rank hands
rank 0 a digest of each of its answers and the JAX modules it holds once
the window has closed: an answer that differs from rank 0's breaks the
guarantee that every rank returns the same result.
"""
from __future__ import annotations

import contextlib
import hashlib
import multiprocessing
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch

from bench.harness import program
from bench.harness.data import make_data
from bench.harness.spec import ROOT, Cell, load_metric
from bench.harness.trace import DeviceTrace, TraceSummary
from bench.harness.traffic import window
from bench.harness.work import DEFAULT_PEAKS, PEAKS
from bench.reference import judge

GROUP_TIMEOUT = timedelta(seconds=120)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# One host thread a process: the sites' host work, the CPU draws above
# all, runs on one core, as one process a site would.  With torch's
# default of a thread a core, susy.fit's fit_s spread 27% between runs on
# one H100 machine and kdd.fit's 5-9%; with one, 11% and 3%.
HOST_THREADS = 1
# What an answer's digest covers: all that distributed_cluster returns
# identical on every rank.
DIGEST_KEYS = ("summary_ids", "summary_weights", "centers", "outlier_ids",
               "cost")


class ForbiddenModules(RuntimeError):
    """A rank held a module of the JAX side once the window had closed."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def digest(ans: dict) -> str:
    """A digest of the answer's DIGEST_KEYS, as numpy on the host."""
    h = hashlib.sha256()
    for key in DIGEST_KEYS:
        h.update(np.ascontiguousarray(ans[key]).tobytes())
    return h.hexdigest()


@dataclass
class RunData:
    """What a metric's reader (``bench/metrics/<name>.py``) reads."""
    cell: Cell
    answers: list            # every fit of the window, in order
    window_s: float          # host clock, first fit's start to last's end
    setup_s: float           # host clock, process start to the window
    trace: TraceSummary      # rank 0's device trace (None untraced)
    peaks: dict              # work.PEAKS of the card


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device, cfg: dict) -> float:
    """Seconds to make the kernels of the configuration's fit ready.  Where
    the checkout's build directory lacks a library of its entry's
    ``LIBRARIES``, one process per library builds it, all at once (the
    program builds a library at its first use, one at a time); then the
    entry's ``warm(device, d)`` calls each op the fit launches on a row at
    the cell's width, which loads them.  An entry that declares neither
    leaves both to its warm fits."""
    from repro_torch.kernels import _build
    entry = program.entry(cfg)
    t0 = time.perf_counter()
    if device.type == "cuda":
        code = ("import sys; sys.path.insert(0, %r); from repro_torch."
                "kernels import _build; _build.load(sys.argv[1])"
                % str(ROOT / "src"))
        builds = [subprocess.Popen([sys.executable, "-c", code, name])
                  for name in getattr(entry, "LIBRARIES", ())
                  if not _build.library_path(name).exists()]
        if any(p.wait() for p in builds):
            raise RuntimeError("building the fit's CUDA kernels failed")
    if hasattr(entry, "warm"):
        entry.warm(device, int(cfg["d"]))
    sync(device)
    return time.perf_counter() - t0


def run_rank(rank: int, world: int, device, cell: Cell, seed: int,
             seconds: float, trace: bool, t_start: float = None):
    """Set-up, window and trace on this rank; returns rank 0's report
    (None on the others).  ``t_start``: the host clock's reading at the
    process's start (None: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    torch.set_num_threads(HOST_THREADS)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    x, truth = make_data(cfg, seed, device)
    sync(device)
    fit = program.make_fit(cfg, x, device)
    for j in range(int(traffic["warm_fits"])):
        fit(program.fit_seed(seed, -1 - j))
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if world > 1:
        dist.barrier()
    setup_s = time.perf_counter() - t_start
    tracer = DeviceTrace(device) if trace else None
    with tracer or contextlib.nullcontext():
        answers, window_s = window(fit, traffic, seed, seconds, world,
                                   device)
    sync(device)
    answers = [program.to_host(a) for a in answers]
    mine = {"memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0),
            "forbidden": forbidden_modules(),
            "digests": [digest(a) for a in answers] if world > 1 else []}
    summary = tracer.summary() if tracer else None
    if summary:
        mine.update(busy_s=summary.busy_s, window_s=summary.window_s)
    stats = [mine]
    if world > 1:
        stats = [None] * world
        dist.all_gather_object(stats, mine)
    del fit
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank:
        return None
    return {"x": x, "truth": truth, "answers": answers, "window_s": window_s,
            "setup_s": setup_s, "stats": stats, "trace": summary}


def rank_devices(kind: str, world: int) -> list:
    """One device a rank: its own card, or the CPU for every rank (a
    rehearsal on gloo)."""
    return [f"cuda:{r}" if kind == "cuda" else "cpu" for r in range(world)]


def _rank_main(rank: int, world: int, kind: str, rdzv: str, rank_setup,
               target, args) -> None:
    from repro_torch.core.collective import init_sites
    t_start = time.perf_counter()
    if rank_setup:
        rank_setup[0](*rank_setup[1:])
    devices = rank_devices(kind, world)
    init_sites(rank, devices, init_method=rdzv, timeout=GROUP_TIMEOUT)
    import torch.distributed as dist
    try:
        target(rank, world, devices[rank], *args, t_start=t_start)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def ranks(world: int, kind: str, target, args=(), rank_setup=None):
    """This process as rank 0 of ``world`` ranks of one group, one device
    a rank (``rank_devices``); yields rank 0's device.  Ranks 1.. are
    spawned, call ``rank_setup`` (a picklable ``(fn, *args)``; a test
    plants a fault with it), meet through a file under the temporary
    directory, and run ``target(rank, world, device, *args,
    t_start=...)``, which rank 0 runs in the ``with`` block.  On leaving,
    the ranks meet again, the group is ended, every spawned process has
    ended, and a rank that failed raises."""
    devices = rank_devices(kind, world)
    if world == 1:
        yield devices[0]
        return
    import torch.distributed as dist
    from repro_torch.core.collective import init_sites
    procs, rdzv_dir = [], tempfile.mkdtemp(prefix="bench-rdzv-")
    try:
        rdzv = f"file://{rdzv_dir}/group"
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=_rank_main, args=(
                r, world, kind, rdzv, rank_setup, target, args))
            p.start()
            procs.append(p)
        init_sites(0, devices, init_method=rdzv, timeout=GROUP_TIMEOUT)
        try:
            yield devices[0]
            dist.barrier()
        finally:
            dist.destroy_process_group()
        for p in procs:
            p.join(timeout=120)
        failed = [p.exitcode for p in procs if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank processes ended with codes {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rdzv_dir, ignore_errors=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, limits: dict = None, rank_setup=None):
    """The run's result (the last line's object) and the lines that go to
    standard error, as ``(result, stderr_lines)``.  Raises
    ``ForbiddenModules`` where a rank held a module of the JAX side once
    the window had closed."""
    device = torch.device(device)
    build_s = build_kernels(device, cell.config)
    args = (cell, seed, seconds, trace)
    with ranks(cell.chips, device.type, run_rank, args, rank_setup) as dev:
        rep = run_rank(0, cell.chips, dev, *args, t_start=t_start)
    return report(cell, seed, trace, device, cell.chips, rep, build_s,
                  limits)


def checked_fits(seed: int, n_fits: int, check_fits: int) -> list:
    """The window's fits that are judged, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in rng.choice(
        n_fits, size=min(check_fits, n_fits), replace=False))


def diverged(stats: list) -> int:
    """Fits on which some rank's answer differs from rank 0's (every rank
    runs as many fits: rank 0 tells them when the window ends)."""
    return sum(len(set(d)) > 1 for d in zip(*(s["digests"] for s in stats)))


def report(cell: Cell, seed: int, trace: bool, device, world: int, rep: dict,
           build_s: float, limits: dict = None):
    bad = sorted({m for s in rep["stats"] for m in s["forbidden"]})
    if bad:
        raise ForbiddenModules(f"modules of the JAX side are loaded: {bad}")
    answers, n_fits = rep["answers"], len(rep["answers"])
    limits = limits or judge.load_limits(cell.config_name)
    pick = checked_fits(seed, n_fits, int(cell.traffic["check_fits"]))
    checked = [answers[i] for i in pick]
    correct, numbers, failed = judge.judge(rep["x"], checked, cell.config,
                                           limits)
    differ = diverged(rep["stats"])
    if differ:      # "every rank returns the same result", broken
        numbers["broken"] += differ
        correct, failed = False, failed + differ
    quality = judge.quality(checked, rep["truth"])
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": world,
           "memory_peak_bytes": max(s["memory_peak_bytes"]
                                    for s in rep["stats"])}
    if trace:
        dev["busy_s"] = float(np.mean([s["busy_s"] for s in rep["stats"]]))
        dev["window_s"] = rep["trace"].window_s
    run = RunData(cell, answers, rep["window_s"], rep["setup_s"],
                  rep["trace"], PEAKS.get(kind, DEFAULT_PEAKS))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_metric(m["name"]).read(run)
        if v is not None:       # a reader that finds nothing reads nothing
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": n_fits, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": rep["trace"].device_ops,
                            "idle_gaps": rep["trace"].idle_gaps}
    out["build_s"] = build_s
    out["fit_wall_s"] = [a["wall_s"] for a in answers]
    out["checked_fits"] = pick
    out["ranks_differ"] = differ
    out["quality"] = quality
    out["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                    for k in judge.NUMBERS}
    lines = []
    if trace:
        calls = rep["trace"].calls
        lines.append(f"trace op calls {len(calls)}, linked to kernels "
                     f"{sum(c.kernels > 0 for c in calls)}, busy_s "
                     f"{rep['trace'].busy_s}, window_s "
                     f"{rep['trace'].window_s}")
    lines += [f"quality {k} {v}" for k, v in quality.items()]
    lines += [f"check {k} {numbers[k]} <= {limits[k]}"
              for k in judge.NUMBERS]
    return out, lines
