"""The one generator of traffic.  A mix is a data file of parameters,
``bench/traffic/<mix>.json``, and this function runs the measured window
of any mix over the cell's fit; a new mix is a new file.

Parameters of a mix:

``loop``
    ``"closed"``: one user refitting; each fit starts when the one before
    it ends, and the window ends after the last fit that started within
    the run's seconds.  ``"open"``: fits fall due at ``rate_per_s``
    (exponential gaps drawn from the run's seed) and one server takes
    them in turn, each when it is due or when the one before it ends; the
    window ends after the last fit that fell due within the run's seconds.
``rate_per_s``
    Open loop only: fits falling due a second.
``warm_fits``
    Fits of the set-up, before the window (their sampler seeds are not
    the window's).
``check_fits``
    Fits of the window judged against the reference, drawn from the seed.

Every answer gets ``due_s`` (seconds from the window's start to when it
fell due), ``wall_s`` (its own run) and ``latency_s`` (from due to done).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.harness import program

LOOPS = ("closed", "open")


def due_times(traffic: dict, seed: int, seconds: float):
    """Seconds from the window's start at which fit i falls due (None for
    a closed loop, where a fit falls due when the one before it ends)."""
    loop = traffic["loop"]
    if loop not in LOOPS:
        raise ValueError(f"traffic {traffic.get('name')!r}: loop {loop!r} "
                         f"is not one of {LOOPS}")
    if loop == "closed":
        return None
    rate = float(traffic["rate_per_s"])
    rng = np.random.default_rng([int(seed), 0x7AFF1C])
    dues, t = [], rng.exponential(1.0 / rate)
    while t < seconds:
        dues.append(t)
        t += rng.exponential(1.0 / rate)
    return dues


def window(fit, traffic: dict, seed: int, seconds: float, world: int,
           device):
    """The mix's fits over ``fit``: ``(answers, window_s)``.  Rank 0's clock
    decides when each fit starts and when the window ends, for every rank
    of ``world``."""
    dues = due_times(traffic, seed, seconds)
    answers = []
    flag = torch.zeros((1,), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    while True:
        i = len(answers)
        if dues is None:
            go = time.perf_counter() - t0 < seconds
        else:
            go = i < len(dues)
            if go:
                time.sleep(max(0.0, t0 + dues[i] - time.perf_counter()))
        if world > 1:
            import torch.distributed as dist
            flag.fill_(int(go))
            dist.broadcast(flag, src=0)
            go = bool(flag.item())
        if not go:
            break
        t1 = time.perf_counter()
        ans = fit(program.fit_seed(seed, i))
        t2 = time.perf_counter()
        due = t1 - t0 if dues is None else dues[i]
        ans.update(due_s=due, wall_s=t2 - t1, latency_s=t2 - t0 - due)
        answers.append(ans)
    return answers, time.perf_counter() - t0
