"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]
    python3 chip_smoke.py --measure serve,lloyd_split,lloyd_ladder,stream
    python3 chip_smoke.py --measure train
    python3 chip_smoke.py --measure lm
    python3 chip_smoke.py --measure lm_mutations
    python3 chip_smoke.py --measure robust
    python3 chip_smoke.py --measure mesh
    python3 chip_smoke.py --measure pdist_split,pdist_plans,route_ladder
    python3 chip_smoke.py --measure wide_ladder

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port (``src/repro_torch``) and nothing of JAX, and:

1. builds the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together) and prints the build time;
2. holds every kernel, for every metric and input type it serves, against
   its plain torch version on the card: the main path's shapes plus edge
   cases (ragged n and m, d = 130, k = 2048, duplicate centers, 1e30 rows,
   bf16); min_argmin's large-m (tiled) route also on both sides of its
   threshold, with m off its tile, ties across tiles and threads, 1e30 rows,
   bf16 and l1, each bit for bit against the rowscan route and the fused
   score kernel, and at the kdd reassignment shape and gauss's site calls;
   its small-m (rowscan) route at its edges (n = 1, 31, 33 and one row past
   a bulk call's tile, m = 1, 3 and one below the tiled threshold, d = 1,
   5, 8, 32, 34 and 64, every metric, f32 and bf16, x off 16-byte
   alignment, many tiles a CTA, 1e30 center rows, all-+inf rows) against
   its plain version and bit for bit the tiled route and the score's
   (dist, idx), and d = 65 and 300 against the plain version (d = 300
   also on the small-m route's generic width, which only a named route
   reaches); its chunked route (past d = 64) at the curate.fit cell's
   shapes on unit rows of d = 768: an Algorithm 1 round (62,500 x 200) and
   an Algorithm 2 reassignment (62,500 x 10,801, 5,100 slots invalid at
   1e30);
   the fused score at the edges of its CTA split (n = 1 to 33,793 at
   k x d = 3 x 34, 100 x 5, 2,048 x 130 and 64 x 64, every metric, f32
   and bf16, 1e30 center rows, tied centers), each bit for bit min_argmin
   plus the divide, and two calls whose results must not share storage;
   the fused Lloyd step's assignment and dist bit for bit min_argmin's and
   its sums and counts equal across two calls, at the second levels'
   shapes, the edges of its CTA split (n = 1, 257, a ragged last CTA),
   k = 1, d = 130 and 300, k = 2,048, a warp of 32 centers, the curate.fit
   cell's second level (366,000 unit rows x 100 x 768, the chunked route),
   and on every route whose blocks fit (at d = 300 the serial route's
   generic width and the chunked route);
   the WKV6 kernel also against the step oracle in float64, at the rwkv6
   prefill's shape and at edge cases (c = 64, c = T = 7, one chunk, B = 1,
   BH = 1 and 3, strong decays, non-zero u in both layouts and s0), its
   first pass against that pass's plain version, plus one gradient check
   of its autograd Function;
3. drives the main paths through the user's entry points, each with every
   launch counter at 0 just before it and read just after: one-shot
   Algorithm 3 with Algorithm 2 site summaries (``simulate_coordinator``,
   as the paper's benchmarks run it) on the kddFull-like data at the paper's
   size (4,898,431 x 34, k = 3, t = 45,540, 20 sites) and on gauss-0.1 at
   the paper's size (1M x 5, k = 100, t = 5,000), the serving model
   (``_model_from_result``) and >= 200 micro-batches of 256 queries through
   ``_score_batch``; then rwkv6-7b at full width (32 layers, d = 4096, bf16,
   random weights from a seed) serving batch 4: a prefill of 4096-token
   prompts (``make_prefill_step``, WKV on the kernel: 32 launches) and 32
   greedy decode steps (``make_serve_step``: no WKV launch); and the
   paper's Table 3 head-to-head on the kddFull-like data at the budget of
   the kdd fit's summary (its records / 20 per site): ``paper``,
   ``ball_cover``, ``coreset`` and ``uniform`` through
   ``_run_oneshot(summarizer=...)``, ``rand`` and ``k-means||`` per site,
   each followed by the same k-means-- (min_argmin at the baselines'
   assignment shape, a site against that many of its rows, is first held
   against its plain version); it checks the paper's invariants (per site
   mass, ids, candidates and rounds in the head-to-head too, and there the
   paper's preRec above uniform's and rand's) and fails unless every kernel
   was launched (min_argmin and lloyd_step in every head-to-head row);
   and the streaming service (the "stream" phase): the reference's
   long-stream deployment (``benchmarks/stream_bench.py::store_section`` at
   1M rows: gauss 20 x 50,000, d = 5, t = 10,000, leaf 2,048, a refresh
   every n/4 rows, a window of n/2, batches of 8,192) through
   ``StreamService`` once all-resident and once under
   ``StoreSpec(hot_levels=1)``; it checks the two packed roots bit for bit,
   spills and page-ins, mass against the window's rows and the record cap,
   an incremental refresh's skip, an async refresh against the blocking
   one bit for bit, 400 micro-batches through submit/drain (224 window rows
   + 32 planted), a save and restore that scores and then ingests and
   refits bit for bit as the saved service does; then the same settings on
   an integer-grid stream (200,000 rows, t = 2,000, where the merges run
   Algorithm 1's rounds) on the kernels and on the plain path, whose roots
   and centers must be equal bit for bit; min_argmin, lloyd_step and score
   must each launch in the phase;
   and the front door (the "session" phase): ``Session(pipeline_config(
   ...)).fit`` on the kddFull-like rows (the config's summarizer is the
   registry's ``auto``, the weighted Algorithm 1, as in the reference's
   Session; the kdd phase above runs Algorithm 2 as the paper's benchmark
   does), bit for bit the same config's ``_run_oneshot`` +
   ``_model_from_result`` driven directly, with both fits' seconds; 400
   micro-batches of 256 through ``Session.score``; ``save`` and
   ``Session.load`` (all 4,898,431 x 34 rows) scoring the same queries bit
   for bit; the 1M stream deployment through ``Session`` (batches of 8,192),
   its model and one drain bit for bit the stream phase's resident
   service; ``KernelPolicy(autotune=True)``, which under ``auto`` resolves
   every op to ``cuda`` with its default tiles, measures and writes nothing
   and returns the untuned results bit for bit, and under
   ``backend="blocked"`` measures each op's candidate tiles at the kdd
   serving and stream refit shapes into a cache a second resolution hits;
   then ``python -m repro_torch run|serve --config examples/...`` on the
   three example artifacts, each in its own process, each ending in
   ``ok``; min_argmin, lloyd_step and score must each launch in each
   Session run;
   and the one round of communication (the "sharded" phase), its ranks
   spawned processes of this script (gloo ranks share the one card: NCCL
   refuses two ranks on a device, so the gathers go through host memory):
   (a) ``distributed_cluster`` and ``Session(pipeline_config(...,
   use_shard_map=True)).fit`` in each of 20 ranks on the kddFull-like rows
   cut to 4,898,420 = 20 x 244,921 (an ``.npy`` each rank memory-maps,
   reading its own block), every rank's result equal, rank 0's bit for bit
   the same computation composed in this process with no group, the
   Session bit for bit the direct call, the paper's invariants, its
   quality beside the kdd fit's, min_argmin and lloyd_step launched in
   every rank; (b) one NCCL rank on gauss-0.1, bit for bit its
   composition; (c) the 1M stream deployment through
   ``ShardedStreamService`` on 4 host-simulated sites at the paper's site
   budget, all-resident and tiered (roots per site bit for bit, mass per
   site against its window, refresh accounting = ``payload_bytes`` x s,
   400 micro-batches, a save and restore that scores, ingests and refits
   bit for bit) and through ``Session(topology="sharded")``, its model and
   a drain bit for bit the service's; (d) the 200k grid stream on 4 gloo
   ranks with ``use_shard_map=True``, each rank's refresh on the
   collective path and its model and drain bit for bit the host-simulated
   service's, score launched in each rank's drain;
   and the serving scheduler under concurrent clients (the "serving"
   phase, the card's counterpart of ``benchmarks/serving_bench.py --mode
   full``): ``Session(pipeline_config(..., topology="stream",
   serving=ServingSpec(queue_bound=512, batch_window_ms=1.0)))`` fitted on
   the stream phase's 1M rows; 1,024 of 4,096 query rows
   (``default_rng(7)``) through ``score_stream`` from 16 client threads at
   once, bit for bit ``Session.score``, the worker thread's ``score``
   launches counted, and one tick's rows against the kernel and its plain
   version; clients scoring while the session ingests and an async
   refresh fits; ``estimate_capacity``, an open-loop probe, then a ladder
   of 0.25 / 0.5 / 1 / 2 / 4 x the sustained rate (16 clients, 2 s a
   rung: offered and completed rows/s, p50 / p99 ms, shed rate, batch
   occupancy, peak queue depth) with the metrics plane and the flight
   recorder on, then both off; a two-tenant rung under a quota;
   ``Session.stats()`` through ``benchmarks/check_obs_snapshot.py
   --require-set serving`` and ``dump_trace`` through
   ``benchmarks/check_trace.py``; ``python -m repro_torch stats`` and
   ``serve --clients 4 --offered-rps 1000000 --metrics-interval 0
   --metrics-out F --trace-out F``, their files through the same validators;
   and rwkv6 training (the "train" phase, once the serving model is
   released): (a) rwkv6-7b at full width (bf16, WKV on the kernel, remat
   "nothing", the default AdamW) cut to 8 layers, 1 warm-up and 6 timed
   steps of 4 x 1024 tokens from ``TokenPipeline`` through
   ``make_train_step``, each bracketed by a sync and split by CUDA events
   (forward, backward and the WKV's step-oracle backward in it,
   ``adamw.apply``), with tokens/s and peak memory; finite metrics, the
   optimizer's step, changed parameters and 2 x 8 WKV launches a step are
   checked; (b) at full width, 2 layers, f32, 2 x 256 tokens from one model
   and batch: the kernel WKV route against the plain chunked route (loss
   within 1e-4, every gradient leaf within 5e-3 of its largest
   magnitude), remat none / nothing / dots against each other and inner
   remat on the plain route, with their WKV launches; (c) in bf16 with f32
   moments at a narrow width (d = 512, 8 heads of 64): (params, opt_state)
   saved after step 3 and restored into a fresh model and state, step 4
   bit for bit the uninterrupted one; (d) ``python -m
   repro_torch.launch.train --smoke --steps 6 --ckpt-every 3`` and again
   with ``--steps 8``, which must resume from step 5; (e) the 8-layer
   model's mean-pooled last hidden states of 40 batches of 16 x 256 tokens,
   10% of the rows uniform noise, through ``DataCurator`` over 4 sites
   (min_argmin and lloyd_step, held against their plain versions at these
   d = 4096 shapes first, must launch in ``detect``): the noise rows'
   precision and recall reported beside chance, and the same reservoirs
   through Algorithm 3 on the kernels and on the plain backend, which must
   flag the same ids up to near-tie flips;
   and the dense and moe families (the "lm" phase, plain torch: no kernel
   of the port lies on their path, and each part's launches are read), each
   part after the previous part's model is released: (a) llava-next-
   mistral-7b FULL (32 layers, d = 4,096, bf16, random weights) serving 4
   prompts of 2,880 patch embeddings + 1,216 tokens (a warm-up and 3 timed
   prefills, their median in tokens/s) and 32 greedy decode steps; (b)
   qwen3-moe-235b-a22b at its published widths cut from 94 layers to 4, 4
   x 2,048-token prompts and 32 decode steps, with the MoE drop fraction at
   prefill and decode; (c) h2o-danube-1.8b FULL on one 8,191-token prompt,
   which wraps its 4,096-slot ring, and 32 decode steps; each checks its
   caches against ``init_cache`` and decode against teacher forcing
   (prefill(S) + decode(token S) against prefill(S + 1), one side on
   chunked attention and the other unchunked) in bf16 and in f32 from the
   same weights upcast, at full depth (the moe at capacity 16, its f32 run
   on 2 layers), and (a) holds the attention's score product against a
   float64 oracle at trained-model score scales;
   (d) h2o-danube-1.8b FULL training, 1 warm-up and 3 steps of 2 x 4,096
   tokens through ``make_train_step``, s per step, tokens/s and peak
   memory; the rglru_hybrid and encdec families, in the same phase: (e)
   recurrentgemma-9b FULL (38 layers: 12 groups of 2 RG-LRU layers + 1
   local-attention layer, and a 2-layer tail) on 4 x 4,096-token prompts,
   which wrap its 2,048-slot ring, and 32 decode steps, its scan against
   the stepwise recurrence at full width and its teacher forcing in f32 at
   full depth from the weights upcast in place; (f) seamless-m4t-medium
   FULL (12 + 12 layers) on 4 requests of 1,024 audio frames and 4,096
   decoder tokens, its cross-attention cache bit for bit the projection of
   the encoder's output; (g) recurrentgemma-9b training at its published
   widths cut to 5 layers, 1 + 3 steps of 4 x 1,024 tokens;
   and the "robust" phase: (a) int8 and bf16 gradient compression with
   error feedback on (g)'s model's gradient at one recurrent layer's
   leaves over 50 steps; (b) ``robust_mean_grads`` on 4 gloo ranks sharing
   the card, each holding a full-width recurrent layer's gradient tree
   (~201 M f32), one of them the base x 1,000: the corrupted rank is
   flagged, every rank's mean is bit for bit the same and within the
   honest spread of the honest mean, and ``lloyd_step`` and ``min_argmin``
   launch in every rank; (c) the elastic runner on the reference test's
   scenario over 8 logical replicas of the card, and over
   ``make_train_step`` of recurrentgemma at d = 512, restarted after a
   failure bit for bit against the uninterrupted run;
   and the "mesh" phase: (a) ``launch/cluster_dryrun.py`` at the
   production pod's size (256 sites x 65,536 x 32 f32 on the card, k =
   100, t = 131,072, plain summaries) under the step counter, its record
   and outliers checked, then ``min_argmin`` at a site's Alg. 1 round and
   ``lloyd_step`` at the second level against their plain versions; (b)
   ``python -m repro_torch.launch.cluster_job --sites 4`` on gloo ranks
   sharing the card, its four lines; (c) the dry run of the reference
   test's cells (danube train_4k single, decode_32k multi, qwen2.5-32b and
   rwkv6-7b long_500k) on fake tensors over fake groups of 256 / 512
   ranks, each in its own process; (d) a sharded train step, prefill and
   decode step of danube SMOKE (f32) on a (1, 1) NCCL ``DeviceMesh`` on the
   card against ``mesh=None`` within 1e-5;
4. re-runs gauss with ``backend="blocked"`` (the plain torch path) from the
   same seed, and on the kernels from another seed as the yardstick of two
   independent draws, and compares the results; re-runs the rwkv6 prefill
   on the plain chunked WKV and compares logits, state and decoded tokens,
   and checks prefill(S) + decode(token S) against prefill(S + 1);
5. times each kernel at the main path's shapes beside its plain version,
   a PyTorch yardstick and its roofline bound (min_argmin's calls of both
   fits and the baselines' assignment on both of its routes, its small-m
   calls, the stream's and cluster_dryrun's among them, also beside the
   instruction floor and split into device us per launch, host us per call
   and a host breakdown; WKV also its
   first pass alone, and at B = 1; the three clustering kernels at the
   stream's shapes), both min_argmin routes over a ladder of m at d = 5, 16, 34 and
   64 (the routing threshold), the serving score at 256 x 3 x 34 and
   256 x 100 x 5 split into device time per launch (a CUDA graph), host
   time per call and a host breakdown, the Lloyd step at both second
   levels split the same way and beside its assignment alone, and the
   rwkv6 prefill's tokens/s and decode step latency; the WKV kernel at the
   train cell's call shape and the backward pass through the step oracle
   there.

``--measure`` runs only the named readings, each after the fits that feed
it, and prints them as one JSON line: ``serve`` (the serving p50 and p99),
``lloyd_split`` and ``lloyd_ladder`` (the Lloyd routes over k and over caps
of CTAs), ``stream`` (the 1M stream's ingest rows/s resident and tiered,
and its submit + drain p50 and p99), ``train`` (the train phase and the
WKV's timings at its call shape, alone, after the build), ``lm`` (the lm
phase alone, no build), ``lm_mutations`` (a check of the lm checks: (a)'s
and (c)'s checks at 4 layers clean and under three mutations
monkeypatched for a run each, bf16 scores, a ring slot off by one and a
dropped window mask, each of which must fail them), ``robust`` (the
robust phase alone, after the build), ``mesh`` (the mesh phase alone,
after the build), ``pdist_split`` (min_argmin's small-m edge checks, then
its small-m calls' timings and time split, after only the data),
``pdist_plans`` (the small-m route's launch plan against other rows per
tile, buffers and grids there), ``route_ladder`` (both min_argmin
routes over m) and ``wide_ladder`` (the small-m and chunked routes over m
past d = 64, and the chunked route at the curation cell's reassignment).
One process per reading, in turns with another tree's, compares two trees;
``serve`` and ``stream`` run on any tree of the port from the stream slice on.

It prints the card (``nvidia-smi``), one ``{"kernels": [...]}`` line and, as
its last line, ``{"ok": true, "device": {...}}``.  Any failed phase raises:
the script then exits non-zero and prints no result.  Without a CUDA card
it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth.  The kernels use neither TF32 nor bf16
# tensor cores, so fp32 CUDA-core FLOP/s is the compute roof.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

KDD = dict(n=4_898_431, d=34, k=3, sites=20, second_iters=25, seed=0)
GAUSS = dict(n_centers=100, per_center=10_000, d=5, sigma=0.1, t=5_000,
             k=100, sites=20, second_iters=25, seed=0)
MICRO_BATCH = 256
SERVE_BATCHES = 400
# rwkv6-7b serving at full width; batch and prompt cut from the reference's
# prefill_32k shape (batch 32 x 32,768 on a pod) to fit one card's time
RWKV = dict(arch="rwkv6-7b", smoke=False, batch=4, prompt=4096, gen=32,
            compare_tokens=8, seed=0)
# the WKV call of that prefill: BH = batch * heads rows
WKV_MAIN = dict(BH=256, T=4096, K=64, chunk=16)

KERNELS = {
    "min_argmin": ("src/repro_torch/kernels/csrc/pdist.cu",
                   "src/repro/kernels/pdist/kernel.py:96"),
    "lloyd_step": ("src/repro_torch/kernels/csrc/lloyd.cu",
                   "src/repro/kernels/lloyd/kernel.py:77"),
    "score": ("src/repro_torch/kernels/csrc/score.cu",
              "src/repro/kernels/score/kernel.py:115"),
    "wkv_forward": ("src/repro_torch/kernels/csrc/wkv.cu",
                    "src/repro/kernels/wkv/kernel.py:82"),
}


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------- timing
def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events after a warm-up
    (by the host clock off the card, for rehearsals only)."""
    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound_ms(nbytes: float, flops: float):
    """Least time for the work: bytes over HBM rate vs FLOPs over fp32 rate."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def pdist_work(n, m, d, metric, in_bytes=4, extra_out=0):
    nbytes = in_bytes * (n + m) * d + (8 + extra_out) * n
    flops = (3 * n * m * d + n * m) if metric == "l1" else \
        (2 * n * m * d + 4 * n * m + 2 * (n + m) * d)
    return nbytes, flops


def lloyd_work(n, k, d):
    nbytes = 4 * (n * d + n + k * d) + 4 * (k * d + k) + 8 * n
    flops = 2 * n * k * d + 4 * n * k + 2 * n * (d + 1)
    return nbytes, flops


# ------------------------------------------------------- kernel checks
# Tolerances.  Both sides compute in f32 (bf16 inputs are upcast first), but
# the kernel sums each dot product sequentially and the plain version in
# cuBLAS's order, and l2sq is the reference's expansion x2 + c2 - 2 x.c,
# which loses bits to cancellation for near points.  So an error is scaled
# by the magnitude the expansion works at: x2 + c2 for l2sq (the squared
# distances for l2), |x|_1 + |c|_1 for l1.  TOL = 1e-5 of that is ~80 f32
# ulps; a sum of d <= 300 products in another order stays far inside it.
# The reports call this scaled error max_rel_err.  Above d = 300 (the
# curator's d = 4,096) a sum of d products in another order is exact to
# within d * 2^-24 of the expansion's magnitude, and that bound replaces TOL.
TOL = 1e-5


def tol_for(d):
    """The scaled tolerance of a distance over d coordinates."""
    return TOL if d <= 300 else d * 2.0 ** -24


def _scale(x, c, metric):
    """Per-row magnitude of the expansion, in float64, clamped at 1."""
    x, c = x.double(), c.double()
    if metric == "l1":
        s = x.abs().sum(-1) + c.abs().sum(-1)
    else:
        s = (x * x).sum(-1) + (c * c).sum(-1)
    return s.clamp(min=1.0)


def _d64(x, c, metric):
    """Row-wise squared-or-l1 distance of x[i] to c[i] in float64."""
    x, c = x.double(), c.double()
    if metric == "l1":
        return (x - c).abs().sum(-1)
    return ((x - c) ** 2).sum(-1)


def dist_err(x, c, dk, dp, ap, metric):
    """Max scaled error of the kernel's distances against the plain ones.
    l2 is compared squared (the sqrt of a rounding error near 0 is not a
    rounding error of the distance)."""
    if metric == "l2":
        dk, dp = dk.double() ** 2, dp.double() ** 2
    err = (dk.double() - dp.double()).abs()
    same = dk.double() == dp.double()          # e.g. both +inf
    err = torch.where(same, 0.0, err)
    scaled = err / _scale(x, c[ap.long()], metric)
    scaled = torch.where(torch.isfinite(dp), scaled,
                         torch.where(same, 0.0, float("inf")))
    return float(scaled.max())


def argmin_verdict(x, c, a_k, a_p, metric):
    """(mismatches, bad): rows whose argmins differ, and those of them that
    are not near-ties.  A mismatch is allowed only where the two chosen
    centers are within ``tol_for(d)`` (scaled as above) of each other in
    float64,
    and never on an exact tie (both must then pick the smaller index)."""
    diff = (a_k != a_p).nonzero().flatten()
    if diff.numel() == 0:
        return 0, 0
    xs = x[diff]
    ck, cp = c[a_k[diff].long()], c[a_p[diff].long()]
    gap = (_d64(xs, ck, metric) - _d64(xs, cp, metric)).abs()
    bad = (gap > tol_for(x.shape[1]) * _scale(xs, cp, metric)) | \
        ((gap == 0) & (a_k[diff] > a_p[diff]))
    return int(diff.numel()), int(bad.sum())


def _rec(kernel, name, metric, x, c, **kw):
    return dict(kernel=kernel, case=name, metric=metric,
                dtype=str(x.dtype).replace("torch.", ""),
                shape=[x.shape[0], c.shape[0], x.shape[1]],
                tol=tol_for(x.shape[1]), **kw)


def check_pdist(dev, name, x, c, metric, fail, route=None):
    """min_argmin (on ``route``, or routed) against its plain version."""
    from repro_torch.kernels.pdist import kernel as pk
    from repro_torch.kernels.pdist.ops import min_argmin_blocked
    if route is None:
        dk, ak = pk.min_argmin_cuda(x, c, metric=metric)
    else:
        dk, ak = pk._launch_route(route, x, c, metric=metric)
        name = f"{name}_{route}"
    dp, ap = min_argmin_blocked(x, c, metric=metric)
    sync(dev)
    fin = torch.isfinite(dp)
    err = torch.where(fin, (dk - dp).abs(), 0.0)
    scaled = dist_err(x, c, dk, dp, ap, metric)
    mis, bad = argmin_verdict(x, c, ak, ap, metric)
    rec = _rec("min_argmin", name, metric, x, c,
               max_abs_err=float(err.max()), max_rel_err=scaled,
               argmin_mismatch=mis, argmin_bad=bad)
    if bad or not scaled <= rec["tol"]:
        fail.append(rec)
    return rec


def check_score(dev, name, x, c, thr, metric, fail):
    from repro_torch.kernels.pdist.kernel import min_argmin_cuda
    from repro_torch.kernels.score.kernel import score_cuda
    from repro_torch.kernels.score.ops import score_blocked
    dk, ak, sk = score_cuda(x, c, thr, metric=metric)
    da, aa = min_argmin_cuda(x, c, metric=metric)
    composed = da / torch.clamp(thr, min=1e-30)
    dp, ap, sp = score_blocked(x, c, thr, metric=metric)
    sync(dev)
    bitwise = bool(torch.equal(dk, da) and torch.equal(ak, aa)
                   and torch.equal(sk, composed))
    scaled = dist_err(x, c, dk, dp, ap, metric)
    mis, bad = argmin_verdict(x, c, ak, ap, metric)
    rec = _rec("score", name, metric, x, c,
               max_abs_err=float((sk - sp).abs().max()),
               max_rel_err=scaled, argmin_mismatch=mis, argmin_bad=bad,
               fused_equals_composed_bitwise=bitwise)
    if bad or not bitwise or not scaled <= rec["tol"]:
        fail.append(rec)
    return rec


def check_lloyd(dev, name, x, w, c, metric, fail, route=None):
    """The Lloyd step (on ``route``, or routed) against its plain version,
    its assignment and distances against ``min_argmin_cuda`` bit for bit
    (both scan with RowScan's arithmetic), and its sums and counts across
    two calls bit for bit (no float atomics) and against the one-hot
    matmul."""
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.lloyd import kernel as lk
    from repro_torch.kernels.lloyd.ops import (accumulate_by_assignment,
                                               lloyd_step_blocked)
    from repro_torch.kernels.pdist.kernel import min_argmin_cuda
    if route is None:
        step = lambda: lk.lloyd_step_cuda(x, w, c, metric=metric)  # noqa
    else:
        step = lambda: lk._launch_route(route, x, w, c, metric=metric)  # noqa
        name = f"{name}_{route}"
    s1, c1, a1, d1 = step()
    s2, c2, _, _ = step()
    sp, cp, ap, dp = lloyd_step_blocked(
        x, w, c, metric=metric, policy=KernelPolicy(backend="blocked"))
    dm, am = min_argmin_cuda(x, c, metric=metric)
    sync(dev)
    deterministic = bool(torch.equal(s1, s2) and torch.equal(c1, c2))
    as_min_argmin = bool(torch.equal(a1, am) and torch.equal(d1, dm))
    mis, bad = argmin_verdict(x, c, a1, ap, metric)
    scaled = dist_err(x, c, d1, dp, ap, metric)
    # sums are compared on the kernel's own assignment, so a permitted
    # near-tie flip is not a sum error; the scale is the sum of magnitudes
    # (a sum of signed terms may cancel to ~0).  1e-4: the kernel adds up to
    # n / 256 rows in order per block, the plain matmul in cuBLAS's order.
    s_ref, c_ref = accumulate_by_assignment(x, w, a1, c.shape[0])
    s_abs, c_abs = accumulate_by_assignment(x.abs(), w.abs(), a1, c.shape[0])
    serr = float(((s1 - s_ref).abs() / s_abs.clamp(min=1e-6)).max())
    cerr = float(((c1 - c_ref).abs() / c_abs.clamp(min=1e-6)).max())
    rec = _rec("lloyd_step", name, metric, x, c,
               max_abs_err=max(float((d1 - dp).abs().max()),
                               float((s1 - s_ref).abs().max()),
                               float((c1 - c_ref).abs().max())),
               max_rel_err=scaled, sums_rel_err=serr,
               counts_rel_err=cerr, argmin_mismatch=mis, argmin_bad=bad,
               deterministic=deterministic,
               bitwise_min_argmin=as_min_argmin)
    if (bad or not deterministic or not as_min_argmin
            or not scaled <= rec["tol"]
            or not serr <= 1e-4 or not cerr <= 1e-4):
        fail.append(rec)
    return rec


def path_shapes(n, k, t, sites):
    """The main path's distance-call shapes for one data set, from the
    reference's static plan: per-site rows, Alg. 1's sample size m, Alg. 2's
    center capacity, and a bound on the records the coordinator gathers."""
    from repro_torch.core.distributed import local_budget
    from repro_torch.core.summary import _plan
    n_site = -(-n // sites)
    t_i = local_budget(t, sites, "random")
    _, m, rounds, _ = _plan(n_site, k, t_i, 2.0, 0.45)
    center_cap = rounds * m + 8 * t_i + 1
    return dict(n_site=n_site, t_i=t_i, m=m, rounds=rounds,
                center_cap=center_cap,
                n_rec=sites * (center_cap + 8 * t_i + 1))


def route_bitwise(dev, name, x, c, metric, fail):
    """min_argmin's two CUDA routes on the same inputs: distances and
    indices must be equal bit for bit (pdist.cu: same per-pair arithmetic,
    same tie rule)."""
    from repro_torch.kernels.pdist.kernel import _launch_route
    dt_, it_ = _launch_route("tiled", x, c, metric=metric)
    dr, ir = _launch_route("rowscan", x, c, metric=metric)
    sync(dev)
    same = bool(torch.equal(dt_, dr) and torch.equal(it_, ir))
    fin = torch.isfinite(dr)
    rec = _rec("min_argmin", f"{name}_tiled_vs_rowscan", metric, x, c,
               max_abs_err=float(torch.where(fin, (dt_ - dr).abs(),
                                             0.0).max()),
               max_rel_err=0.0, routes_bitwise_equal=same,
               index_mismatches=int((it_ != ir).sum()))
    if not same:
        fail.append(rec)
    return rec


def large_m_checks(dev, rnd, site, c_re, fail):
    """The large-m (tiled) route of min_argmin: both sides of the routing
    threshold, m not a multiple of the 64-center tile, ties spread across
    column tiles and threads, 1e30 rows inside the route, bf16 and l1, each
    against the plain version, against the rowscan route bit for bit, and
    against the fused score kernel (which keeps RowScan) bit for bit; then
    the fused-vs-composed check at the kdd reassignment shape."""
    from repro_torch.kernels.pdist.kernel import (min_argmin_cuda, route,
                                                  tiled_min_m)
    recs = []
    d = KDD["d"]
    thr = torch.tensor(0.7, device=dev)
    least = tiled_min_m(d)
    cases = (("below_threshold", 3001, least - 1, d),
             ("at_threshold", 3001, least, d),
             ("m1000_ragged_tile", 5000, 1000, d),
             ("m4096", 5000, 4096, d),
             ("m300_d5", 4099, 300, 5),
             ("m777_d64", 2000, 777, 64))
    for name, n, m, dd in cases:
        want = "tiled" if m >= tiled_min_m(dd) else "rowscan"
        if route(n, m, dd) != want:
            fail.append(dict(kernel="min_argmin", case=name,
                             why=f"route {route(n, m, dd)} != {want}"))
        for metric in ("l2sq", "l2", "l1"):
            for dt in (torch.float32, torch.bfloat16):
                x, c = rnd(n, dd).to(dt), rnd(m, dd).to(dt)
                recs.append(check_pdist(dev, name, x, c, metric, fail))
                recs.append(check_score(dev, name, x, c, thr, metric, fail))
                recs.append(route_bitwise(dev, name, x, c, metric, fail))
    # ties across tiles and threads: row 5's two exact copies sit at
    # j = 17 and j = 4095 of 4096 centers (answer 17); an all-equal set of
    # 4096 (answer 0 for every row)
    for metric in ("l2sq", "l2", "l1"):
        for dt in (torch.float32, torch.bfloat16):
            x = rnd(257, d).to(dt)
            c = (rnd(4096, d) * 10).to(dt)
            c[17] = x[5]
            c[4095] = x[5]
            rec = check_pdist(dev, "tie_j17_j4095", x, c, metric, fail)
            _, a = min_argmin_cuda(x, c, metric=metric)
            if int(a[5]) != 17:
                fail.append(dict(rec, why=f"tie picked {int(a[5])}, not 17"))
            recs.append(rec)
            recs.append(route_bitwise(dev, "tie_j17_j4095", x, c, metric,
                                      fail))
            ones = torch.ones((4096, d), device=dev, dtype=dt)
            rec = check_pdist(dev, "all_equal_4096", x, ones, metric, fail)
            _, a = min_argmin_cuda(x, ones, metric=metric)
            if not bool((a == 0).all()):
                fail.append(dict(rec, why="all-equal set did not pick 0"))
            recs.append(rec)
    # Alg. 2's invalid slots inside the large-m route
    for metric in ("l2sq", "l2"):
        x = rnd(3000, d)
        c = torch.cat([rnd(600, d), torch.full((100, d), 1e30, device=dev)])
        c = c[torch.randperm(700).to(dev)].contiguous()
        rec = check_pdist(dev, "m700_far_rows", x, c, metric, fail)
        _, a = min_argmin_cuda(x, c, metric=metric)
        if not bool((c[a.long(), 0] < 1e29).all()):
            fail.append(dict(rec, why="a 1e30 row won"))
        recs.append(rec)
        recs.append(route_bitwise(dev, "m700_far_rows", x, c, metric, fail))
    # the fused score (RowScan) against the tiled route at the reassignment
    # shape, bit for bit
    recs.append(check_score(dev, "kdd_alg2_reassign", site, c_re,
                            torch.tensor(3.5, device=dev), "l2sq", fail))
    recs.append(route_bitwise(dev, "kdd_alg2_reassign", site, c_re, "l2sq",
                              fail))
    return recs


SCORE_EDGE_N = (1, 31, 32, 33, 255, 256, 257, 4_224, 4_225, 33_793)
# (k, d): kdd's and gauss's serving widths, a wide one past d = 128 (128-row
# CTAs), and d = 64 (f32 rows in 16-byte pieces: the cp.async staging)
SCORE_EDGE_KD = ((3, 34), (100, 5), (2_048, 130), (64, 64))


def score_edge_checks(dev, rnd, fail):
    """The fused score at the edges of its CTA split (launch_plan: 32-row
    CTAs up to n = 4,224 = 132 x 32, then 64, ..., 256), each against
    min_argmin_cuda plus the divide bit for bit and against the plain
    version; then 1e30 center rows, tied centers, and two calls whose
    results must not share storage."""
    from repro_torch.kernels.score.kernel import score_cuda
    recs = []
    thr = torch.tensor(0.7, device=dev)
    for k, d in SCORE_EDGE_KD:
        c32 = rnd(k, d)
        x32 = rnd(max(SCORE_EDGE_N), d)
        for dt in (torch.float32, torch.bfloat16):
            c = c32.to(dt)
            for n in SCORE_EDGE_N:
                x = x32[:n].to(dt).contiguous()
                for metric in ("l2sq", "l2", "l1"):
                    recs.append(check_score(dev, f"edge_n{n}", x, c, thr,
                                            metric, fail))
    x = rnd(4_225, 34)
    for metric in ("l2sq", "l2"):
        c = torch.cat([rnd(60, 34), torch.full((40, 34), 1e30, device=dev)])
        c = c[torch.randperm(100).to(dev)].contiguous()
        rec = check_score(dev, "edge_far_rows", x, c, thr, metric, fail)
        _, a, _ = score_cuda(x, c, thr, metric=metric)
        if not bool((c[a.long(), 0] < 1e29).all()):
            fail.append(dict(rec, why="a 1e30 row won"))
        recs.append(rec)
    # ties: center 99 copies center 0, and rows 0..31 are center 0 itself
    c = rnd(100, 34)
    c[99] = c[0]
    xt = torch.cat([c[:1].expand(32, 34), rnd(225, 34)]).contiguous()
    for metric in ("l2sq", "l2", "l1"):
        rec = check_score(dev, "edge_tied_centers", xt, c, thr, metric, fail)
        _, a, _ = score_cuda(xt, c, thr, metric=metric)
        if not bool((a[:32] == 0).all()):
            fail.append(dict(rec, why="a tie did not pick index 0"))
        recs.append(rec)
    # aliasing: the second call's results get storage of their own
    first = score_cuda(x[:256].contiguous(), c, thr)
    kept = [t.clone() for t in first]
    second = score_cuda(x[256:512].contiguous(), c, thr)
    sync(dev)
    same = all(torch.equal(a, b) for a, b in zip(first, kept))
    apart = first[0].untyped_storage().data_ptr() != \
        second[0].untyped_storage().data_ptr()
    rec = dict(kernel="score", case="aliasing_two_calls",
               first_unchanged=same, distinct_storage=apart,
               max_abs_err=0.0, max_rel_err=0.0)
    if not (same and apart):
        fail.append(rec)
    recs.append(rec)
    return recs


SMALL_M_D = (1, 5, 8, 32, 34, 64)
# rows of a persistent CTA's several tiles: kdd's and gauss's widths
SMALL_M_BULK = ((300_000, 34), (300_000, 5), (300_000, 32))


def _small_m_bitwise(dev, name, x, c, metric, fail):
    """The small-m route against its plain version, the tiled route and
    ``score``'s (dist, idx), the last two bit for bit."""
    thr = torch.tensor(0.7, device=dev)
    return [check_pdist(dev, name, x, c, metric, fail),
            route_bitwise(dev, name, x, c, metric, fail),
            check_score(dev, name, x, c, thr, metric, fail)]


def small_m_checks(dev, rnd, fail):
    """min_argmin's small-m route (``launch_plan``'s persistent CTAs) at its
    edges: n = 1, 31, 33 and one row past a bulk call's tile, m = 1, 3 and
    ``tiled_min_m(d) - 1``, d = 1, 5, 8, 32, 34 and 64, every metric, f32
    (bf16 at n = 33 and past the tile), each against its plain version and,
    bit for bit, the tiled route and ``score``'s (dist, idx); then x one
    word off 16-byte alignment (the bulk copy's ragged head and tail), many
    tiles per CTA, 1e30 center rows, rows whose every distance is +inf
    (index 0), the plan's residency against the occupancy calculator's, and
    d = 65 and 300 against the plain version."""
    from repro_torch.kernels.pdist import kernel as pk
    from repro_torch.kernels.pdist.kernel import (launch_plan,
                                                  min_argmin_cuda,
                                                  padded_width, tiled_min_m)
    recs = []
    for d in SMALL_M_D:
        for m in sorted({1, 3, tiled_min_m(d) - 1}):
            c32 = rnd(m, d)
            past = launch_plan(10**6, m, d).rows + 1
            for n in (1, 31, 33, past):
                x32 = rnd(n, d)
                for dt in ((torch.float32, torch.bfloat16) if n in (33, past)
                           else (torch.float32,)):
                    x, c = x32.to(dt), c32.to(dt)
                    for metric in ("l2sq", "l2", "l1"):
                        recs += _small_m_bitwise(
                            dev, f"small_m_n{n}_m{m}_d{d}", x, c, metric,
                            fail)
    # x at a 4-byte offset from 16-byte alignment (d = 32: rows by block,
    # not by row), so every tile's block has ragged ends, in calls of one
    # tile a CTA and of many (one and two row buffers: the main path's site
    # rounds are slices of the data at such offsets), and n, d such that
    # the last tile's bytes are ragged
    for n, d, m in ((5_001, 5, None), (4_099, 32, None), (3_001, 34, None),
                    (300_000, 34, 26), (300_000, 5, 3), (300_000, 32, 200)):
        flat = rnd(n * d + 1)
        x = flat[1:].view(n, d)
        c = rnd(m or tiled_min_m(d) - 1, d)
        for metric in ("l2sq", "l1"):
            recs += _small_m_bitwise(dev, f"small_m_offset_n{n}_d{d}_m{m}",
                                     x, c, metric, fail)
    # several tiles per CTA (the row buffers' phases), f32 and bf16
    for n, d in SMALL_M_BULK:
        x, c = rnd(n, d), rnd(tiled_min_m(d) - 1, d)
        for dt in (torch.float32, torch.bfloat16):
            recs += _small_m_bitwise(dev, f"small_m_bulk_n{n}_d{d}",
                                     x.to(dt), c.to(dt), "l2sq", fail)
    # 1e30 center rows never win; a row whose every distance is +inf keeps
    # index 0 (l2: x = 1e30, so x2 overflows; l1: x = +inf, |x - c| = inf)
    for d in (5, 34):
        m = tiled_min_m(d) - 1
        far = torch.cat([rnd(m - m // 3, d),
                         torch.full((m // 3, d), 1e30, device=dev)])
        far = far[torch.randperm(m).to(dev)].contiguous()
        c = rnd(m, d)
        for metric in ("l2sq", "l2", "l1"):
            x = rnd(2_000, d)
            recs_f = _small_m_bitwise(dev, f"small_m_far_rows_d{d}", x, far,
                                      metric, fail)
            _, a = min_argmin_cuda(x, far, metric=metric)
            if metric != "l1" and not bool((far[a.long(), 0] < 1e29).all()):
                fail.append(dict(recs_f[0], why="a 1e30 row won"))
            x[7] = float("inf") if metric == "l1" else 1e30
            recs_i = _small_m_bitwise(dev, f"small_m_inf_row_d{d}", x, c,
                                      metric, fail)
            dk, a = min_argmin_cuda(x, c, metric=metric)
            if int(a[7]) != 0 or not bool(torch.isinf(dk[7])):
                fail.append(dict(recs_i[0], why=f"all-inf row: idx "
                                 f"{int(a[7])}, dist {float(dk[7])}"))
            recs += recs_f + recs_i
    # the plan's residency (kernel.py: REGISTERS) is what the occupancy
    # calculator gives, or less: a persistent grid never waits for a wave
    for n, m, d in ((1_048_576, 20, 5), (50_000, 200, 5), (244_922, 26, 34),
                    (4_898_431, 3, 34), (65_536, 200, 32), (10**6, 3, 16),
                    (10**6, 100, 24), (10**6, 3, 48), (10**6, 63, 64),
                    (10**6, 3, 130), (10**6, 3, 256)):
        plan = launch_plan(n, m, d)
        planned = pk._resident(plan.rows, plan.smem_bytes, padded_width(d))
        real = _blocks_per_sm("pdist_rows", d, plan.rows, plan.smem_bytes)
        rec = dict(kernel="min_argmin", case=f"resident_n{n}_m{m}_d{d}",
                   planned=planned, occupancy=real, max_abs_err=0.0,
                   max_rel_err=0.0)
        if real < planned:
            fail.append(rec)
        recs.append(rec)
    # widths past the tiled route: d = 65 (padded to 96) and the generic 300
    for n, m, d in ((1_000, 3, 65), (1_000, 200, 65), (517, 65, 300)):
        x, c = rnd(n, d), rnd(m, d)
        for metric in ("l2sq", "l2", "l1"):
            recs.append(check_pdist(dev, f"small_m_d{d}_m{m}", x, c, metric,
                                    fail))
    return recs


def kernel_checks(dev, kdd_x, gauss_x, ks, gs):
    """Every kernel x metric x dtype against its plain version on the card
    (tolerances: see TOL)."""
    from repro_torch.kernels.pdist.kernel import min_argmin_cuda
    g = torch.Generator(device="cpu").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)   # noqa: E731
    recs, fail = [], []
    site = kdd_x[:ks["n_site"]]
    gsite = gauss_x[:gs["n_site"]]
    cap = ks["center_cap"]
    pick = torch.randperm(ks["n_site"], generator=g)[:cap].to(dev)
    gpick = torch.randperm(gs["n_site"],
                           generator=g)[:gs["center_cap"]].to(dev)
    # Alg. 2's centers: data rows plus 40 invalid slots at 1e30, shuffled
    far = torch.full((40, KDD["d"]), 1e30, device=dev)
    c_re = torch.cat([site[pick[:cap - 40]], far])[
        torch.randperm(cap, generator=g).to(dev)].contiguous()
    # main-path shapes (kdd: Alg. 1 round, Alg. 2 reassignment, losses;
    # gauss: round and reassignment), with the metric the path runs
    cases = [
        ("kdd_alg1_round", site, site[pick[:ks["m"]]].contiguous(), "l2sq"),
        ("kdd_alg2_reassign_far_rows", site, c_re, "l2sq"),
        ("kdd_losses", kdd_x, site[pick[:KDD["k"]]].contiguous(), "l2"),
        ("gauss_alg1_round", gsite, gsite[gpick[:gs["m"]]].contiguous(),
         "l2sq"),
        ("gauss_alg2_reassign", gsite, gsite[gpick].contiguous(), "l2sq"),
    ]
    for name, x, c, metric in cases:
        recs.append(check_pdist(dev, name, x, c, metric, fail))
    # gauss-0.1's site calls (d = 5) on both routes, bit for bit
    for name, x, c, metric in cases[3:]:
        recs.append(route_bitwise(dev, name, x, c, metric, fail))
    # edge cases x every metric x dtype
    dup = torch.ones((133, 4), device=dev)
    for metric in ("l2sq", "l2", "l1"):
        for dt in (torch.float32, torch.bfloat16):
            for name, (n, m, d) in (("ragged", (1000, 37, 18)),
                                    ("d130", (1025, 200, 130)),
                                    ("m2048_d130", (3001, 2048, 130)),
                                    ("d300", (517, 65, 300))):
                x, c = rnd(n, d).to(dt), rnd(m, d).to(dt)
                recs.append(check_pdist(dev, name, x, c, metric, fail))
                if d > 256:     # the generic width, by its named route
                    recs.append(check_pdist(dev, name, x, c, metric, fail,
                                            "rowscan"))
                recs.append(check_score(dev, name, x[:300].contiguous(), c,
                                        torch.tensor(0.7, device=dev),
                                        metric, fail))
            x = torch.zeros((8, 4), device=dev, dtype=dt)
            rec = check_pdist(dev, "duplicate_centers", x, dup.to(dt),
                              metric, fail)
            _, a = min_argmin_cuda(x, dup.to(dt), metric=metric)
            if not bool((a == 0).all()):
                fail.append(dict(rec, why="tie did not pick index 0"))
            recs.append(rec)
        if metric != "l1":
            x = rnd(2000, 34)
            c = torch.cat([rnd(5, 34), torch.full((7, 34), 1e30, device=dev)])
            recs.append(check_pdist(dev, "far_rows", x, c, metric, fail))
    recs += large_m_checks(dev, rnd, site, c_re, fail)
    recs += small_m_checks(dev, rnd, fail)
    recs += curate_cell_checks(dev, g, fail)
    recs += score_edge_checks(dev, rnd, fail)
    # serving shape: a micro-batch against kdd's and gauss's centers
    thr = torch.tensor(3.5, device=dev)
    recs.append(check_score(dev, "serve_kdd", kdd_x[:MICRO_BATCH],
                            site[pick[:KDD["k"]]].contiguous(), thr, "l2sq",
                            fail))
    recs.append(check_score(dev, "serve_gauss", gauss_x[:MICRO_BATCH],
                            gsite[gpick[:GAUSS["k"]]].contiguous(), thr,
                            "l2sq", fail))
    recs += lloyd_edge_checks(dev, rnd, g, ks, gs, fail)
    return recs, fail


# The curate.fit cell's distance calls (bench/configs/curate-d768.json: a
# site of 62,500 of 2,000,000 unit rows at d = 768, t_i = 1,250): an
# Algorithm 1 round against m = 200 sampled rows; Algorithm 2's
# reassignment against its 10,801 planned slots, ~5,100 of them invalid
# (1e30); a second-level Lloyd step over ~366,000 records and k = 100.
CURATE_CELL = dict(n_site=62_500, m=200, slots=10_801, invalid=5_100,
                   n_rec=366_000, k=100, d=768)


def curate_cell_checks(dev, g, fail):
    """min_argmin's chunked route and the Lloyd step's, at CURATE_CELL's
    shapes on unit rows with centers drawn from the rows (weights whole,
    1 to 255, as a summary's), against their plain versions."""
    cc = CURATE_CELL
    d = cc["d"]
    unit = lambda n: torch.nn.functional.normalize(       # noqa: E731
        torch.randn((n, d), generator=g), dim=1).to(dev)
    x = unit(cc["n_site"])
    pick = torch.randperm(cc["n_site"], generator=g).to(dev)
    live = cc["slots"] - cc["invalid"]
    far = torch.full((cc["invalid"], d), 1e30, device=dev)
    slots = torch.cat([x[pick[:live]], far])[
        torch.randperm(cc["slots"], generator=g).to(dev)].contiguous()
    recs = [check_pdist(dev, "curate_alg1_round", x,
                        x[pick[:cc["m"]]].contiguous(), "l2sq", fail),
            check_pdist(dev, "curate_alg2_reassign", x, slots, "l2sq", fail)]
    del x, slots, far
    x = unit(cc["n_rec"])
    w = torch.randint(1, 256, (cc["n_rec"],), generator=g).float().to(dev)
    c = x[torch.randperm(cc["n_rec"], generator=g)[:cc["k"]].to(dev)]
    recs.append(check_lloyd(dev, "curate_second_level", x, w,
                            c.contiguous(), "l2sq", fail))
    return recs


def lloyd_edge_checks(dev, rnd, g, ks, gs, fail):
    """The Lloyd step at the second levels' shapes and at the edges of its
    launch plan (``lloyd_plan``): one row, NT + 1 rows, k = 1, a ragged
    last CTA, d = 130 on 128-row CTAs, the serial route (k = 2048 x
    d = 130, whose partials live in global memory), the chunked route
    (d = 300), and a warp whose 32 rows hold 32 different centers; both
    metrics, f32 and bf16 (bf16 up to 10,000 rows); then each route where
    its blocks fit, the serial route's generic width at d = 300 among
    them."""
    from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
    recs = []
    for name, (n, k, d) in (("kdd_second_level",
                             (ks["n_rec"], KDD["k"], KDD["d"])),
                            ("gauss_second_level",
                             (gs["n_rec"], GAUSS["k"], GAUSS["d"])),
                            ("n1", (1, 3, 34)),
                            ("n257", (257, 3, 34)),
                            ("k1", (1000, 1, 5)),
                            ("ragged", (1000, 37, 18)),
                            # 4,100 tiles, 16 a CTA (lloyd_plan), the last
                            # CTA's 1,000 rows ragged
                            ("ragged_last_cta", (1_049_576, 3, 34)),
                            ("d130", (1025, 3, 130)),
                            ("k2048_d130", (3001, 2048, 130)),
                            ("d300", (517, 65, 300))):
        for metric in ("l2sq", "l2"):
            for dt in (torch.float32, torch.bfloat16):
                if dt == torch.bfloat16 and n > 10_000:
                    continue
                x = rnd(n, d).to(dt)
                w = torch.rand(n, generator=g).to(dev) * 3
                c = rnd(k, d).to(dt)
                recs.append(check_lloyd(dev, name, x, w, c, metric, fail))
    # rows 0..31 and 32..63 next to 32 different centers each (k = 40)
    c = rnd(40, 34) * 3
    near = torch.cat([torch.randperm(40, generator=g)[:32],
                      torch.randperm(40, generator=g)[:32]]).to(dev)
    x = torch.cat([c[near] + 0.01 * rnd(64, 34), rnd(300, 34)]).contiguous()
    w = torch.rand(x.shape[0], generator=g).to(dev) * 3
    for metric in ("l2sq", "l2"):
        rec = check_lloyd(dev, "warp_32_centers", x, w, c, metric, fail)
        _, _, a, _ = lloyd_step_cuda(x, w, c, metric=metric)
        if not (bool((a[:64] == near).all())
                and len(set(a[:32].tolist())) == 32):
            fail.append(dict(rec, why="rows did not take 32 centers a warp"))
        recs.append(rec)
    # every route where its blocks fit, whichever the plan would pick: the
    # 32-center warps, the second levels' widths, d = 130
    from repro_torch.kernels.lloyd import kernel as lk
    for name, (xr, wr, cr) in (
            ("warp_32_centers", (x, w, c)),
            ("d34_k3", (x, w, c[:3].contiguous())),
            ("d5_k100", (rnd(5000, 5), torch.rand(5000, generator=g).to(dev),
                         rnd(100, 5))),
            ("d130_k3", (rnd(1025, 130), torch.rand(1025, generator=g)
                         .to(dev), rnd(3, 130))),
            ("d300_k65", (rnd(517, 300), torch.rand(517, generator=g)
                          .to(dev), rnd(65, 300)))):
        for route in lk.ROUTES:
            try:
                lk.lloyd_plan(xr.shape[0], cr.shape[0], xr.shape[1], route)
            except ValueError:
                continue
            for dt in (torch.float32, torch.bfloat16):
                recs.append(check_lloyd(dev, name, xr.to(dt), wr,
                                        cr.to(dt), "l2sq", fail, route))
    return recs


# ------------------------------------------------------- WKV6 kernel checks
# Tolerances.  The kernel and the plain chunked version do the same f32
# arithmetic in other orders, and compute the chunk's cumulative log-decays
# lin with different scans (a loop per column vs torch.cumsum).  An error is
# scaled by the output's magnitude, max(1, max |out|), and allowed
#   WKV_TOL + |lin|max * 2^-18
# where |lin|max is the largest cumulative log-decay inside a chunk: exp of
# a difference of two such sums carries their f32 ulp (|lin| * 2^-24) as a
# relative error, and 2^-18 leaves 64 of those for the sums over tau and i.
# WKV_TOL = 1e-4 is ~800 f32 ulps, for sums of up to c + K = 128 products in
# another order.  o in bf16 adds one bf16 rounding (2^-8) of the output: the
# two sides round f32 values that differ in the last bits.  Against the step
# oracle in float64 (same inputs, upcast) the chunked f32 evaluation is
# allowed WKV_TOL_F64 = 1e-3 (the reference's own atol for its kernel) plus
# the same decay term and bf16 rounding.
WKV_TOL = 1e-4
WKV_TOL_F64 = 1e-3


def wkv_work(BH, T, K, in_bytes, chunk):
    """(bytes, flops) of one WKV call: each input read once (r, k, v in
    their dtype, lw f32, u, s0), each output written once (o, sT); the
    operations the chunked evaluation needs for these shapes (only the
    tau < t exponents, an exp counted as one operation)."""
    c = min(chunk, T)
    nc = T // c
    nbytes = (3 * in_bytes + 4) * BH * T * K + 4 * BH * K \
        + 4 * 2 * BH * K * K + in_bytes * BH * T * K
    pairs = c * (c - 1) // 2
    per_chunk = (c * K                        # cumsum
                 + pairs * K * 5              # sub, exp, 2 mul, add
                 + c * K * 3                  # bonus
                 + 2 * c * K                  # r exp(lprev), k exp(..)
                 + 2 * (pairs + c) * K        # w_ts v over tau <= t
                 + 2 * c * K * K              # (r exp(lprev)) S
                 + K * K * (2 + 2 * c))       # S update
    return nbytes, BH * nc * per_chunk


def _lin_max(lw, chunk):
    BH, T, K = lw.shape
    c = min(chunk, T)
    return float(lw.reshape(BH, T // c, c, K).sum(2).abs().max())


def _scaled(a, b):
    """max |a - b| / max(1, max |b|), in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def wkv_inputs(dev, g, BH, T, K, dtype, *, per_row_u, decay):
    """r, k, v ~ N(0, 1) in ``dtype``; lw f32 from ``decay``: "strong" is
    -exp(U(-8, 4)) (tests/test_models.py's extreme decays), "init" is
    -exp(-1 + N(0, 0.5^2)) around the model's init (w0 = -1); u and s0
    non-zero N(0, 1), u as (K,) or per row (BH, K)."""
    r, k, v = (torch.randn(BH, T, K, generator=g).to(dev, dtype)
               for _ in range(3))
    if decay == "strong":
        lw = -torch.exp(torch.rand(BH, T, K, generator=g) * 12 - 8)
    else:
        lw = -torch.exp(torch.randn(BH, T, K, generator=g) * 0.5 - 1)
    u = torch.randn((BH, K) if per_row_u else (K,), generator=g)
    s0 = torch.randn(BH, K, K, generator=g)
    return r, k, v, lw.to(dev), u.to(dev), s0.to(dev)


def check_wkv(dev, name, args, chunk, fail, *, ref64=True):
    from repro_torch.kernels.wkv.kernel import (wkv_forward_cuda,
                                                wkv_forward_plain)
    from repro_torch.kernels.wkv.ref import wkv_ref
    r = args[0]
    ok, sk = wkv_forward_cuda(*args, chunk=chunk)
    op, sp = wkv_forward_plain(*args, chunk=chunk)
    sync(dev)
    cond = _lin_max(args[3], chunk) * 2.0 ** -18
    rnd = 2.0 ** -8 if r.dtype == torch.bfloat16 else 0.0
    tol_o, tol_s = WKV_TOL + cond + rnd, WKV_TOL + cond
    rec = dict(kernel="wkv_forward", case=name,
               dtype=str(r.dtype).replace("torch.", ""),
               shape=list(r.shape), chunk=min(chunk, r.shape[1]),
               u_layout="BHxK" if args[4].dim() == 2 else "K",
               lin_max=_lin_max(args[3], chunk),
               max_abs_err=float((ok.float() - op.float()).abs().max()),
               o_err=_scaled(ok, op), s_err=_scaled(sk, sp),
               tol_o=tol_o, tol_s=tol_s,
               finite=bool(torch.isfinite(ok.float()).all()
                           and torch.isfinite(sk).all()))
    bad = not (rec["finite"] and rec["o_err"] <= tol_o
               and rec["s_err"] <= tol_s)
    if ref64:
        o64, s64 = wkv_ref(*(a.double() for a in args))
        rec.update(o_err_f64=_scaled(ok, o64), s_err_f64=_scaled(sk, s64),
                   tol_f64_o=WKV_TOL_F64 + cond + rnd,
                   tol_f64_s=WKV_TOL_F64 + cond)
        bad = bad or not (rec["o_err_f64"] <= rec["tol_f64_o"]
                          and rec["s_err_f64"] <= rec["tol_f64_s"])
    rec["max_rel_err"] = max(rec["o_err"], rec["s_err"])
    if bad:
        fail.append(rec)
    return rec


def wkv_grad_check(dev, fail):
    """``wkv_forward`` (kernel forward, oracle recompute backward) against
    autograd through the plain oracle, every input, at a small shape;
    rtol/atol 1e-3 as the reference's custom-VJP test."""
    from repro_torch.kernels.wkv.ops import wkv_forward
    from repro_torch.kernels.wkv.ref import wkv_ref
    g = torch.Generator(device="cpu").manual_seed(5)
    args = wkv_inputs(dev, g, 8, 64, 64, torch.float32, per_row_u=False,
                      decay="init")
    grads = []
    for fn in (lambda *a: wkv_forward(*a, 16), wkv_ref):
        leaves = [a.clone().requires_grad_(True) for a in args]
        o, sT = fn(*leaves)
        ((o.float() ** 2).sum() + (sT * 0.5).sum()).backward()
        grads.append([a.grad for a in leaves])
    sync(dev)
    errs = [float(((a - b).abs() - 1e-3 * b.abs()).max())
            for a, b in zip(*grads)]
    rec = dict(kernel="wkv_forward_grad", case="grad_vs_oracle_autograd",
               dtype="float32", shape=[8, 64, 64], chunk=16,
               max_abs_err=max(float((a - b).abs().max())
                               for a, b in zip(*grads)),
               max_rel_err=0.0, grad_excess_over_rtol=max(errs), tol=1e-3)
    if not max(errs) <= 1e-3:
        fail.append(rec)
    return rec


def wkv_checks(dev):
    """The WKV kernel against its plain version and the f64 oracle."""
    g = torch.Generator(device="cpu").manual_seed(2)
    BH, T, K, c = (WKV_MAIN[n] for n in ("BH", "T", "K", "chunk"))
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, BH, T, K, chunk, dtype, per-row u, decay, f64 oracle)
    cases = [
        ("main_bf16_strong", BH, T, K, c, bf16, True, "strong", True),
        ("main_f32_init", BH, T, K, c, f32, False, "init", True),
        ("main_bf16_init", BH, T, K, c, bf16, True, "init", False),
        ("chunk64_bf16_strong", BH, T, K, 64, bf16, True, "strong", True),
        ("c_eq_T_7", BH, 7, K, c, f32, True, "strong", True),
        ("one_chunk", BH, c, K, c, bf16, False, "strong", True),
        ("B1_bf16", BH // 4, T, K, c, bf16, True, "init", True),
        ("K32_c24_ragged", 96, 96, 32, 24, f32, True, "strong", True),
        ("K16_c5", 64, 40, 16, 5, bf16, False, "strong", True),
        # grids that do not fill a tile of rows or the card
        ("BH1_bf16_strong", 1, T, K, c, bf16, True, "strong", True),
        ("BH3_f32", 3, 512, K, c, f32, False, "init", True),
        ("BH3_K32_c16_strong", 3, 256, 32, c, bf16, True, "strong", True),
        # the train phase's calls: the cell's (B 4 x H 64, T 1024) and the
        # routes check's f32 (B 2, T 256)
        ("train_bf16_init", 4 * K, TRAIN["seq"], K, c, bf16, True, "init",
         True),
        ("train_routes_f32", 2 * K, TRAIN_SMALL["seq"], K, c, f32, True,
         "init", True),
    ]
    recs, fail = [], []
    for name, bh, t, k, ch, dt, per_row, decay, ref64 in cases:
        args = wkv_inputs(dev, g, bh, t, k, dt, per_row_u=per_row,
                          decay=decay)
        recs.append(check_wkv(dev, name, args, ch, fail, ref64=ref64))
    recs.append(wkv_grad_check(dev, fail))
    for name, bh, t, k, ch, dt, per_row, decay in (
            ("first_pass_main", 16, T, K, c, bf16, True, "init"),
            ("first_pass_strong", 16, 512, K, c, f32, False, "strong"),
            ("first_pass_K32_c24", 8, 96, 32, 24, f32, True, "strong")):
        args = wkv_inputs(dev, g, bh, t, k, dt, per_row_u=per_row,
                          decay=decay)
        recs.append(check_wkv_first_pass(dev, name, args, ch, fail))
    return recs, fail


def check_wkv_first_pass(dev, name, args, chunk, fail):
    """The kernel's first pass (w = w_ts + bonus of every chunk) against
    its plain version, with check_wkv's tolerance for o (w is a sum of the
    same exp-weighted products, evaluated as products of exp(lw) there and
    as exp of differences of cumulative sums here)."""
    from repro_torch.kernels.wkv.kernel import (wkv_chunk_w_cuda,
                                                wkv_chunk_w_plain)
    r, k, v, lw, u, s0 = args
    wk = wkv_chunk_w_cuda(r, k, lw, u, chunk=chunk)
    wp = wkv_chunk_w_plain(r, k, lw, u, chunk=chunk)
    sync(dev)
    tol = WKV_TOL + _lin_max(lw, chunk) * 2.0 ** -18
    err = _scaled(wk, wp)
    rec = dict(kernel="wkv_forward", case=name,
               dtype=str(r.dtype).replace("torch.", ""),
               shape=list(r.shape), chunk=min(chunk, r.shape[1]),
               max_abs_err=float((wk - wp).abs().max()), w_err=err,
               max_rel_err=err, tol_w=tol,
               finite=bool(torch.isfinite(wk).all()))
    if not (rec["finite"] and err <= tol):
        fail.append(rec)
    return rec


# --------------------------------------------------------------- main path
def kdd_pipeline(truth, policy, **kw):
    """The kddFull-like ``PipelineConfig``: KDD's settings, t = the planted
    outliers, random partition, l2sq; ``kw`` adds e.g. a summarizer."""
    from repro_torch.api import pipeline_config
    return pipeline_config(dim=KDD["d"], k=KDD["k"], t=len(truth),
                           sites=KDD["sites"], partition="random",
                           second_iters=KDD["second_iters"], seed=KDD["seed"],
                           kernels=policy, **kw)


def run_oneshot(dev, x_dev, truth, *, k, t, sites, second_iters, seed,
                policy, label):
    """Algorithm 3 as the paper's benchmarks run it: ``simulate_coordinator``
    over ``sites`` contiguous parts with Algorithm 2 site summaries (no
    summarizer; a ``PipelineConfig``'s default, the registry's ``auto``,
    is the weighted Algorithm 1 instead, as in the reference's Session)."""
    from repro_torch.core.distributed import local_budget, simulate_coordinator
    from repro_torch.core.metrics import clustering_losses, outlier_scores
    from repro_torch.core.sampler import TorchSampler
    from repro_torch.core.summary import _plan

    sync(dev)
    t0 = time.perf_counter()
    res = simulate_coordinator(
        torch.tensor_split(x_dev, sites), TorchSampler(seed), k=k, t=t,
        partition="random", second_iters=second_iters, metric="l2sq",
        policy=policy, device=dev)
    t1 = time.perf_counter()
    mask = torch.zeros((x_dev.shape[0],), dtype=torch.bool, device=dev)
    mask[torch.as_tensor(res["outlier_ids"], device=dev)] = True
    l1, l2 = clustering_losses(x_dev, torch.as_tensor(res["centers"],
                                                      device=dev), mask,
                               policy=policy)
    l1, l2 = float(l1), float(l2)
    t2 = time.perf_counter()
    sc = outlier_scores(truth, res["summary_ids"], res["outlier_ids"])

    # the paper's invariants, per site
    n = x_dev.shape[0]
    sizes = [len(a) for a in np.array_split(np.arange(n), sites)]
    offs = np.cumsum([0] + sizes)
    t_i = local_budget(t, sites, "random")
    gid, w = res["summary_ids"], res["summary_weights"]
    for i in range(sites):
        sel = (gid >= offs[i]) & (gid < offs[i + 1])
        mass = float(w[sel].sum())
        if mass != sizes[i]:
            raise AssertionError(f"{label} site {i}: summary mass {mass} != "
                                 f"{sizes[i]} points")
        rounds_cap = _plan(sizes[i], k, t_i, 2.0, 0.45)[2]
        if res["site_rounds"][i] > rounds_cap:
            raise AssertionError(f"{label} site {i}: {res['site_rounds'][i]}"
                                 f" rounds > plan {rounds_cap}")
    # |X_r| <= 8 t_i: candidates are the weight-1 records Alg. 1 kept; the
    # coordinator reports them per record, so count per site
    cand = res["summary_candidates"]
    for i in range(sites):
        sel = (gid >= offs[i]) & (gid < offs[i + 1])
        if int(cand[sel].sum()) > 8 * t_i:
            raise AssertionError(f"{label} site {i}: |X_r| > 8 t_i")
    d = x_dev.shape[1]
    rec_bytes = 4 * d + 4 + 8 + 1      # point + weight + global id + flag
    out = {
        "run": label, "n": n, "d": d, "k": k, "t": t, "sites": sites,
        "t_i": t_i, "site_rounds": res["site_rounds"],
        "phase_s": {**res["phase_s"], "losses": t2 - t1,
                    "oneshot_total": t1 - t0},
        "comm_records": res["comm_records"],
        "comm_bytes": int(res["comm_records"]) * rec_bytes,
        "comm_frac_of_data": res["comm_records"] / n,
        "site_records_min_max": [min(res["site_records"]),
                                 max(res["site_records"])],
        "preRec": sc.pre_recall, "prec": sc.precision, "recall": sc.recall,
        "n_outliers": int(len(res["outlier_ids"])),
        "l1_loss": l1, "l2_loss": l2, "cost": res["cost"],
    }
    return res, out


def serve_model(dev, x_dev, x_np, truth, res, policy):
    """The serving model from a fit (``_model_from_result``), then the
    serving read; returns (model, serving report)."""
    from repro_torch.api.session import _model_from_result
    model = _model_from_result(x_dev, res, kdd_pipeline(truth, policy), 1,
                               device=dev)
    return model, serve(dev, x_np, truth, model, policy)


def serve(dev, x_np, truth, model, policy):
    from repro_torch.stream.service import _score_batch
    rng = np.random.default_rng(1)
    clean = np.setdiff1d(np.arange(x_np.shape[0]), truth)
    lat, planted_hits, planted_n, clean_hits, clean_n = [], 0, 0, 0, 0
    for b in range(SERVE_BATCHES):
        n_pl = 32
        rows = np.concatenate([rng.choice(truth, n_pl),
                               rng.choice(clean, MICRO_BATCH - n_pl)])
        is_pl = np.arange(MICRO_BATCH) < n_pl
        xb = x_np[rows]
        t0 = time.perf_counter()
        dist, idx, score = _score_batch(
            torch.from_numpy(xb).to(dev), model.centers, model.threshold,
            metric="l2sq", policy=policy)
        score = score.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        flagged = score > 1.0
        planted_hits += int(flagged[is_pl].sum())
        planted_n += int(is_pl.sum())
        clean_hits += int(flagged[~is_pl].sum())
        clean_n += int((~is_pl).sum())
        if not np.isfinite(score).all():
            raise AssertionError("non-finite scores")
    lat_ms = np.asarray(lat) * 1e3
    return {"batches": SERVE_BATCHES, "micro_batch": MICRO_BATCH,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "outlier_rate_planted": planted_hits / planted_n,
            "outlier_rate_clean": clean_hits / clean_n}


# ------------------------------------- the paper's Table 3 head-to-head
# Each summarizer or baseline at the paper summary's budget, followed by the
# same second level (k-means--, 25 iterations): ``paper`` (the registry's
# weighted Alg. 1), ``ball_cover``, ``coreset`` and ``uniform`` through
# ``_run_oneshot(summarizer=...)``; ``rand`` and ``k-means||`` per site
# through their own functions, as ``benchmarks/common.py::run_algo`` runs
# them, k-means|| in 5 rounds with its multi-round traffic added to comm.
H2H = ("paper", "ball_cover", "coreset", "uniform", "rand", "k-means||")
KPAR_ROUNDS = 5


def h2h_budget(kdd_res) -> int:
    """Records per site of the paper's Alg. 2 summary of the kdd fit."""
    return -(-int(kdd_res["comm_records"]) // KDD["sites"])


def per_site_baseline(dev, x_dev, name, b, *, k, t, sites, seed, policy):
    """``rand`` or ``k-means||`` summaries per site, then the coordinator's
    gather and k-means-- (``coordinator_fit``); the result keys of
    ``_run_oneshot``, with k-means||'s multi-round traffic added to comm."""
    from repro_torch.core import kmeans_parallel_summary, rand_summary
    from repro_torch.core.distributed import coordinator_fit
    from repro_torch.core.sampler import TorchSampler
    parts = torch.tensor_split(x_dev, sites)
    offs = np.cumsum([0] + [p.shape[0] for p in parts])
    smp = TorchSampler(seed)
    pts, wts, gids, cands, extra = [], [], [], [], 0.0
    sync(dev)
    t0 = time.perf_counter()
    for i, part in enumerate(parts):
        if name == "rand":
            summ = rand_summary(part, smp.fold_in(i), budget=b, policy=policy)
        else:
            r = kmeans_parallel_summary(part, smp.fold_in(i), budget=b,
                                        rounds=KPAR_ROUNDS, sites=sites,
                                        policy=policy)
            summ = r.summary
            extra += r.comm_records / sites      # multi-round overhead
        pts.append(summ.points)
        wts.append(summ.weights)
        gids.append(summ.indices.long() + int(offs[i]))
        cands.append(summ.is_candidate)
    sync(dev)
    t1 = time.perf_counter()
    res = coordinator_fit(pts, wts, gids, cands,
                          [1 if name == "rand" else KPAR_ROUNDS] * sites,
                          smp, k=k, t=t, second_iters=KDD["second_iters"],
                          policy=policy)
    t2 = time.perf_counter()
    res["comm_records"] += extra
    res["phase_s"] = {"site_summaries": t1 - t0, "second_level": t2 - t1}
    return res


def h2h_checks(name, res, sizes, offs, t_i):
    """Per site: the summary's mass equals the site's rows (exact but for
    coreset's rescaled float weights: 1e-4 relative), ids lie in the site
    and are unique (k-means||: among the records that carry mass; a
    repeated draw carries none), and for the ball-growing summarizers
    |candidates| <= 8 t_i and rounds <= max_rounds + 4."""
    from repro_torch.stream.weighted import max_rounds
    gid = res["summary_ids"]
    w = res["summary_weights"].astype(np.float64)
    cand = res["summary_candidates"]
    cut = np.cumsum([0] + res["site_records"])
    if cut[-1] != gid.shape[0]:
        raise AssertionError(f"h2h {name}: site_records do not add up")
    for i, n_i in enumerate(sizes):
        g, wi = gid[cut[i]:cut[i + 1]], w[cut[i]:cut[i + 1]]
        mass = float(wi.sum())
        tol = 1e-4 * n_i if name == "coreset" else 0.0
        if not abs(mass - n_i) <= tol:
            raise AssertionError(f"h2h {name} site {i}: mass {mass} != {n_i}")
        if not bool(((g >= offs[i]) & (g < offs[i + 1])).all()):
            raise AssertionError(f"h2h {name} site {i}: an id off its site")
        live = g[wi > 0] if name == "k-means||" else g
        if np.unique(live).size != live.size:
            raise AssertionError(f"h2h {name} site {i}: repeated ids")
        if name in ("paper", "ball_cover"):
            if int(cand[cut[i]:cut[i + 1]].sum()) > 8 * t_i:
                raise AssertionError(f"h2h {name} site {i}: |X_r| > 8 t_i")
            cap = max_rounds(n_i, t_i, 0.45) + 4
            if res["site_rounds"][i] > cap:
                raise AssertionError(f"h2h {name} site {i}: "
                                     f"{res['site_rounds'][i]} rounds > {cap}")


def h2h_row(dev, x_dev, truth, name, b, policy):
    """One row of the head-to-head: the fit, its losses and scores, and its
    checks (any failure raises)."""
    from repro_torch.api.session import _run_oneshot
    from repro_torch.core.distributed import local_budget
    from repro_torch.core.metrics import clustering_losses, outlier_scores
    from repro_torch.summarize import get_summarizer, summarizer_policy
    k, t, sites = KDD["k"], len(truth), KDD["sites"]
    sync(dev)
    t0 = time.perf_counter()
    if name in ("rand", "k-means||"):
        res = per_site_baseline(dev, x_dev, name, b, k=k, t=t, sites=sites,
                                seed=KDD["seed"], policy=policy)
    else:
        params = {"budget": b} if get_summarizer(name).sized else {}
        res = _run_oneshot(
            x_dev, kdd_pipeline(truth, policy, summarizer=summarizer_policy(
                name, **params)), device=dev)
    t1 = time.perf_counter()
    centers = torch.as_tensor(res["centers"], device=dev)
    mask = torch.zeros((x_dev.shape[0],), dtype=torch.bool, device=dev)
    mask[torch.as_tensor(res["outlier_ids"], device=dev)] = True
    l1, l2 = (float(v) for v in clustering_losses(x_dev, centers, mask,
                                                  policy=policy))
    sc = outlier_scores(truth, res["summary_ids"], res["outlier_ids"])
    sizes = [len(a) for a in np.array_split(np.arange(x_dev.shape[0]),
                                            sites)]
    h2h_checks(name, res, sizes, np.cumsum([0] + sizes),
               local_budget(t, sites, "random"))
    if not (np.isfinite(res["centers"]).all() and np.isfinite([l1, l2]).all()
            and res["centers"].shape == (k, x_dev.shape[1])):
        raise AssertionError(f"h2h {name}: non-finite or malformed result")
    return {"algo": name, "budget_per_site": b,
            "records": int(len(res["summary_ids"])),
            "comm_records": res["comm_records"],
            "site_summary_s": res["phase_s"]["site_summaries"],
            "second_level_s": res["phase_s"]["second_level"],
            "total_s": t1 - t0, "site_rounds_max": max(res["site_rounds"]),
            "preRec": sc.pre_recall, "prec": sc.precision,
            "recall": sc.recall, "n_outliers": int(len(res["outlier_ids"])),
            "l1_loss": l1, "l2_loss": l2, "cost": res["cost"]}


def head_to_head(dev, x_dev, truth, b, policy, counted):
    """The paper's Table 3 on kddFull-like: every row of ``H2H`` at budget
    ``b`` per site, each driven with the launch counters at 0 just before it
    and read just after (min_argmin and lloyd_step must both launch); then
    the paper's claim, its preRec above uniform's and rand's."""
    rows = []
    for name in H2H:
        row = counted(f"h2h_{name}", ("min_argmin", "lloyd_step"),
                      lambda: h2h_row(dev, x_dev, truth, name, b, policy))
        log("h2h", json.dumps(row))
        rows.append(row)
    pre = {r["algo"]: r["preRec"] for r in rows}
    if not pre["paper"] > max(pre["uniform"], pre["rand"]):
        raise AssertionError(f"h2h: paper preRec {pre['paper']} does not "
                             f"exceed uniform's and rand's: {pre}")
    return rows


# -------------------------------------------- the streaming service path
# The reference's long-stream deployment, benchmarks/stream_bench.py::
# store_section at points=1,000,000 (its t = points // 100): gauss(20
# centers x 50,000 rows, d = 5, sigma = 0.1, t = 10,000) through
# ServiceConfig(dim=5, k=20, t=10,000, leaf_size=2048, refresh_every=n//4,
# micro_batch=256, window=n//2), ingested in batches of 8,192, once with
# every summary resident and once under StoreSpec(hot_levels=1) (levels >= 2
# spill to disk and are paged back in for merges and root gathers).
STREAM = dict(n_centers=20, per_center=50_000, d=5, sigma=0.1, t=10_000,
              k=20, leaf_size=2_048, batch=8_192, seed=0, planted=32,
              extra=8_192)
# The kernel-vs-plain stream: the same tree and service settings on an
# integer grid, where every distance between two rows is exact in f32 in any
# order of summation: 20 clusters of +-4 around integer centers in
# [-60, 60]^5 and `far` planted rows at +-[256, 512] per coordinate (squared
# distances < 2^24), t = n // 100 as store_section sizes it.  At this t the
# merge-reduce of two level-2 nodes (16,384 records > 8t) runs Algorithm 1's
# rounds, which the deployment above never does (its nodes stop at 65,536
# records, under 8t = 80,000, by the window's span cap).
STREAM_GRID = dict(n=200_000, far=6_000, k=20, seed=1)


def stream_config(n, t, policy, **over):
    """store_section's ServiceConfig for a stream of ``n`` rows."""
    from repro_torch.stream import ServiceConfig
    return ServiceConfig(dim=STREAM["d"], k=STREAM["k"], t=t,
                         leaf_size=STREAM["leaf_size"],
                         refresh_every=max(n // 4, STREAM["batch"]),
                         micro_batch=MICRO_BATCH,
                         window=max(n // 2, STREAM["batch"]),
                         policy=policy, seed=STREAM["seed"], **over)


def stream_ingest(svc, x):
    """Ingest ``x`` in the deployment's batches.  Returns (wall s, {version:
    (model, fit s)} of every model installed meanwhile); the wall includes
    the cadence refreshes, as store_section's does."""
    fits = {}
    sync(svc.device)
    t0 = time.perf_counter()
    for i in range(0, x.shape[0], STREAM["batch"]):
        svc.ingest(x[i:i + STREAM["batch"]])
        if svc.last_fit is not None:
            fits.setdefault(svc.last_fit.version,
                            (svc.model, svc.last_fit.fit_s))
    sync(svc.device)
    return time.perf_counter() - t0, fits


def _same_models(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("centers", "threshold", "cost", "version",
                         "trained_weight"))


def _same_results(ra, rb) -> bool:
    return len(ra) == len(rb) and all(
        (a.center, a.distance, a.outlier_score) ==
        (b.center, b.distance, b.outlier_score) for a, b in zip(ra, rb))


def _window_checks(label, svc, fail):
    """Mass conservation and the window bound: the live mass equals the
    unit-weight rows the live nodes and the buffer span, within the window
    plus one merge span and one leaf; every node within ``record_cap``."""
    from repro_torch.stream import record_cap
    tree, cfg = svc.tree, svc.cfg
    rows = sum(nd.count for nd in tree.nodes) + tree._buf_n
    mass = tree.total_weight
    cap = record_cap(tree.cfg)
    out = {"live_rows": rows, "live_mass": mass, "nodes": len(tree.nodes),
           "levels": [nd.level for nd in tree.nodes],
           "records": tree.num_records,
           "max_node_records": max(nd.n_records for nd in tree.nodes),
           "record_cap": cap}
    bound = cfg.window + cfg.window // 4 + cfg.leaf_size
    if not (abs(mass - rows) <= 1e-6 * rows and rows <= bound
            and out["max_node_records"] <= cap):
        fail.append(f"{label}: mass/window/cap {out} (bound {bound})")
    return out


def stream_main(dev, x, truth, tmp):
    """The deployment through the user's entry points (``StreamService``'s
    ingest, refresh, submit/drain, save/restore), with every check the
    phase holds; returns (report, the shapes its kernels ran at)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.store import StoreSpec
    from repro_torch.stream import StreamService
    auto, fail = KernelPolicy(), []
    n, t = x.shape[0], STREAM["t"]
    t_phase = time.perf_counter()
    plain = StreamService(stream_config(n, t, auto), device=dev)
    wall_plain, fits_plain = stream_ingest(plain, x)
    spec = StoreSpec(hot_levels=1, directory=str(tmp / "spill"))
    tiered = StreamService(stream_config(n, t, auto, store=spec), device=dev)
    wall_tiered, fits_tiered = stream_ingest(tiered, x)
    out = {"n": n, "d": x.shape[1], "k": STREAM["k"], "t": t,
           "window": plain.cfg.window, "refresh_every":
           plain.cfg.refresh_every, "leaf_size": plain.cfg.leaf_size,
           "batch": STREAM["batch"],
           "ingest_points_per_s": {"plain": n / wall_plain,
                                   "tiered": n / wall_tiered},
           "ingest_s": {"plain": wall_plain, "tiered": wall_tiered},
           "cadence_fit_s": {"plain": [f for _, f in fits_plain.values()],
                             "tiered": [f for _, f in fits_tiered.values()]}}
    log("stream ingest", json.dumps(out))

    # store contract: the root moves bytes only, and the tier did move
    roots = [svc.tree.packed_root() for svc in (plain, tiered)]
    out["root_rows"] = int(roots[0][0].shape[0])
    out["roots_bitwise_equal"] = all(np.array_equal(a, b)
                                     for a, b in zip(*roots))
    out["store"] = tiered.tree.store.stats()
    if not out["roots_bitwise_equal"]:
        fail.append("tiered packed_root differs from the resident one")
    if not (out["store"]["spills"] >= 1 and out["store"]["page_ins"] >= 1):
        fail.append(f"the tier never spilled or paged in: {out['store']}")
    out["window_plain"] = _window_checks("plain", plain, fail)
    out["window_tiered"] = _window_checks("tiered", tiered, fail)
    # what the session phase's stream must equal: the resident service's
    # final model and one drain of 256 of its rows
    q_res = x[np.random.default_rng(7).choice(n, MICRO_BATCH)]
    resident = {"x": x, "model": plain.model, "q": q_res,
                "drain": plain.score(q_res)}

    # incremental refresh: two refreshes on the final root.  The last
    # cadence fit may already have seen it (n a multiple of the cadence):
    # then both skip; either way the second must.
    from repro_torch import obs
    skipped = obs.counter("refresh.skipped", topology="stream")
    m1 = tiered.refresh()
    skips = skipped.value
    t0 = time.perf_counter()
    m2 = tiered.refresh()
    out["skipped_refresh_s"] = time.perf_counter() - t0
    out["refresh_fit_s"] = tiered.last_fit.fit_s
    out["refresh_skipped"] = (skipped.value == skips + 1
                              and int(m2.version) == int(m1.version))
    if not out["refresh_skipped"]:
        fail.append("the second refresh on an unchanged root was not "
                    "skipped")

    # async refresh: the same prefix, the fit on a worker thread, installs
    # the blocking service's model of the same version bit for bit
    asy = StreamService(stream_config(n, t, auto, async_refresh=True),
                        device=dev)
    stream_ingest(asy, x[:plain.cfg.refresh_every])
    asy.join_refresh()
    out["async_equals_blocking"] = (int(asy.model.version) == 1 and
                                    _same_models(asy.model,
                                                 fits_plain[1][0]))
    if not out["async_equals_blocking"]:
        fail.append("the async model differs from the blocking one")
    del asy

    # serving: micro-batches of 224 clean window rows + 32 planted rows
    lo = min(nd.min_seq for nd in tiered.tree.nodes)
    in_window = np.arange(lo, n)
    planted = np.intersect1d(truth, in_window)
    clean = np.setdiff1d(in_window, truth)
    rng = np.random.default_rng(3)
    tiered.reset_latency_stats()
    lat, hits = [], np.zeros(2, np.int64)
    for _ in range(SERVE_BATCHES):
        rows = np.concatenate([
            rng.choice(planted, STREAM["planted"]),
            rng.choice(clean, MICRO_BATCH - STREAM["planted"])])
        t0 = time.perf_counter()
        tiered.submit(x[rows])
        res = tiered.drain()
        lat.append(time.perf_counter() - t0)
        flags = np.array([r.is_outlier for r in res])
        hits += [flags[:STREAM["planted"]].sum(),
                 flags[STREAM["planted"]:].sum()]
        if len(res) != MICRO_BATCH or not np.isfinite(
                [r.outlier_score for r in res]).all():
            fail.append("a drained micro-batch is short or not finite")
            break
    lat_ms = np.asarray(lat) * 1e3
    out["serve"] = {
        "batches": len(lat), "micro_batch": MICRO_BATCH,
        "latency_stats": tiered.latency_stats(),
        "batch_p50_ms": float(np.percentile(lat_ms, 50)),
        "batch_p99_ms": float(np.percentile(lat_ms, 99)),
        "outlier_rate_planted": float(hits[0]) / (len(lat) *
                                                  STREAM["planted"]),
        "outlier_rate_clean": float(hits[1]) / (
            len(lat) * (MICRO_BATCH - STREAM["planted"]))}
    log("stream serve", json.dumps(out["serve"]))

    # checkpoint: save, restore through a fresh manager, the same scores
    # bit for bit; then both ingest more rows and refit: the bounded sampler
    # state keeps them equal
    q = x[rows]
    before = tiered.score(q)
    t0 = time.perf_counter()
    tiered.save(CheckpointManager(tmp / "ckpt"), step=1)
    out["checkpoint_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = StreamService.restore(tiered.cfg,
                                     CheckpointManager(tmp / "ckpt"),
                                     device=dev)
    out["checkpoint_restore_s"] = time.perf_counter() - t0
    out["restored_scores_bitwise"] = _same_results(restored.score(q), before)
    more = x[:STREAM["extra"]]
    for svc in (tiered, restored):
        svc.ingest(more)
    same = [np.array_equal(a, b) for a, b in
            zip(tiered.tree.packed_root(), restored.tree.packed_root())]
    same.append(np.array_equal(tiered.tree.sampler.key_data(),
                               restored.tree.sampler.key_data()))
    same.append(_same_models(tiered.refresh(), restored.refresh()))
    out["restored_continues_bitwise"] = all(same)
    if not (out["restored_scores_bitwise"]
            and out["restored_continues_bitwise"]):
        fail.append(f"the restored service parted from the saved one: "
                    f"scores {out['restored_scores_bitwise']}, on {same}")
    out["phase_s"] = time.perf_counter() - t_phase
    log("stream checks", json.dumps({k: v for k, v in out.items()
                                     if k not in ("serve",)}))
    if fail:
        raise AssertionError(f"stream phase: {fail}")
    model = tiered.model
    pts, wts, _ = (torch.from_numpy(a).to(dev)
                   for a in tiered.tree.packed_root())
    shapes = {"root": (pts, wts), "centers": model.centers,
              "threshold": model.threshold,
              "query": torch.from_numpy(q).to(dev), "resident": resident}
    for svc in (tiered, restored):
        svc.tree.store.close()     # no spill write outlives the directory
    return out, shapes


def stream_grid(n, far, k, seed):
    """The integer-grid stream (see STREAM_GRID) and its planted ids."""
    rng = np.random.default_rng(seed)
    cen = rng.integers(-60, 61, size=(k, STREAM["d"]))
    x = cen[rng.integers(0, k, n)] + rng.integers(-4, 5, size=(n, STREAM["d"]))
    ids = np.sort(rng.choice(n, far, replace=False))
    x[ids] = rng.integers(256, 513, size=(far, STREAM["d"])) * \
        rng.choice([-1, 1], size=(far, STREAM["d"]))
    return x.astype(np.float32), ids


def stream_kernel_vs_plain(dev, kernels):
    """The grid stream through the service on the kernels
    (``backend="cuda"``) and on the plain torch path (``"blocked"``) from
    the same seed.  Every distance the tree computes is exact, so the packed
    roots must be equal bit for bit, and so must the fitted centers (a Lloyd
    mean of integer sums is one rounding).  A distance to those centers is
    a dot product the kernel and cuBLAS sum in other orders: the threshold
    and the drained distances are held to TOL of the expansion's magnitude
    (as the kernel checks are), their argmins and flags must be equal, and
    how many came out bit for bit is reported."""
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.stream import StreamService
    x, far = stream_grid(**STREAM_GRID)
    n = x.shape[0]
    t = max(n // 100, 40)
    runs = {}
    for backend in ("blocked", "cuda"):
        for kern in kernels:
            kern.launches = 0
        svc = StreamService(stream_config(n, t, KernelPolicy(backend=backend)),
                            device=dev)
        wall, _ = stream_ingest(svc, x)
        svc.refresh()
        lo = min(nd.min_seq for nd in svc.tree.nodes)
        rng = np.random.default_rng(5)
        q = np.concatenate([x[rng.choice(far[far >= lo], 32)],
                            x[rng.choice(np.arange(lo, n), 224)]])
        res = svc.score(q)
        runs[backend] = dict(svc=svc, root=svc.tree.packed_root(), q=q,
                             res=res, wall=wall,
                             launches={kk.name: kk.launches
                                       for kk in kernels})
    b, c = runs["blocked"], runs["cuda"]
    mb, mc = b["svc"].model, c["svc"].model
    pts = torch.from_numpy(b["root"][0]).to(dev)
    cen = mb.centers.double()
    scale = float((pts.double() ** 2).sum(1).max() + (cen ** 2).sum(1).max())
    qd = torch.from_numpy(b["q"]).to(dev)
    dk = torch.tensor([r.distance for r in c["res"]], device=dev)
    dp = torch.tensor([r.distance for r in b["res"]], device=dev)
    ap = torch.tensor([r.center for r in b["res"]], device=dev)
    out = {
        "n": n, "t": t, "far": STREAM_GRID["far"],
        "ingest_s": {"blocked": b["wall"], "cuda": c["wall"]},
        "launches": {"blocked": b["launches"], "cuda": c["launches"]},
        "max_summary_rounds": max(nd.summary.n_rounds
                                  for nd in c["svc"].tree.nodes),
        "roots_bitwise_equal": all(np.array_equal(p, q) for p, q in
                                   zip(b["root"], c["root"])),
        "centers_bitwise_equal": bool(torch.equal(mb.centers, mc.centers)),
        "version": [int(mb.version), int(mc.version)],
        "threshold": [float(mb.threshold), float(mc.threshold)],
        "threshold_scaled_err": abs(float(mb.threshold)
                                    - float(mc.threshold)) / scale,
        "argmins_equal": [r.center for r in b["res"]]
        == [r.center for r in c["res"]],
        "flags_equal": [r.is_outlier for r in b["res"]]
        == [r.is_outlier for r in c["res"]],
        "drained_dist_scaled_err": dist_err(qd, mb.centers, dk, dp, ap,
                                            "l2sq"),
        "drained_dist_bitwise": sum(r.distance == s.distance
                                    for r, s in zip(b["res"], c["res"])),
        "drained_score_bitwise": sum(r.outlier_score == s.outlier_score
                                     for r, s in zip(b["res"], c["res"])),
    }
    log("stream kernel_vs_plain", json.dumps(out))
    ok = (out["roots_bitwise_equal"] and out["centers_bitwise_equal"]
          and out["version"][0] == out["version"][1]
          and out["threshold_scaled_err"] <= TOL and out["argmins_equal"]
          and out["flags_equal"] and out["drained_dist_scaled_err"] <= TOL
          and not any(b["launches"].values())
          and all(c["launches"][kk] > 0 for kk in
                  ("min_argmin", "lloyd_step", "score")))
    if not ok:
        raise AssertionError(f"stream kernel vs plain: {out}")
    return out, x


def stream_phase(dev, counted, kernels, checks):
    """The "stream" phase: the deployment (counted), the kernel-vs-plain grid
    stream, the three kernels against their plain versions at the stream's
    shapes, and their timings.  Returns (report, timing rows, the resident
    service's stream, final model and one drain)."""
    import tempfile
    from repro_torch.data.synthetic import gauss
    t0 = time.perf_counter()
    x, truth = gauss(n_centers=STREAM["n_centers"],
                     per_center=STREAM["per_center"], d=STREAM["d"],
                     sigma=STREAM["sigma"], t=STREAM["t"], seed=STREAM["seed"])
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        out, shapes = counted("stream", ("min_argmin", "lloyd_step", "score"),
                              lambda: stream_main(dev, x, truth, Path(tmp)))
    out["kernel_vs_plain"], gx = stream_kernel_vs_plain(dev, kernels)

    # the kernels at the stream's shapes against their plain versions: a
    # merge-reduce round of the grid stream (two level-2 nodes' records
    # against Alg. 1's m samples), the refresh's last assignment and Lloyd
    # step on the deployment's root, a micro-batch against its model
    leaf = STREAM["leaf_size"]
    merged = torch.from_numpy(gx[:4 * 2 * leaf]).to(dev)
    m_round = merge_round_m(merged.shape[0])
    rnd_c = merged[::merged.shape[0] // m_round][:m_round].contiguous()
    pts, wts = shapes["root"]
    cen, thr, q = shapes["centers"], shapes["threshold"], shapes["query"]
    fail = []
    recs = [check_pdist(dev, "stream_merge_round", merged, rnd_c, "l2sq",
                        fail),
            check_pdist(dev, "stream_refresh_assign", pts, cen, "l2sq",
                        fail),
            check_lloyd(dev, "stream_refresh_root", pts, wts, cen, "l2sq",
                        fail),
            check_score(dev, "stream_micro_batch", q, cen, thr, "l2sq",
                        fail)]
    for rec in recs:
        log("check", json.dumps(rec))
    checks += recs
    if fail:
        raise AssertionError(f"kernels at the stream's shapes: {fail}")
    timings = stream_timings(dev, merged, rnd_c, pts, wts, cen, thr, q)
    out["total_s"] = time.perf_counter() - t0
    log(f"stream_s {out['total_s']:.2f}")
    return out, timings, shapes["resident"]


def merge_round_m(n_records) -> int:
    """Alg. 1's samples per round at a merge of ``n_records`` records
    (``stream/weighted.py``: m = ceil(alpha * max(k, ceil(ln n))))."""
    import math
    kappa = max(STREAM["k"], max(1, math.ceil(math.log(max(n_records, 2)))))
    return int(math.ceil(2.0 * kappa))


def stream_timings(dev, merged, rnd_c, pts, wts, cen, thr, q):
    """Kernel, plain and yardstick times at the stream's shapes."""
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
    from repro_torch.kernels.lloyd.ops import lloyd_step_blocked
    from repro_torch.kernels.pdist.kernel import min_argmin_cuda
    from repro_torch.kernels.pdist.ops import min_argmin_blocked
    from repro_torch.kernels.score.kernel import score_cuda
    from repro_torch.kernels.score.ops import score_blocked
    rows = []
    blocked = KernelPolicy(backend="blocked")
    for name, x, c, reps in (("stream_merge_round", merged, rnd_c, 50),
                             ("stream_refresh_assign", pts, cen, 20)):
        n, d = x.shape
        timing_row(rows, "min_argmin", name, [n, c.shape[0], d],
                   pdist_work(n, c.shape[0], d, "l2sq"),
                   lambda: min_argmin_cuda(x, c),
                   lambda: min_argmin_blocked(x, c),
                   lambda: cdist_min(x, c), reps)
    (n, d), k = pts.shape, cen.shape[0]
    timing_row(rows, "lloyd_step", "stream_refresh_root", [n, k, d],
               lloyd_work(n, k, d), lambda: lloyd_step_cuda(pts, wts, cen),
               lambda: lloyd_step_blocked(pts, wts, cen, policy=blocked),
               None, 20)
    # no single PyTorch call is a Lloyd step: its assignment alone by
    # torch.cdist, as a partial yardstick
    rows[-1]["cdist_assign_ms"] = time_ms(lambda: cdist_min(pts, cen), 10)
    log(f"timing lloyd_step stream_refresh_root: its assignment alone by "
        f"torch.cdist {rows[-1]['cdist_assign_ms']:.4f} ms")
    timing_row(rows, "score", "stream_micro_batch", [MICRO_BATCH, k, d],
               pdist_work(MICRO_BATCH, k, d, "l2sq", extra_out=4),
               lambda: score_cuda(q, cen, thr), lambda: score_blocked(q, cen,
                                                                     thr),
               lambda: torch.cdist(q, cen).min(dim=1), 200)
    return rows


# ------------------------------------------------------- the session phase
# The front door (``repro_torch.api``) at the sizes of the phases above:
# ``Session`` over the kddFull-like oneshot run and the 1M stream, save and
# load, the tile autotuner, and ``python -m repro_torch`` on the examples.
SESSION_RESULT_KEYS = ("centers", "outlier_ids", "summary_ids",
                       "summary_weights", "comm_records", "cost")
CLI_RUNS = (("run", "examples/oneshot.json"),
            ("serve", "examples/stream.toml"),
            ("serve", "examples/stream_store.json"))
# the autotuner's shapes: the kdd serving micro-batch, the stream refit
TUNE_SHAPES = {"kdd_serving": (256, 3, 34), "stream_refit": (1_048_576, 20, 5)}


def _same_oneshot(ra, rb) -> dict:
    return {k: bool(np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])))
            for k in SESSION_RESULT_KEYS}


def session_direct(dev, kdd_x, cfg):
    """What ``Session.fit`` must equal: the coordinator entry point and the
    serving model driven directly, on the card's copy of the data.
    Returns (result, model, seconds)."""
    from repro_torch.api.session import _model_from_result, _run_oneshot
    sync(dev)
    t0 = time.perf_counter()
    res = _run_oneshot(kdd_x, cfg, device=dev)
    model = _model_from_result(kdd_x, res, cfg, 1, device=dev)
    sync(dev)
    return res, model, time.perf_counter() - t0


def session_oneshot(dev, kdd_np, truth, cfg, direct, tmp, fail):
    """``Session(cfg).fit`` on the host rows, bit for bit the direct fit;
    400 micro-batches through ``Session.score``; save, load, the same
    queries bit for bit."""
    from repro_torch.api import Session
    res_d, model_d, direct_s = direct
    sync(dev)
    t0 = time.perf_counter()
    sess = Session(cfg, device=dev)
    model = sess.fit(kdd_np)
    sync(dev)
    out = {"fit_s": time.perf_counter() - t0, "direct_fit_s": direct_s,
           "records": sess.result["comm_records"]}
    out["facade_minus_direct_s"] = out["fit_s"] - direct_s
    out["result_bitwise"] = _same_oneshot(sess.result, res_d)
    out["model_bitwise"] = _same_models(model, model_d)
    if not (all(out["result_bitwise"].values()) and out["model_bitwise"]):
        fail.append(f"Session.fit differs from the direct fit: "
                    f"{out['result_bitwise']}, model {out['model_bitwise']}")

    # serving: the kdd phase's micro-batches (32 planted + 224 clean rows)
    rng = np.random.default_rng(1)
    clean = np.setdiff1d(np.arange(kdd_np.shape[0]), truth)
    lat, hits = [], np.zeros(2, np.int64)
    for _ in range(SERVE_BATCHES):
        rows = np.concatenate([rng.choice(truth, 32),
                               rng.choice(clean, MICRO_BATCH - 32)])
        t0 = time.perf_counter()
        res = sess.score(kdd_np[rows])
        lat.append(time.perf_counter() - t0)
        flags = np.array([r.is_outlier for r in res])
        hits += [flags[:32].sum(), flags[32:].sum()]
        if len(res) != MICRO_BATCH or not np.isfinite(
                [r.outlier_score for r in res]).all():
            fail.append("a Session.score micro-batch is short or not "
                        "finite")
            break
    lat_ms = np.asarray(lat) * 1e3
    out["serve"] = {
        "batches": len(lat), "micro_batch": MICRO_BATCH,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "latency_stats": sess.latency_stats(),
        "outlier_rate_planted": float(hits[0]) / (32 * len(lat)),
        "outlier_rate_clean": float(hits[1]) / (
            (MICRO_BATCH - 32) * len(lat))}

    # save -> load -> the last batch's queries, bit for bit
    q = kdd_np[rows]
    before = sess.score(q)
    t0 = time.perf_counter()
    sess.save(tmp / "session")
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = Session.load(tmp / "session", device=dev)
    out["load_s"] = time.perf_counter() - t0
    out["checkpoint_bytes"] = sum(f.stat().st_size for f in
                                  (tmp / "session").rglob("*")
                                  if f.is_file())
    out["loaded_scores_bitwise"] = _same_results(loaded.score(q), before)
    out["loaded_result_bitwise"] = all(
        _same_oneshot(loaded.result, sess.result).values())
    if not (out["loaded_scores_bitwise"] and out["loaded_result_bitwise"]):
        fail.append(f"the loaded session parted from the saved one: "
                    f"scores {out['loaded_scores_bitwise']}, result "
                    f"{out['loaded_result_bitwise']}")
    return out


def session_stream(dev, resident, fail):
    """The 1M stream deployment through ``Session``: its model and one
    drain bit for bit the stream phase's resident ``StreamService``."""
    from repro_torch.api import Session, pipeline_config
    from repro_torch.kernels.dispatch import KernelPolicy
    x = resident["x"]
    n = x.shape[0]
    sc = stream_config(n, STREAM["t"], KernelPolicy())
    cfg = pipeline_config(dim=sc.dim, k=sc.k, t=sc.t, topology="stream",
                          leaf_size=sc.leaf_size,
                          refresh_every=sc.refresh_every,
                          micro_batch=sc.micro_batch, window=sc.window,
                          seed=sc.seed)
    sess = Session(cfg, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(0, n, STREAM["batch"]):
        sess.ingest(x[i:i + STREAM["batch"]])
    sync(dev)
    wall = time.perf_counter() - t0
    out = {"n": n, "batch": STREAM["batch"], "ingest_s": wall,
           "ingest_rows_per_s": n / wall,
           "version": int(sess.model.version),
           "config_is_the_phases": cfg.service_config() == sc,
           "model_bitwise": _same_models(sess.model, resident["model"]),
           "drain_bitwise": _same_results(sess.score(resident["q"]),
                                          resident["drain"])}
    if not (out["config_is_the_phases"] and out["model_bitwise"]
            and out["drain_bitwise"]):
        fail.append(f"the stream Session differs from the resident "
                    f"service: {out}")
    return out


def session_autotune(dev, fail):
    """``KernelPolicy(autotune=True)`` on the card: under ``auto`` every op
    resolves to ``cuda`` with its default tiles, measures and writes
    nothing, and returns what the untuned policy returns bit for bit;
    under ``backend="blocked"`` it measures each op's candidates at the
    kdd serving and the stream refit shapes (the plain path's tiles, not
    kernel times), writes the cache, and a second resolution hits it."""
    import os
    import tempfile
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.lloyd.ops import lloyd_step
    from repro_torch.kernels.pdist.ops import min_argmin
    from repro_torch.kernels.score.ops import score
    out = {"auto": {}, "blocked": {}}
    real = (dispatch.measure_block_ns, dispatch.measure_tiles)
    measured = []

    def counting(fn):
        def wrapped(*a, **k):
            measured.append(a)
            return fn(*a, **k)
        return wrapped

    prev = os.environ.get("REPRO_TORCH_KERNELS_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-autotune-") as tmp:
        os.environ["REPRO_TORCH_KERNELS_CACHE"] = tmp
        cache = Path(tmp) / "autotune.json"
        dispatch.measure_block_ns = counting(real[0])
        dispatch.measure_tiles = counting(real[1])
        dispatch.clear_autotune_cache()
        try:
            tuned, untuned = KernelPolicy(autotune=True), KernelPolicy()
            g = torch.Generator(device="cpu").manual_seed(4)
            for name, (n, m, d) in TUNE_SHAPES.items():
                x = torch.randn(n, d, generator=g).to(dev)
                c = torch.randn(m, d, generator=g).to(dev)
                w = torch.rand(n, generator=g).to(dev)
                thr = torch.tensor(1.0, device=dev)
                same = {}
                for op, call in (
                        ("min_argmin", lambda p: min_argmin(x, c, policy=p)),
                        ("score", lambda p: score(x, c, thr, policy=p)),
                        ("lloyd_step", lambda p: lloyd_step(x, w, c,
                                                            policy=p))):
                    a = dispatch.resolve_tiles(op, tuned, metric="l2sq",
                                               n=n, m=m, d=d, platform="cuda")
                    b = dispatch.resolve_tiles(op, untuned, metric="l2sq",
                                               n=n, m=m, d=d, platform="cuda")
                    same[op] = (a[0].name == "cuda" and a == b and all(
                        torch.equal(u, v)
                        for u, v in zip(call(tuned), call(untuned))))
                out["auto"][name] = same
            out["auto_measured"] = len(measured)
            out["auto_wrote_cache"] = cache.exists()
            if measured or cache.exists() or not all(
                    all(v.values()) for v in out["auto"].values()):
                fail.append(f"autotune under auto: {out}")

            blocked = KernelPolicy(backend="blocked", autotune=True)

            def resolve_all():
                return {f"{op}@{name}": dispatch.resolve_tiles(
                    op, blocked, metric="l2sq", n=n, m=m, d=d,
                    platform="cuda")[1:]
                    for name, (n, m, d) in TUNE_SHAPES.items()
                    for op in dispatch.OPS}

            t0 = time.perf_counter()
            first = resolve_all()
            out["blocked_tune_s"] = time.perf_counter() - t0
            out["blocked_measured"] = len(measured)
            entries = json.loads(cache.read_text())
            dispatch.clear_autotune_cache()
            again = resolve_all()
            out["blocked"] = {"tiles": {k: list(v) for k, v in first.items()},
                              "cache_hit_same_tiles": again == first,
                              "measured_on_second": len(measured)
                              - out["blocked_measured"],
                              "candidates_us": {k: e["timings_us"]
                                                for k, e in entries.items()}}
            if not (out["blocked_measured"] > 0 and again == first
                    and out["blocked"]["measured_on_second"] == 0
                    and len(entries) == 2 * len(dispatch.OPS)):
                fail.append(f"autotune under blocked: {out['blocked']}")
        finally:
            dispatch.measure_block_ns, dispatch.measure_tiles = real
            if prev is None:
                os.environ.pop("REPRO_TORCH_KERNELS_CACHE", None)
            else:
                os.environ["REPRO_TORCH_KERNELS_CACHE"] = prev
            dispatch.clear_autotune_cache()
    return out


def repro_torch_cli(*args, module="repro_torch"):
    """``python -m MODULE ARGS`` (default: ``repro_torch``) in its own
    process from the root of the checkout: (the finished process, its
    stdout's lines)."""
    import os
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(root / "src"), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    return proc, proc.stdout.strip().splitlines()


def session_cli(fail):
    """``python -m repro_torch`` on the three example artifacts, each in its
    own process on the card; each must exit 0 with ``ok`` last."""
    out = []
    for cmd, artifact in CLI_RUNS:
        t0 = time.perf_counter()
        proc, lines = repro_torch_cli(cmd, "--config", artifact)
        for line in lines:
            log(f"cli {cmd} {artifact} |", line)
        rec = {"cmd": cmd, "config": artifact, "rc": proc.returncode,
               "s": time.perf_counter() - t0,
               "ok": proc.returncode == 0 and bool(lines)
               and lines[-1] == "ok"}
        out.append(rec)
        if not rec["ok"]:
            log(f"cli {cmd} {artifact} stderr |", proc.stderr[-4000:])
            fail.append(f"python -m repro_torch {cmd} --config {artifact}: "
                        f"rc {proc.returncode}")
    return out


def session_phase(dev, counted, kdd_np, kdd_truth, kdd_x, resident):
    """The "session" phase (see the module docstring).  Raises on any
    failure, after every part has run."""
    import tempfile
    t_phase = time.perf_counter()
    fail = []
    cfg = kdd_pipeline(kdd_truth, None)
    direct = session_direct(dev, kdd_x, cfg)
    out = {"config": cfg.to_dict()}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-session-") as tmp:
        out["oneshot"] = counted(
            "session_kdd", ("min_argmin", "lloyd_step", "score"),
            lambda: session_oneshot(dev, kdd_np, kdd_truth, cfg, direct,
                                    Path(tmp), fail))
    log("session oneshot", json.dumps(out["oneshot"]))
    out["stream"] = counted(
        "session_stream", ("min_argmin", "lloyd_step", "score"),
        lambda: session_stream(dev, resident, fail))
    log("session stream", json.dumps(out["stream"]))
    out["autotune"] = session_autotune(dev, fail)
    log("session autotune", json.dumps(out["autotune"]))
    out["cli"] = session_cli(fail)
    log("session cli", json.dumps(out["cli"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"session_s {out['phase_s']:.2f}")
    if fail:
        raise AssertionError(f"session phase: {fail}")
    return out


# ----------------------------------------------------- serving phase
# The async serving scheduler under concurrent clients, with the telemetry
# plane on and off: the card's counterpart of benchmarks/serving_bench.py
# --mode full, at the stream deployment's size (its 1M gauss rows).  Every
# scheduler tick runs StreamService.drain on the worker thread, so each one
# launches the score kernel from that thread.
SERVING = dict(queue_bound=512, batch_window_ms=1.0, shed_policy="shed",
               refresh_every=250_000, window=500_000, queries=4_096,
               query_seed=7, bitwise_rows=1_024, clients=16, rung_s=2.0,
               ladder=(0.25, 0.5, 1.0, 2.0, 4.0), capacity_s=0.5,
               quota=256)
# serve's load phase must shed, or its snapshot lacks the ``serve.shed{``
# series that ``--require-set serving`` demands.  Its default offer, 1.5x a
# closed-loop capacity estimate, can fall below what the scheduler sustains
# open-loop (it batches more there), and then nothing is shed; so the offer
# is fixed far above any rate this path reaches.
SERVING_CLI = (
    ("stats", "examples/oneshot.json", ("--out", "{dir}/stats.json")),
    ("serve", "examples/stream.toml",
     ("--clients", "4", "--load-seconds", "1", "--offered-rps", "1000000",
      "--metrics-interval", "0",
      "--metrics-out", "{dir}/metrics.jsonl", "--trace-out",
      "{dir}/serve_trace.json")),
)


def _check_file(script, *args):
    """One of the repo's stdlib validators (``benchmarks/``) on a file, in
    its own process: (exit code, its output)."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, str(root / "benchmarks" / script),
         *map(str, args)], cwd=root, capture_output=True, text=True,
        timeout=120)
    return proc.returncode, (proc.stdout + proc.stderr).strip()


class _TickTally:
    """Rows and ticks of a scheduler, read around ``_score_batch`` (the
    same with the metrics plane off, where ``serve.ticks`` does not
    count)."""

    def __init__(self, sched):
        self.ticks = self.rows = 0
        inner = sched._score_batch

        def tally(batch):
            self.ticks += 1
            self.rows += len(batch)
            return inner(batch)

        sched._score_batch = tally

    def occupancy(self, max_batch, since):
        ticks, rows = self.ticks - since[0], self.rows - since[1]
        return rows / (ticks * max_batch) if ticks else None


def serving_ladder(sched, queries, tally, sustained, label):
    """The offered-load ladder (16 clients, 2 s a rung): per rung offered
    and completed rows/s, p50 / p99 ms, shed rate, batch occupancy and
    peak queue depth."""
    from repro_torch.serve import run_load
    rungs = []
    for mult in SERVING["ladder"]:
        sched.peak_depth = 0
        since = (tally.ticks, tally.rows)
        rep = run_load(sched, queries, offered_rps=mult * sustained,
                       clients=SERVING["clients"],
                       duration_s=SERVING["rung_s"],
                       seed=int(mult * 100))
        row = {"plane": label, "multiplier": mult,
               "offered_rps": rep["offered_rps"],
               "completed_rps": rep["goodput_rps"],
               "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
               "shed_rate": rep["shed_rate"],
               "batch_occupancy": tally.occupancy(sched.max_batch, since),
               "peak_queue_depth": int(sched.peak_depth),
               "submitted": rep["submitted"], "completed": rep["completed"]}
        log("serving rung", json.dumps(row))
        rungs.append(row)
    return rungs


def serving_concurrent(sess, q):
    """``score_stream`` from 16 client threads at once (a shed row is
    submitted again): the results in row order and the resubmissions."""
    import threading
    from repro_torch.serve import ShedReject
    n = SERVING["bitwise_rows"]
    per = n // SERVING["clients"]
    got = [None] * SERVING["clients"]
    resubmits = [0] * SERVING["clients"]

    def client(i):
        rows = q[i * per:(i + 1) * per]
        out = list(sess.score_stream(rows, timeout=120.0))
        while True:
            shed = [j for j, r in enumerate(out)
                    if isinstance(r, ShedReject)]
            if not shed:
                break
            resubmits[i] += len(shed)
            again = list(sess.score_stream(rows[shed], timeout=120.0))
            for j, r in zip(shed, again):
                out[j] = r
        got[i] = out

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVING["clients"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300.0)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a serving client did not finish in 300 s")
    return [r for rs in got for r in rs], sum(resubmits)


def serving_bitwise(sess, q, dev, want, conc, resubmits, checks, fail):
    """The concurrent results against ``Session.score`` bit for bit, and
    one tick's rows against the score kernel and its plain version."""
    from repro_torch.kernels.score.kernel import score_cuda
    same = len(conc) == len(want) and all(
        (a.center, a.distance, a.outlier_score, a.is_outlier)
        == (b.center, b.distance, b.outlier_score, b.is_outlier)
        for a, b in zip(want, conc))
    # one tick's rows (a padded micro-batch) on the kernel and its plain
    # version, and the scheduler's results for them against the kernel's
    model = sess.model
    mb = sess.engine.cfg.micro_batch
    xb = torch.from_numpy(np.ascontiguousarray(q[:mb])).to(dev)
    rec = check_score(dev, "serving_tick", xb, model.centers,
                      model.threshold, "l2sq", fail)
    log("check", json.dumps(rec))
    checks.append(rec)
    dk, ak, sk = (a.cpu().numpy() for a in score_cuda(
        xb, model.centers, model.threshold, metric="l2sq"))
    tick = all((r.center, r.distance, r.outlier_score)
               == (int(ak[j]), float(dk[j]), float(sk[j]))
               for j, r in enumerate(conc[:mb]))
    out = {"rows": len(want), "clients": SERVING["clients"],
           "resubmitted_after_shed": resubmits,
           "bitwise_vs_session_score": same,
           "tick_equals_kernel_bitwise": tick}
    if not (same and tick):
        fail.append(f"concurrent scores differ: {out}")
    return out


def serving_async_refresh(sess, x, q, fail):
    """Clients scoring through the scheduler while the session ingests and
    an async refresh fits on its worker thread: every row resolves, and
    the refresh installs."""
    import threading
    from repro_torch.serve import ShedReject
    stop = threading.Event()
    seen = [[0, 0] for _ in range(SERVING["clients"])]
    errors = []

    def client(i):
        rows = q[i * 64:(i + 1) * 64]
        try:
            while not stop.is_set():
                for r in sess.score_stream(rows, timeout=120.0):
                    seen[i][isinstance(r, ShedReject)] += 1
                time.sleep(0.001)   # a client that was shed backs off
        except Exception as e:   # reported below, on the main thread
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVING["clients"])]
    for th in threads:
        th.start()
    sess.ingest(x[:8_192])
    v0 = int(sess.model.version)
    t0 = time.perf_counter()
    sess.refresh(blocking=False)
    # the worker's next drain installs the fit (poll_refresh, under the
    # scheduler's engine lock)
    while sess.engine.refresh_in_flight and time.perf_counter() - t0 < 120:
        time.sleep(0.01)
    stop.set()
    for th in threads:
        th.join(timeout=300.0)
    out = {"version_before": v0, "version_after": int(sess.model.version),
           "refresh_s": time.perf_counter() - t0,
           "rows_scored": sum(s[0] for s in seen),
           "rows_shed": sum(s[1] for s in seen), "errors": errors,
           "clients_done": not any(th.is_alive() for th in threads)}
    if errors or not out["clients_done"] or \
            out["version_after"] != v0 + 1 or not out["rows_scored"]:
        fail.append(f"scoring under an async refresh: {out}")
    return out


def serving_cli(tmp, fail):
    """``python -m repro_torch stats`` and ``serve --clients ...
    --metrics-interval 0 --metrics-out F --trace-out F`` in their own
    processes on the card; what they write must pass the validators."""
    out = []
    for cmd, artifact, extra in SERVING_CLI:
        t0 = time.perf_counter()
        proc, lines = repro_torch_cli(cmd, "--config", artifact,
                                      *[a.format(dir=tmp) for a in extra])
        for line in lines[-12:]:
            log(f"cli {cmd} {artifact} |", line)
        rec = {"cmd": cmd, "config": artifact, "rc": proc.returncode,
               "s": time.perf_counter() - t0}
        if cmd == "stats":
            # the reference's stats prints where it wrote, not "ok"
            rec["ok"] = proc.returncode == 0 and bool(lines) and \
                lines[-1].startswith("wrote json snapshot")
            rc, msg = _check_file("check_obs_snapshot.py", "--snapshot",
                                  tmp / "stats.json", "--require",
                                  "kernels.dispatch", "--require",
                                  "comm.records", "--require",
                                  "serve.latency")
            rec["snapshot_valid"] = rc == 0
        else:
            rec["ok"] = proc.returncode == 0 and bool(lines) and \
                lines[-1] == "ok"
            metrics = (tmp / "metrics.jsonl").read_text().splitlines() \
                if (tmp / "metrics.jsonl").exists() else []
            rec["metrics_lines"] = len(metrics)
            (tmp / "metrics_last.json").write_text(
                metrics[-1] if metrics else "{}")
            rc, msg = _check_file("check_obs_snapshot.py", "--snapshot",
                                  tmp / "metrics_last.json",
                                  "--require-set", "serving")
            rec["snapshot_valid"] = rc == 0
            rc, tmsg = _check_file("check_trace.py",
                                   tmp / "serve_trace.json", "--require",
                                   "serve.request", "--require",
                                   "score.fused")
            rec["trace_valid"] = rc == 0
            msg += "\n" + tmsg
        log(f"cli {cmd} validators |", msg[-2000:])
        out.append(rec)
        if not (rec["ok"] and rec["snapshot_valid"]
                and rec.get("trace_valid", True)):
            log(f"cli {cmd} {artifact} stderr |", proc.stderr[-4000:])
            fail.append(f"python -m repro_torch {cmd}: {rec}")
    return out


def serving_phase(dev, counted, x, checks):
    """The "serving" phase (see the module docstring).  Raises on any
    failure, after every part has run."""
    import tempfile
    from repro_torch import obs
    from repro_torch.api import Session, pipeline_config
    from repro_torch.serve import (ServingScheduler, ServingSpec,
                                   estimate_capacity, run_load)
    t_phase = time.perf_counter()
    fail = []
    spec = ServingSpec(queue_bound=SERVING["queue_bound"],
                       batch_window_ms=SERVING["batch_window_ms"],
                       shed_policy=SERVING["shed_policy"])
    cfg = pipeline_config(
        dim=STREAM["d"], k=STREAM["k"], t=STREAM["t"], topology="stream",
        leaf_size=STREAM["leaf_size"], refresh_every=SERVING["refresh_every"],
        micro_batch=MICRO_BATCH, window=SERVING["window"], serving=spec,
        seed=STREAM["seed"])
    rng = np.random.default_rng(SERVING["query_seed"])
    q = x[rng.integers(0, x.shape[0], SERVING["queries"])]
    out = {"config": cfg.to_dict()}
    with obs.using_registry(obs.MetricsRegistry()) as reg, \
            tempfile.TemporaryDirectory(prefix="chip-smoke-serving-") as tmp:
        tmp = Path(tmp)
        sess = Session(cfg, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        counted("serving_fit", ("min_argmin", "lloyd_step"),
                lambda: sess.fit(x))
        sync(dev)
        out["fit_s"] = time.perf_counter() - t0
        want = sess.score(q[:SERVING["bitwise_rows"]])
        conc, resubmits = counted("serving_concurrent", ("score",),
                                  lambda: serving_concurrent(sess, q))
        out["bitwise"] = serving_bitwise(sess, q, dev, want, conc,
                                         resubmits, checks, fail)
        log("serving bitwise", json.dumps(out["bitwise"]))
        out["async_refresh"] = counted(
            "serving_async_refresh", ("score", "min_argmin", "lloyd_step"),
            lambda: serving_async_refresh(sess, x, q, fail))
        log("serving async_refresh", json.dumps(out["async_refresh"]))

        sched = sess.serve()
        tally = _TickTally(sched)
        capacity = estimate_capacity(sched, q,
                                     duration_s=SERVING["capacity_s"])
        probe = run_load(sched, q, offered_rps=capacity,
                         clients=SERVING["clients"],
                         duration_s=SERVING["capacity_s"], seed=17)
        sustained = max(probe["goodput_rps"], 1.0)
        out["capacity_rps_closed_loop"] = capacity
        out["sustained_rps_probe"] = sustained
        log("serving capacity", json.dumps(
            {"closed_loop_rps": capacity, "sustained_rps": sustained}))
        out["ladder_plane_on"] = counted(
            "serving_ladder_plane_on", ("score",),
            lambda: serving_ladder(sched, q, tally, sustained, "on"))
        prev = (obs.set_metrics_enabled(False),
                obs.set_tracing_enabled(False))
        try:
            out["ladder_plane_off"] = counted(
                "serving_ladder_plane_off", ("score",),
                lambda: serving_ladder(sched, q, tally, sustained, "off"))
        finally:
            obs.set_metrics_enabled(prev[0])
            obs.set_tracing_enabled(prev[1])

        # two tenants at 2x the sustained rate under a half-queue quota
        fair_spec = ServingSpec(queue_bound=SERVING["queue_bound"],
                                tenant_quota=SERVING["quota"],
                                batch_window_ms=SERVING["batch_window_ms"],
                                shed_policy="shed")
        sess.close()     # one scheduler on the engine at a time
        with ServingScheduler(sess.engine, fair_spec) as fair:
            rep = run_load(fair, q, offered_rps=2.0 * sustained,
                           clients=SERVING["clients"],
                           duration_s=SERVING["rung_s"],
                           tenants=("tenant-a", "tenant-b"), seed=31)
        done = [v["completed"] for v in rep["per_tenant"].values()]
        rep["completed_min_max_ratio"] = (min(done) / max(done)
                                          if done and max(done) else 0.0)
        out["fairness"] = rep
        log("serving fairness", json.dumps(rep))

        snap_path, trace_path = tmp / "snapshot.json", tmp / "trace.json"
        snap_path.write_text(json.dumps(sess.stats()))
        sess.dump_trace(trace_path)
        rc, msg = _check_file("check_obs_snapshot.py", "--snapshot",
                              snap_path, "--require-set", "serving")
        log("serving snapshot |", msg[-2000:])
        out["snapshot_valid"] = rc == 0
        rc, msg = _check_file("check_trace.py", trace_path, "--require",
                              "score.fused", "--require", "serve.request")
        log("serving trace |", msg[-2000:])
        out["trace_valid"] = rc == 0
        out["trace"] = reg.recorder.snapshot_section()
        if not (out["snapshot_valid"] and out["trace_valid"]):
            fail.append("the serving snapshot or trace did not validate")
        out["cli"] = serving_cli(tmp, fail)
        log("serving cli", json.dumps(out["cli"]))
    for rung in out["ladder_plane_on"] + out["ladder_plane_off"]:
        if rung["completed"] <= 0 or rung["p99_ms"] is None:
            fail.append(f"a ladder rung completed nothing: {rung}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving_s {out['phase_s']:.2f}")
    if fail:
        raise AssertionError(f"serving phase: {fail}")
    return out


# ----------------------------------------------------- sharded phase
# The one round of communication as a torch.distributed collective.  The
# card is one H100, and NCCL refuses two ranks on one device, so the
# multi-rank runs are gloo groups whose ranks share the card (each gather
# staged through host memory: these are no NVLink numbers); NCCL runs with
# one rank.  Ranks are spawned processes of this script, started after the
# kernels are built; each writes its result and launch counts to a file.
SHARDED = dict(sites=20, stream_sites=4, collective_ranks=4, seed=0,
               timeout_s=600)
# the result fields every rank must agree on
DIST_FIELDS = ("centers", "outlier_ids", "summary_ids", "summary_weights",
               "comm_records", "cost")


def _kernel_objects():
    from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
    from repro_torch.kernels.pdist.kernel import min_argmin_cuda
    from repro_torch.kernels.score.kernel import score_cuda
    from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
    return (min_argmin_cuda, lloyd_step_cuda, score_cuda, wkv_forward_cuda)


def _count(kernels, fn):
    """(fn(), launches per kernel while it ran): counters at 0 before."""
    for kern in kernels:
        kern.launches = 0
    out = fn()
    return out, {k.name: k.launches for k in kernels}


def _rank_entry(rank, n, workdir, device, fn, args):
    """One rank: join the group of ``n`` ranks (gloo: they share one
    device), run ``fn(rank, n, workdir, device, *args)``, write its result
    to ``workdir``."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.core.collective import init_sites
    init_sites(rank, [device] * n, init_method=f"file://{workdir}/store",
               timeout=timedelta(seconds=SHARDED["timeout_s"]))
    try:
        out = fn(rank, n, workdir, torch.device(device), *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(workdir) / f"rank{rank:03d}.pt")


def spawn_ranks(fn, n, workdir, device, *args):
    """``fn`` in ``n`` spawned rank processes; returns (every rank's result
    in rank order, wall seconds).  A rank that raises fails the call, after
    the others are stopped."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.start_processes(_rank_entry, args=(n, str(workdir), str(device), fn,
                                          args),
                       nprocs=n, join=True, start_method="spawn")
    outs = [torch.load(Path(workdir) / f"rank{r:03d}.pt", weights_only=False)
            for r in range(n)]
    return outs, time.perf_counter() - t0


def _digest(arrays: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode() + str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def sharded_kdd_pipeline(n_sites, t):
    from repro_torch.api import pipeline_config
    return pipeline_config(dim=KDD["d"], k=KDD["k"], t=t, sites=n_sites,
                           use_shard_map=True, seed=SHARDED["seed"],
                           second_iters=KDD["second_iters"])


def sharded_oneshot_rank(rank, n, workdir, dev, t):
    """Rank ``rank`` of the one-shot collective: ``distributed_cluster``
    directly on the memmapped rows (this rank reads its block), then
    ``Session.fit`` of the same config; their launches and digests."""
    from repro_torch.api import Session
    from repro_torch.core.distributed import distributed_cluster
    from repro_torch.core.sampler import TorchSampler
    kernels = _kernel_objects()
    x = np.load(Path(workdir) / "x.npy", mmap_mode="r")
    cfg = sharded_kdd_pipeline(n, t)

    def direct():
        sync(dev)
        t0 = time.perf_counter()
        res = distributed_cluster(
            x.reshape(n, -1, x.shape[1]), TorchSampler(cfg.seed), k=KDD["k"],
            t=t, summarizer=cfg.summarizer, second_iters=cfg.second_iters,
            policy=cfg.kernels, device=dev)
        sync(dev)
        return res, time.perf_counter() - t0

    (res, direct_s), direct_launches = _count(kernels, direct)
    arrays = {f: getattr(res, f).cpu().numpy() for f in DIST_FIELDS}

    def session():
        sess = Session(cfg, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        sess.fit(x)
        sync(dev)
        return sess, time.perf_counter() - t0

    (sess, session_s), session_launches = _count(kernels, session)
    sid, out = arrays["summary_ids"], arrays["outlier_ids"]
    keep = sid >= 0
    want = {"centers": arrays["centers"], "outlier_ids": out[out >= 0],
            "summary_ids": sid[keep],
            "summary_weights": arrays["summary_weights"][keep],
            "comm_records": float(arrays["comm_records"]),
            "cost": float(arrays["cost"])}
    got = sess.result
    session_equal = {k: bool(np.array_equal(np.asarray(got[k]),
                                            np.asarray(want[k])))
                     for k in want}
    return {"rank": rank, "digest": _digest(arrays),
            "arrays": arrays if rank == 0 else None,
            "phase_s": res.phase_s, "direct_s": direct_s,
            "session_s": session_s, "session_equal": session_equal,
            "launches": {"direct": direct_launches,
                         "session": session_launches}}


def compose_sites(x_parts, sampler, *, k, t, summarizer, second_iters,
                  policy, dev):
    """``distributed_cluster``'s computation in this process with no group:
    each site's ``_site_summarizer`` call with ``fold_in(i)``, concatenated
    in site order, then ``_second_level``."""
    from repro_torch.core.distributed import (_second_level,
                                              _site_summarizer,
                                              local_budget)
    s, n_per = len(x_parts), x_parts[0].shape[0]
    summarize = _site_summarizer(summarizer, "augmented", metric="l2sq",
                                 k=k, t=local_budget(t, s, "random"))
    pts, wts, val, gid = [], [], [], []
    for i, xi in enumerate(x_parts):
        summ = summarize(xi, sampler.fold_in(i), policy=policy)
        pts.append(summ.points)
        wts.append(summ.weights)
        val.append(summ.valid)
        gid.append(torch.where(summ.valid, summ.indices + i * n_per, -1))
    pts, wts, val, gid = (torch.cat(a) for a in (pts, wts, val, gid))
    sol, out_ids, _ = _second_level(pts, wts, val, gid,
                                    sampler.fold_in(2**31 - 1), k=k, t=t,
                                    iters=second_iters, metric="l2sq",
                                    policy=policy)
    return {"centers": sol.centers, "outlier_ids": out_ids,
            "summary_ids": gid, "summary_weights": wts,
            "comm_records": val.sum().to(torch.float32), "cost": sol.cost}


def _as_numpy(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def dist_invariants(arrays, n_sites, n_per, fail, label):
    """The paper's invariants on a ``distributed_cluster`` result: per-site
    mass = n_per, ids unique, outlier ids a subset of the summary ids,
    ``comm_records`` = the valid gathered records."""
    sid, w = arrays["summary_ids"], arrays["summary_weights"]
    out = arrays["outlier_ids"]
    valid = sid >= 0
    mass = w.reshape(n_sites, -1).sum(1)
    checks = {
        "site_mass_is_n_per": bool((mass == n_per).all()),
        "ids_unique": bool(np.unique(sid[valid]).size == valid.sum()),
        "ids_in_their_site": bool(
            ((sid.reshape(n_sites, -1) // n_per
              == np.arange(n_sites)[:, None]) | ~valid.reshape(
                  n_sites, -1)).all()),
        "outliers_subset_of_summary": bool(
            np.isin(out[out >= 0], sid[valid]).all()),
        "comm_records_is_valid_records": float(arrays["comm_records"])
        == float(valid.sum()),
        "finite_centers": bool(np.isfinite(arrays["centers"]).all()),
    }
    if not all(checks.values()):
        fail.append(f"{label}: invariants {checks}")
    return checks


def sharded_oneshot(dev, kdd_np, kdd_x, kdd_truth, kdd_out, tmp, fail):
    """(a): the one-shot collective at the paper's size on gloo ranks that
    share the card, against its in-process composition."""
    from repro_torch.core.metrics import outlier_scores
    from repro_torch.core.sampler import TorchSampler
    s = SHARDED["sites"]
    n = (kdd_x.shape[0] // s) * s
    n_per = n // s
    truth = kdd_truth[kdd_truth < n]
    t = len(kdd_truth)
    np.save(tmp / "x.npy", kdd_np[:n])
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # the ranks' contexts share the card
    ranks, wall = spawn_ranks(sharded_oneshot_rank, s, tmp, dev, t)
    cfg = sharded_kdd_pipeline(s, t)
    sync(dev)
    t0 = time.perf_counter()
    want = _as_numpy(compose_sites(
        torch.tensor_split(kdd_x[:n], s), TorchSampler(cfg.seed),
        k=KDD["k"], t=t, summarizer=cfg.summarizer,
        second_iters=cfg.second_iters, policy=cfg.kernels, dev=dev))
    sync(dev)
    compose_s = time.perf_counter() - t0
    got = ranks[0]["arrays"]
    out = {
        "n": n, "dropped_rows": kdd_x.shape[0] - n, "sites": s,
        "n_per": n_per, "k": KDD["k"], "t": t, "backend": "gloo",
        "ranks_wall_s": wall, "compose_in_process_s": compose_s,
        "all_ranks_equal": len({r["digest"] for r in ranks}) == 1,
        "rank0_equals_composition": _digest(got) == _digest(want),
        "session_equals_direct": all(all(r["session_equal"].values())
                                     for r in ranks),
        "rank_phase_s_max": {p: max(r["phase_s"][p] for r in ranks)
                             for p in ranks[0]["phase_s"]},
        "rank0_phase_s": ranks[0]["phase_s"],
        "direct_s_max": max(r["direct_s"] for r in ranks),
        "session_s_max": max(r["session_s"] for r in ranks),
        "launches_per_rank": {
            run: {name: [r["launches"][run][name] for r in ranks]
                  for name in ("min_argmin", "lloyd_step", "score")}
            for run in ("direct", "session")},
    }
    out["invariants"] = dist_invariants(got, s, n_per, fail, "sharded kdd")
    sid, oid = got["summary_ids"], got["outlier_ids"]
    sc = outlier_scores(truth, sid[sid >= 0], oid[oid >= 0])
    out["quality"] = {"preRec": sc.pre_recall, "prec": sc.precision,
                      "recall": sc.recall,
                      "comm_records": float(got["comm_records"]),
                      "gathered_rows": int(sid.size),
                      "simulate_coordinator": {
                          k: kdd_out[k] for k in ("preRec", "prec", "recall",
                                                  "comm_records")}}
    for key in ("all_ranks_equal", "rank0_equals_composition",
                "session_equals_direct"):
        if not out[key]:
            fail.append(f"sharded kdd: {key} is false")
    for run, counts in out["launches_per_rank"].items():
        for name in ("min_argmin", "lloyd_step"):
            if min(counts[name]) <= 0:
                fail.append(f"sharded kdd: {name} not launched in every "
                            f"rank's {run} run: {counts[name]}")
    if not (sc.pre_recall > 0.5 and sc.recall > 0.5):
        fail.append(f"sharded kdd: implausible quality {out['quality']}")
    launches = {name: sum(r["launches"][run][name] for r in ranks
                          for run in ("direct", "session"))
                for name in ranks[0]["launches"]["direct"]}
    return out, launches


def sharded_nccl(dev, gauss_x, gauss_truth, counted, tmp, fail):
    """(b): one rank on NCCL (the only NCCL group one card can hold) on
    gauss-0.1 at the paper's size, bit for bit the composition."""
    import torch.distributed as dist
    from repro_torch.core.collective import init_sites
    from repro_torch.core.distributed import distributed_cluster
    from repro_torch.core.metrics import outlier_scores
    from repro_torch.core.sampler import TorchSampler
    kw = dict(k=GAUSS["k"], t=GAUSS["t"], second_iters=GAUSS["second_iters"])
    init_sites(0, [str(dev)], init_method=f"file://{tmp}/nccl_store")
    try:
        backend = dist.get_backend()
        sync(dev)
        t0 = time.perf_counter()
        res = counted("sharded_nccl", ("min_argmin", "lloyd_step"),
                      lambda: distributed_cluster(
                          gauss_x[None], TorchSampler(GAUSS["seed"]), **kw,
                          device=dev))
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    got = _as_numpy({f: getattr(res, f) for f in DIST_FIELDS})
    want = _as_numpy(compose_sites([gauss_x], TorchSampler(GAUSS["seed"]),
                                   summarizer=None, policy=None, dev=dev,
                                   **kw))
    sid, oid = got["summary_ids"], got["outlier_ids"]
    sc = outlier_scores(gauss_truth, sid[sid >= 0], oid[oid >= 0])
    out = {"n": int(gauss_x.shape[0]), "sites": 1, "backend": backend,
           "wall_s": wall, "phase_s": res.phase_s,
           "equals_composition": _digest(got) == _digest(want),
           "comm_records": float(got["comm_records"]),
           "preRec": sc.pre_recall, "prec": sc.precision,
           "recall": sc.recall}
    out["invariants"] = dist_invariants(got, 1, gauss_x.shape[0], fail,
                                        "sharded nccl")
    if dev.type == "cuda" and backend != "nccl":
        fail.append(f"sharded nccl: the group's backend is {backend}")
    if not out["equals_composition"]:
        fail.append("sharded nccl: the result differs from the composition")
    return out


def sharded_stream_config(n, t, policy, n_sites, **over):
    """``stream_config``'s deployment over ``n_sites`` sites, each at the
    paper's budget 2t/s (what ``stream_bench.py::run_sharded`` sets)."""
    from repro_torch.stream import ShardedServiceConfig
    base = stream_config(n, t, policy)
    return ShardedServiceConfig(
        dim=base.dim, k=base.k, t=t, leaf_size=base.leaf_size,
        refresh_every=base.refresh_every, micro_batch=base.micro_batch,
        window=base.window, policy=policy, seed=base.seed, n_sites=n_sites,
        site_budget="paper", **over)


def _site_window_checks(svc, fail, label):
    """Per site: mass = the unit rows its live nodes and buffer span
    (1e-6), within the site's window plus one merge span and one leaf;
    every node within ``record_cap``."""
    from repro_torch.stream import record_cap
    out = []
    for i, tree in enumerate(svc.trees):
        rows = sum(nd.count for nd in tree.nodes) + tree._buf_n
        mass = tree.total_weight
        w = tree.cfg.window
        bound = w + w // 4 + tree.cfg.leaf_size
        cap = record_cap(tree.cfg)
        top = max(nd.n_records for nd in tree.nodes)
        out.append({"rows": rows, "mass": mass, "nodes": len(tree.nodes),
                    "max_node_records": top, "record_cap": cap})
        if not (abs(mass - rows) <= 1e-6 * rows and rows <= bound
                and top <= cap):
            fail.append(f"{label} site {i}: mass/window/cap {out[-1]} "
                        f"(bound {bound})")
    return out


def _comm_checks(svc, fail, label):
    st = svc.last_refresh
    d = svc.cfg.dim
    ok = (st.payload_bytes == st.root_rows * (4 * d + 4 + 1)
          and st.comm_bytes == st.payload_bytes * svc.cfg.n_sites
          and st.comm_records == sum(st.per_site_records)
          and st.root_rows >= max(st.per_site_records))
    if not ok:
        fail.append(f"{label}: refresh accounting {st}")
    return st._asdict()


def sharded_stream_main(dev, x, truth, tmp, fail):
    """(c): the 1M deployment through ``ShardedStreamService`` (host-sim),
    all-resident and tiered, with its checks, then through
    ``Session(topology="sharded")``."""
    from repro_torch.api import Session, pipeline_config
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.store import StoreSpec
    from repro_torch.stream import ShardedStreamService
    auto, s = KernelPolicy(), SHARDED["stream_sites"]
    n, t = x.shape[0], STREAM["t"]
    cfg = sharded_stream_config(n, t, auto, s)
    resident = ShardedStreamService(cfg, device=dev)
    wall_res, fits_res = stream_ingest(resident, x)
    spec = StoreSpec(hot_levels=1, directory=str(tmp / "spill"))
    tiered = ShardedStreamService(sharded_stream_config(n, t, auto, s,
                                                        store=spec),
                                  device=dev)
    wall_tier, fits_tier = stream_ingest(tiered, x)
    out = {"n": n, "sites": s, "t": t, "site_t": cfg.site_t(),
           "site_window": cfg.site_tree_config().window,
           "ingest_points_per_s": {"resident": n / wall_res,
                                   "tiered": n / wall_tier},
           "cadence_fit_s": {"resident": [f for _, f in fits_res.values()],
                             "tiered": [f for _, f in fits_tier.values()]},
           "refresh": _comm_checks(resident, fail, "sharded stream")}
    same = [all(np.array_equal(a, b) for a, b in
                zip(r.packed_root(), q.packed_root()))
            for r, q in zip(resident.trees, tiered.trees)]
    out["roots_bitwise_equal_per_site"] = same
    if not all(same):
        fail.append(f"sharded stream: tiered roots differ {same}")
    stores = [tr.store.stats() for tr in tiered.trees]
    out["store"] = {k: sum(st[k] for st in stores) for k in stores[0]}
    if not all(st["spills"] >= 1 and st["page_ins"] >= 1 for st in stores):
        fail.append(f"sharded stream: a site's tier never moved: {stores}")
    out["sites_window"] = _site_window_checks(tiered, fail, "sharded stream")
    q_res = x[np.random.default_rng(7).choice(n, MICRO_BATCH)]
    drain_res = resident.score(q_res)

    # serving: 224 rows live in every site's window + 32 planted
    lo = max(min(nd.min_seq for nd in tr.nodes) * s + i
             for i, tr in enumerate(tiered.trees))
    in_window = np.arange(lo, n)
    planted = np.intersect1d(truth, in_window)
    clean = np.setdiff1d(in_window, truth)
    rng = np.random.default_rng(3)
    lat, hits = [], np.zeros(2, np.int64)
    for _ in range(SERVE_BATCHES):
        rows = np.concatenate([
            rng.choice(planted, STREAM["planted"]),
            rng.choice(clean, MICRO_BATCH - STREAM["planted"])])
        t0 = time.perf_counter()
        tiered.submit(x[rows])
        res = tiered.drain()
        lat.append(time.perf_counter() - t0)
        flags = np.array([r.is_outlier for r in res])
        hits += [flags[:STREAM["planted"]].sum(),
                 flags[STREAM["planted"]:].sum()]
        if len(res) != MICRO_BATCH:
            fail.append("sharded stream: a drained micro-batch is short")
            break
    lat_ms = np.asarray(lat) * 1e3
    out["serve"] = {
        "batches": len(lat),
        "batch_p50_ms": float(np.percentile(lat_ms, 50)),
        "batch_p99_ms": float(np.percentile(lat_ms, 99)),
        "outlier_rate_planted": float(hits[0]) / (len(lat) *
                                                  STREAM["planted"]),
        "outlier_rate_clean": float(hits[1]) / (
            len(lat) * (MICRO_BATCH - STREAM["planted"]))}

    # checkpoint: the restored service scores, ingests and refits as the
    # saved one, bit for bit
    q = x[rows]
    before = tiered.score(q)
    t0 = time.perf_counter()
    tiered.save(CheckpointManager(tmp / "ckpt"), step=1)
    out["checkpoint_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ShardedStreamService.restore(tiered.cfg,
                                            CheckpointManager(tmp / "ckpt"),
                                            device=dev)
    out["checkpoint_restore_s"] = time.perf_counter() - t0
    out["restored_scores_bitwise"] = _same_results(restored.score(q), before)
    for svc in (tiered, restored):
        svc.ingest(x[:STREAM["extra"]])
    same = [all(np.array_equal(a, b) for a, b in
                zip(p.packed_root(), r.packed_root()))
            for p, r in zip(tiered.trees, restored.trees)]
    same.append(_same_models(tiered.refresh(), restored.refresh()))
    out["restored_continues_bitwise"] = all(same)
    if not (out["restored_scores_bitwise"]
            and out["restored_continues_bitwise"]):
        fail.append(f"sharded stream: the restored service parted: "
                    f"{out['restored_scores_bitwise']}, {same}")
    for svc in (tiered, restored):
        for tr in svc.trees:
            tr.store.close()    # no spill write outlives the directory

    # the front door: the same deployment through Session
    pcfg = pipeline_config(
        dim=cfg.dim, k=cfg.k, t=t, topology="sharded", sites=s,
        site_budget="paper", leaf_size=cfg.leaf_size,
        refresh_every=cfg.refresh_every, micro_batch=cfg.micro_batch,
        window=cfg.window, seed=cfg.seed)
    sess = Session(pcfg, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(0, n, STREAM["batch"]):
        sess.ingest(x[i:i + STREAM["batch"]])
    sync(dev)
    wall_sess = time.perf_counter() - t0
    out["session"] = {
        "ingest_points_per_s": n / wall_sess,
        "model_bitwise": _same_models(sess.model, resident.model),
        "drain_bitwise": _same_results(sess.score(q_res), drain_res)}
    if not (out["session"]["model_bitwise"]
            and out["session"]["drain_bitwise"]):
        fail.append(f"sharded stream: Session differs from the service "
                    f"{out['session']}")
    return out


def sharded_collective_rank(rank, n, workdir, dev, t):
    """Rank ``rank`` of the collective refresh: the grid stream through a
    ``use_shard_map`` service; its model, drain and launches."""
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.stream import ShardedStreamService
    kernels = _kernel_objects()
    x = np.load(Path(workdir) / "grid.npy")
    q = np.load(Path(workdir) / "q.npy")
    svc = ShardedStreamService(sharded_stream_config(
        x.shape[0], t, KernelPolicy(), n, use_shard_map=True), device=dev)

    def ingest():
        wall, _ = stream_ingest(svc, x)
        return svc.refresh(), wall

    (model, wall), fit_launches = _count(kernels, ingest)
    res, drain_launches = _count(kernels, lambda: svc.score(q))
    return {"rank": rank, "path": svc.last_refresh.path,
            "stats": svc.last_refresh._asdict(), "ingest_s": wall,
            "model": {f: getattr(model, f).cpu().numpy()
                      for f in model._fields},
            "drain": [(r.center, r.distance, r.outlier_score) for r in res],
            "launches": {"ingest_refit": fit_launches,
                         "drain": drain_launches}}


def sharded_collective(dev, tmp, fail):
    """(d): the grid stream on 4 gloo ranks with ``use_shard_map=True``,
    against the host-simulated service on the same stream."""
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.stream import ShardedStreamService
    x, far = stream_grid(**STREAM_GRID)
    n, s = x.shape[0], SHARDED["collective_ranks"]
    t = max(n // 100, 40)
    q = np.concatenate([x[far[-32:]], x[-224:]])
    np.save(tmp / "grid.npy", x)
    np.save(tmp / "q.npy", q)
    ranks, wall = spawn_ranks(sharded_collective_rank, s, tmp, dev, t)
    host = ShardedStreamService(sharded_stream_config(
        n, t, KernelPolicy(), s, use_shard_map=True), device=dev)
    stream_ingest(host, x)
    model = host.refresh()
    drain = [(r.center, r.distance, r.outlier_score) for r in host.score(q)]
    out = {"n": n, "t": t, "ranks": s, "backend": "gloo",
           "ranks_wall_s": wall, "host_path": host.last_refresh.path,
           "paths": [r["path"] for r in ranks],
           "refresh": ranks[0]["stats"],
           "rank_ingest_s": [r["ingest_s"] for r in ranks],
           "models_bitwise": [all(np.array_equal(r["model"][f],
                                                 getattr(model, f).cpu()
                                                 .numpy())
                                  for f in model._fields) for r in ranks],
           "drains_bitwise": [r["drain"] == drain for r in ranks],
           "launches_per_rank": [r["launches"] for r in ranks]}
    if out["host_path"] != "host-sim" or set(out["paths"]) != {"shard_map"}:
        fail.append(f"sharded collective: paths {out['host_path']}, "
                    f"{out['paths']}")
    if not (all(out["models_bitwise"]) and all(out["drains_bitwise"])):
        fail.append(f"sharded collective: models {out['models_bitwise']}, "
                    f"drains {out['drains_bitwise']}")
    for r in ranks:
        lf, ld = r["launches"]["ingest_refit"], r["launches"]["drain"]
        if not (lf["min_argmin"] > 0 and lf["lloyd_step"] > 0
                and ld["score"] > 0):
            fail.append(f"sharded collective rank {r['rank']}: a kernel "
                        f"was not launched: {r['launches']}")
    launches = {name: sum(r["launches"][run][name] for r in ranks
                          for run in ("ingest_refit", "drain"))
                for name in ranks[0]["launches"]["drain"]}
    return out, launches


def sharded_phase(dev, counted, kdd_np, kdd_x, kdd_truth, kdd_out, gauss_x,
                  gauss_truth):
    """The "sharded" phase (see the module docstring): (a) to (d).  Raises
    on any failure, after every part has run.  Returns (report, launches of
    the rank processes per run label)."""
    import tempfile
    from repro_torch.data.synthetic import gauss
    t_phase = time.perf_counter()
    fail, out, rank_launches = [], {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sharded-") as tmp:
        tmp = Path(tmp)
        (tmp / "a").mkdir()
        out["oneshot"], rank_launches["sharded_kdd_ranks"] = \
            sharded_oneshot(dev, kdd_np, kdd_x, kdd_truth, kdd_out,
                            tmp / "a", fail)
        log("sharded oneshot", json.dumps(out["oneshot"]))
        out["nccl"] = sharded_nccl(dev, gauss_x, gauss_truth, counted, tmp,
                                   fail)
        log("sharded nccl", json.dumps(out["nccl"]))
        x, truth = gauss(n_centers=STREAM["n_centers"],
                         per_center=STREAM["per_center"], d=STREAM["d"],
                         sigma=STREAM["sigma"], t=STREAM["t"],
                         seed=STREAM["seed"])
        (tmp / "c").mkdir()
        out["stream"] = counted(
            "sharded_stream", ("min_argmin", "lloyd_step", "score"),
            lambda: sharded_stream_main(dev, x, truth, tmp / "c", fail))
        log("sharded stream", json.dumps(out["stream"]))
        (tmp / "d").mkdir()
        out["collective"], rank_launches["sharded_collective_ranks"] = \
            sharded_collective(dev, tmp / "d", fail)
        log("sharded collective", json.dumps(out["collective"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded_s {out['phase_s']:.2f}")
    if fail:
        raise AssertionError(f"sharded phase: {fail}")
    return out, rank_launches


# ----------------------------------------------------- rwkv6 serving path
# Tolerances.  The kernel route and the plain chunked route differ only in
# WKV's summation order.  In float32 that leaves ~1e-6 of the output, and
# the full-width model, run in f32 from the same weights (upcast), must
# agree between the routes within RWKV_TOL_F32 = 1e-3 of the logits' and
# state's magnitude (a 1000x margin for the growth of a difference through
# 32 random layers), and decode against teacher forcing within RWKV_TOL =
# 2e-2, the tolerance tests/test_models.py holds it to.  In bf16 every
# activation is rounded, and an ulp of difference in one layer grows through
# the later ones, so the bf16 routes are held to the f32 run as their
# yardstick: each route's distance to the f32 result is its bf16 error; the
# kernel route's may be at most twice the plain route's, and the two routes
# (and decode vs teacher forcing) may differ by at most twice the larger
# bf16 error (two evaluations with independent rounding lie up to the sum
# of their errors apart).  A greedy token may differ only where the two top
# logits are within the tolerance of each other (a near tie); after it the
# two sequences have different contexts.
RWKV_TOL = 2e-2
RWKV_TOL_F32 = 1e-3


def _greedy(serve, model, cache, tok, steps, dev):
    """``steps`` decode steps from ``tok`` (B, 1); returns (tokens (B,
    steps), logits per step, per-step seconds, cache)."""
    toks, logits, lat = [], [], []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        lg, cache = serve(model, cache, tok)
        tok = lg.argmax(-1, keepdim=True)
        sync(dev)
        lat.append(time.perf_counter() - t0)
        toks.append(tok)
        logits.append(lg)
    return torch.cat(toks, 1), logits, lat, cache


def _route(dev, model, cfg, prompts, steps):
    """Prefill on cfg's WKV route and ``steps`` greedy steps: (prefill
    logits, prefill cache, tokens (B, steps + 1), logits of each token)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    lg, cache = make_prefill_step(cfg, device=dev)(model, {"tokens": prompts})
    tok = lg.argmax(-1, keepdim=True)
    toks, lgs, _, _ = _greedy(make_serve_step(cfg, device=dev), model, cache,
                              tok, steps, dev)
    return lg, cache, torch.cat([tok, toks], 1), [lg] + lgs


def _teacher(dev, model, cfg, cache, toks):
    """(decode of token S after prefill(S), last logits of prefill(S + 1));
    S + 1 is no chunk multiple, so that prefill takes the padded plain
    route."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    S = toks.shape[1] - 1
    step, _ = make_serve_step(cfg, device=dev)(
        model, cache, torch.as_tensor(toks[:, S:], device=dev))
    full, _ = make_prefill_step(cfg.replace(wkv_use_pallas=False),
                                device=dev)(
        model, {"tokens": torch.as_tensor(toks, device=dev)})
    return step, full


def _token_verdict(ta, tb, logits_a, tol):
    """(first mismatches, bad): per sequence, the first step where the two
    greedy runs pick different tokens is allowed only on a near tie of run
    a's logits there (gap within ``tol`` of their magnitude)."""
    mism = bad = 0
    for b in range(ta.shape[0]):
        diff = (ta[b] != tb[b]).nonzero().flatten()
        if diff.numel() == 0:
            continue
        i = int(diff[0])
        mism += 1
        lg = logits_a[i][b].double()
        gap = abs(float(lg[ta[b, i]] - lg[tb[b, i]]))
        if gap > tol * max(1.0, float(lg.abs().max())):
            bad += 1
    return mism, bad


def _route_errs(ka, pa, ref=None):
    """Scaled differences of logits and cache leaves between two routes'
    (logits, cache) pairs, and (with ``ref``) of each to the reference."""
    out = {}
    for name in ("logits", "s", "ts_t", "ts_c"):
        pick = (lambda r: r[0]) if name == "logits" else \
            (lambda r, n=name: r[1][n])
        out[name] = {"kernel_vs_plain": _scaled(pick(ka), pick(pa))}
        if ref is not None:
            out[name].update(kernel_vs_f32=_scaled(pick(ka), pick(ref)),
                             plain_vs_f32=_scaled(pick(pa), pick(ref)))
    return out


def rwkv_serving(dev, counted):
    """rwkv6-7b at full width through ``make_prefill_step`` (WKV on the
    kernel) and ``make_serve_step``; then the plain-WKV route and the
    teacher-forcing check, in bf16 and, from the same weights upcast, in
    f32.  Returns the report; raises on a failure."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import init_cache, init_params

    cfg = get_config(RWKV["arch"], smoke=RWKV["smoke"]).replace(
        wkv_use_pallas=True)
    B, S, gen = RWKV["batch"], RWKV["prompt"], RWKV["gen"]
    sync(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, RWKV["seed"], device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    toks = np.random.default_rng(RWKV["seed"]).integers(
        2, cfg.vocab, size=(B, S + 1))
    prompts = torch.as_tensor(toks[:, :S], device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    serve = make_serve_step(cfg, device=dev)
    # warm-up (cuBLAS handles, the kernel's library), outside any count
    prefill(model, {"tokens": prompts[:, :2 * cfg.wkv_chunk]})
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def run_prefill():
        sync(dev)
        t0 = time.perf_counter()
        out = prefill(model, {"tokens": prompts})
        sync(dev)
        return out, time.perf_counter() - t0

    (lg, cache0), prefill_s = counted("rwkv6_7b_prefill", ("wkv_forward",),
                                      run_prefill)
    n_wkv = wkv_forward_cuda.launches
    if n_wkv != cfg.n_layers:
        raise AssertionError(f"prefill launched the WKV kernel {n_wkv} "
                             f"times, expected one per layer "
                             f"({cfg.n_layers})")
    tok0 = lg.argmax(-1, keepdim=True)
    gen_toks, gen_logits, lat, cache = counted(
        "rwkv6_7b_decode", (), lambda: _greedy(serve, model, cache0, tok0,
                                               gen, dev))
    if wkv_forward_cuda.launches != 0:
        raise AssertionError("decode launched the WKV kernel; T == 1 takes "
                             "the plain recurrence")
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None)
    want = init_cache(cfg, B, S + gen, device=dev)
    for name, z in want.items():
        for c in (cache0, cache):
            if c[name].shape != z.shape or c[name].dtype != z.dtype:
                raise AssertionError(f"cache {name}: {tuple(c[name].shape)} "
                                     f"{c[name].dtype}, init_cache gives "
                                     f"{tuple(z.shape)} {z.dtype}")
    if int(cache0["pos"]) != S or int(cache["pos"]) != S + gen:
        raise AssertionError("cache position is wrong")
    finite = all(bool(torch.isfinite(x).all()) for x in [lg, *gen_logits])
    if not finite or lg.shape != (B, cfg.vocab):
        raise AssertionError("prefill/decode logits not finite or malformed")

    # the plain chunked WKV route from the same weights, then teacher
    # forcing, in bf16 ...
    k_ = RWKV["compare_tokens"]
    toks_k = torch.cat([tok0, gen_toks[:, :k_ - 1]], 1)
    lgs_k = [lg] + gen_logits[:k_ - 1]
    cfg_p = cfg.replace(wkv_use_pallas=False)
    wkv_forward_cuda.launches = 0
    lg_p, cache_p, toks_p, _ = _route(dev, model, cfg_p, prompts, k_ - 1)
    if wkv_forward_cuda.launches:
        raise AssertionError("wkv_use_pallas=False launched the kernel")
    tf16 = _teacher(dev, model, cfg, cache0, toks)
    # ... and in f32 from the same weights upcast (the yardstick of bf16
    # rounding); the bf16 model is not used after this
    model.float()
    cfg32 = cfg.replace(dtype="float32")
    r32k = _route(dev, model, cfg32, prompts, k_ - 1)
    r32p = _route(dev, model, cfg32.replace(wkv_use_pallas=False), prompts,
                  k_ - 1)
    tf32 = _teacher(dev, model, cfg32, r32k[1], toks)

    f32 = _route_errs(r32k[:2], r32p[:2])
    f32["teacher_forcing"] = _scaled(*tf32)
    f32["tokens_first_mismatches"], f32["tokens_bad"] = _token_verdict(
        r32k[2], r32p[2], r32k[3], RWKV_TOL_F32)
    bf16 = _route_errs((lg, cache0), (lg_p, cache_p), r32k[:2])
    yard = max(bf16["logits"]["kernel_vs_f32"],
               bf16["logits"]["plain_vs_f32"])
    bf16["teacher_forcing"] = {"decode_vs_prefill": _scaled(*tf16),
                               "decode_vs_f32": _scaled(tf16[0], tf32[1]),
                               "prefill_vs_f32": _scaled(tf16[1], tf32[1])}
    bf16["tokens_first_mismatches"], bf16["tokens_bad"] = _token_verdict(
        toks_k, toks_p, lgs_k, 2 * yard)
    lat_ms = np.asarray(lat) * 1e3
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.d_model // cfg.rwkv_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "dtype": cfg.dtype, "wkv_chunk": cfg.wkv_chunk,
           "params": n_params, "batch": B, "prompt": S, "gen": gen,
           "init_s": init_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": B * S / prefill_s,
           "decode_p50_ms": float(np.percentile(lat_ms, 50)),
           "decode_p99_ms": float(np.percentile(lat_ms, 99)),
           "decode_tokens_per_s": B * gen / float(np.sum(lat)),
           "peak_mem_gb": peak_gb, "wkv_launches_prefill": n_wkv,
           "first_tokens": toks_k[:, :4].tolist(),
           "tokens_compared": k_, "f32": f32, "bf16": bf16,
           "tol_f32": RWKV_TOL_F32, "tol_teacher": RWKV_TOL}
    log("rwkv6_serving", json.dumps(out))

    why = []
    for name in ("logits", "s", "ts_t", "ts_c"):
        if not f32[name]["kernel_vs_plain"] <= RWKV_TOL_F32:
            why.append(f"f32 {name}: kernel vs plain route")
        e = bf16[name]
        if not (e["kernel_vs_plain"] <= 2 * max(e["kernel_vs_f32"],
                                                e["plain_vs_f32"])
                and e["kernel_vs_f32"] <= 2 * e["plain_vs_f32"]):
            why.append(f"bf16 {name}: routes apart beyond their bf16 error")
    if not f32["teacher_forcing"] <= RWKV_TOL:
        why.append("f32 decode vs teacher forcing")
    t = bf16["teacher_forcing"]
    if not t["decode_vs_prefill"] <= 2 * max(t["decode_vs_f32"],
                                             t["prefill_vs_f32"]):
        why.append("bf16 decode vs teacher forcing beyond their bf16 error")
    if f32["tokens_bad"] or bf16["tokens_bad"]:
        why.append("greedy tokens differ off a near tie")
    if why:
        raise AssertionError(f"rwkv6 serving disagrees: {why}")
    return out


# ------------------------------------------------------ rwkv6 training path
# The train cell: rwkv6-7b FULL at full width (bf16, WKV on the kernel,
# remat "nothing", the default AdamWConfig), cut from 32 layers to 8 and
# to batch 4 x seq 1024 of the reference's token pipeline.
TRAIN = dict(arch="rwkv6-7b", layers=8, batch=4, seq=1024, warmup=1,
             steps=6, seed=0)
# (b): full width, 2 layers, batch 2 x seq 256, f32
TRAIN_SMALL = dict(layers=2, batch=2, seq=256, seed=1)
# (c): the cell's bf16 and f32 moments at a narrow width (the WKV kernel's
# head size 64 kept; the full vocabulary), 2 layers, batch 2 x seq 256: a
# resume is bit for bit at any width, and the checkpoint is 0.8 GB, not 9.7
TRAIN_RESUME = dict(layers=2, d_model=512, n_heads=8, d_ff=1792, batch=2,
                    seq=256, seed=1, resume_at=3)
# (d): the launcher at SMOKE size, then resumed
TRAIN_CLI = dict(steps=(6, 8), ckpt_every=3)
# (e): DataCurator on the 8-layer model's mean-pooled last hidden states,
# examples/train_curated_lm.py's recipe (make_batch: 10% of each batch's
# rows uniform noise, t = half that fraction).  The noise rows' precision is
# reported, not gated: with random weights their mean-pooled states sit
# among the clean rows'.  The gate is the kernels against the plain backend
# on these embeddings.
CURATION = dict(batches=40, batch=16, seq=256, noise_frac=0.1, sites=4,
                k=8, outlier_frac=0.05, min_points=256, reservoir=2048,
                seed=0)
# Tolerances of (b): tests/test_models.py::
# test_rwkv_pallas_wkv_path_matches_jnp's atols (2e-3 on a block's output,
# 5e-3 on its gradient), scaled: the loss within 1e-4 of itself, each
# gradient leaf within 5e-3 of its largest magnitude.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 5e-3


def _train_cfg(layers, **over):
    from repro_torch.configs import get_config
    return get_config(TRAIN["arch"]).replace(n_layers=layers,
                                             wkv_use_pallas=True,
                                             remat_policy="nothing", **over)


def _token_batches(vocab, seq, batch, n, seed, dev):
    from repro_torch.data.tokens import PipelineConfig, TokenPipeline
    pipe = TokenPipeline(PipelineConfig(vocab=vocab, seq_len=seq,
                                        global_batch=batch, seed=seed))
    return [torch.as_tensor(pipe.global_batch(i)["tokens"], device=dev)
            for i in range(n)]


def _param_sums(model):
    return torch.stack([p.detach().double().sum()
                        for p in model.parameters()])


class _StepClock:
    """CUDA events inside ``make_train_step``'s step, through the names it
    calls: after ``forward_train`` returns, around ``adamw.apply``, and
    around each ``WKVForward.backward`` (the step oracle's recompute).
    ``split(i)`` is step i's ms: forward, backward (the recompute of remat
    included), of it the WKV backward, and ``adamw.apply``.  Off the card
    it records nothing."""

    def __init__(self, dev):
        self.on = dev.type == "cuda"
        self.steps = []

    def _mark(self, key):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.steps[-1].setdefault(key, []).append(e)

    def start(self):
        self.steps.append({})
        self._mark("start")

    def __enter__(self):
        from repro_torch.kernels.wkv import ops as wkv_ops
        from repro_torch.launch import steps as steps_mod
        from repro_torch.optim import adamw
        self._orig = (steps_mod.forward_train, adamw.apply,
                      wkv_ops.WKVForward.backward)
        fwd, apply, bwd = self._orig

        def fwd_timed(*a, **kw):
            out = fwd(*a, **kw)
            self._mark("fwd_end")
            return out

        def apply_timed(*a, **kw):
            self._mark("apply_start")
            out = apply(*a, **kw)
            self._mark("apply_end")
            return out

        def bwd_timed(ctx, *a):
            self._mark("wkv_bwd_start")
            out = bwd(ctx, *a)
            self._mark("wkv_bwd_end")
            return out

        steps_mod.forward_train, adamw.apply = fwd_timed, apply_timed
        wkv_ops.WKVForward.backward = staticmethod(bwd_timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.wkv import ops as wkv_ops
        from repro_torch.launch import steps as steps_mod
        from repro_torch.optim import adamw
        fwd, apply, bwd = self._orig
        steps_mod.forward_train, adamw.apply = fwd, apply
        wkv_ops.WKVForward.backward = staticmethod(bwd)

    def split(self, i):
        m = self.steps[i]
        ms = lambda a, b: a.elapsed_time(b)            # noqa: E731
        return {"forward_ms": ms(m["start"][0], m["fwd_end"][0]),
                "backward_ms": ms(m["fwd_end"][0], m["apply_start"][0]),
                "wkv_backward_ms": sum(
                    ms(a, b) for a, b in zip(m["wkv_bwd_start"],
                                             m["wkv_bwd_end"])),
                "wkv_backward_calls": len(m["wkv_bwd_start"]),
                "adamw_ms": ms(m["apply_start"][0], m["apply_end"][0])}


def train_steps(dev, counted, fail):
    """(a) 1 warm-up and 6 timed steps of the train cell through
    ``make_train_step``, each bracketed by a sync; each step split by CUDA
    events (``_StepClock``).  Returns (report, model, cfg)."""
    from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    cfg = _train_cfg(TRAIN["layers"])
    B, S = TRAIN["batch"], TRAIN["seq"]
    n = TRAIN["warmup"] + TRAIN["steps"]
    batches = _token_batches(cfg.vocab, S, B, n, TRAIN["seed"], dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = init_params(cfg, TRAIN["seed"], device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step, optc = make_train_step(cfg, device=dev)
    opt = adamw.init(model, optc)
    before = _param_sums(model)

    def run(batches):
        nonlocal model, opt
        rows = []
        for b in batches:
            sync(dev)
            clock.start()
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, {"tokens": b})
            sync(dev)
            rows.append(dict(s=time.perf_counter() - t0,
                             loss=float(m["loss"]), ce=float(m["ce"]),
                             grad_norm=float(m["grad_norm"]),
                             lr=float(m["lr"])))
            if clock.on:
                rows[-1].update(clock.split(len(clock.steps) - 1))
        return rows

    with _StepClock(dev) as clock:
        warm = run(batches[:TRAIN["warmup"]])
        rows = counted("rwkv6_7b_train", ("wkv_forward",),
                       lambda: run(batches[TRAIN["warmup"]:]))
    wkv = wkv_forward_cuda.launches
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if clock.on
            else None)
    step_s = [r["s"] for r in rows]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "remat": cfg.remat_policy, "wkv_chunk": cfg.wkv_chunk,
           "state_dtype": optc.state_dtype, "params": n_params,
           "batch": B, "seq": S, "warmup": warm, "steps": rows,
           "s_per_step_median": float(np.median(step_s)),
           "tokens_per_s": B * S * len(rows) / float(np.sum(step_s)),
           "peak_mem_gb": peak, "wkv_launches": wkv,
           "wkv_launches_per_step": wkv / len(rows),
           "opt_step": int(opt.step)}
    if clock.on:
        for key in ("forward_ms", "backward_ms", "wkv_backward_ms",
                    "adamw_ms"):
            out[f"{key}_median"] = float(np.median([r[key] for r in rows]))
        out["wkv_backward_share"] = float(np.median(
            [r["wkv_backward_ms"] / (r["s"] * 1e3) for r in rows]))
    log("train steps", json.dumps(out))
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
               for r in warm + rows):
        fail.append("train: a loss or grad norm is not finite")
    if out["opt_step"] != n:
        fail.append(f"train: opt_state.step {out['opt_step']} != {n}")
    if bool(torch.equal(before, _param_sums(model))):
        fail.append("train: the parameters did not change")
    if wkv != 2 * cfg.n_layers * len(rows):
        fail.append(f"train: {wkv} WKV launches in {len(rows)} steps, "
                    f"expected 2 x {cfg.n_layers} a step (remat 'nothing' "
                    f"runs each layer's forward twice)")
    del opt
    return out, model, cfg


def _grad_rel(ga, gb):
    """The largest leaf's max |a - b| / max |b| over two gradient lists."""
    return max(float((a.double() - b.double()).abs().max())
               / max(float(b.abs().max()), 1e-30) for a, b in zip(ga, gb))


def _loss_and_grads(model, cfg, tokens):
    from repro_torch.models.transformer import forward_train
    loss, _ = forward_train(model, {"tokens": tokens}, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), grads


def train_routes(dev, fail):
    """(b) Full width, 2 layers, f32, B = 2 x T = 256, from one model and
    batch: the kernel route against the plain chunked route; the three
    remat policies on the kernel route; inner remat on the plain route."""
    from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
    from repro_torch.models.transformer import init_params
    sm = TRAIN_SMALL
    cfg = _train_cfg(sm["layers"], dtype="float32")
    model = init_params(cfg, sm["seed"], device=dev)
    tokens = _token_batches(cfg.vocab, sm["seq"], sm["batch"], 1,
                            sm["seed"], dev)[0]
    runs = {}
    launches = {}
    for name, over in (("kernel_nothing", {}),
                       ("kernel_none", dict(remat_policy="none")),
                       ("kernel_dots", dict(remat_policy="dots")),
                       ("plain_nothing", dict(wkv_use_pallas=False)),
                       ("plain_inner_remat", dict(wkv_use_pallas=False,
                                                  wkv_inner_remat=True))):
        wkv_forward_cuda.launches = 0
        runs[name] = _loss_and_grads(model, cfg.replace(**over), tokens)
        sync(dev)
        launches[name] = wkv_forward_cuda.launches
    base_l, base_g = runs["kernel_nothing"]
    pl_l, pl_g = runs["plain_nothing"]
    grad_err = _grad_rel(base_g, pl_g)
    out = {"layers": cfg.n_layers, "dtype": cfg.dtype, "batch": sm["batch"],
           "seq": sm["seq"], "loss": {k: v[0] for k, v in runs.items()},
           "kernel_vs_plain_loss_rel": abs(base_l - pl_l) / abs(pl_l),
           "kernel_vs_plain_grad_rel_max": grad_err,
           "wkv_launches": launches}
    for name in ("kernel_none", "kernel_dots"):
        l_, g_ = runs[name]
        out[f"{name}_vs_nothing_bitwise"] = bool(
            l_ == base_l and all(torch.equal(a, b)
                                 for a, b in zip(g_, base_g)))
        out[f"{name}_vs_nothing_grad_rel_max"] = _grad_rel(g_, base_g)
    l_, g_ = runs["plain_inner_remat"]
    out["inner_remat_vs_plain_bitwise"] = bool(
        l_ == pl_l and all(torch.equal(a, b) for a, b in zip(g_, pl_g)))
    out["inner_remat_vs_plain_grad_rel_max"] = _grad_rel(g_, pl_g)
    log("train routes", json.dumps(out))
    if not (out["kernel_vs_plain_loss_rel"] <= TRAIN_LOSS_RTOL
            and grad_err <= TRAIN_GRAD_TOL):
        fail.append("train routes: kernel route vs plain route")
    for name in ("kernel_none_vs_nothing", "kernel_dots_vs_nothing",
                 "inner_remat_vs_plain"):
        if not out[f"{name}_grad_rel_max"] <= TRAIN_GRAD_TOL:
            fail.append(f"train routes: {name}")
    L = cfg.n_layers
    want = {"kernel_nothing": 2 * L, "kernel_none": L, "kernel_dots": 2 * L,
            "plain_nothing": 0, "plain_inner_remat": 0}
    if launches != want:
        fail.append(f"train routes: WKV launches {launches}, expected "
                    f"{want}")
    return out


def train_resume(dev, tmp, fail):
    """(c) The cell's bf16 and f32 moments at TRAIN_RESUME's width: save
    (params, opt_state) after step 3, restore into a fresh model and state,
    and step 4 must be bit for bit the uninterrupted run's."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import restore_train_state, train_state_tree
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    sm = TRAIN_RESUME
    cfg = _train_cfg(sm["layers"], d_model=sm["d_model"],
                     n_heads=sm["n_heads"], n_kv_heads=sm["n_heads"],
                     d_ff=sm["d_ff"])
    at = sm["resume_at"]
    batches = _token_batches(cfg.vocab, sm["seq"], sm["batch"], at + 1,
                             sm["seed"], dev)
    step, optc = make_train_step(cfg, device=dev)
    model = init_params(cfg, sm["seed"], device=dev)
    opt = adamw.init(model, optc)
    for b in batches[:at]:
        model, opt, _ = step(model, opt, {"tokens": b})
    ckpt = CheckpointManager(tmp / "train_resume", keep_last=1)
    sync(dev)
    t0 = time.perf_counter()
    ckpt.save(at - 1, train_state_tree(model, opt), blocking=True)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in (tmp / "train_resume").rglob("*"))
    model, opt, m = step(model, opt, {"tokens": batches[at]})
    want = {n: p.detach().cpu() for n, p in model.named_parameters()}
    want_loss = float(m["loss"])
    del model, opt
    fresh = init_params(cfg, sm["seed"] + 1, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    fresh, opt, saved = restore_train_state(ckpt, fresh, cfg, optc, dev)
    sync(dev)
    restore_s = time.perf_counter() - t0
    fresh, opt, m = step(fresh, opt, {"tokens": batches[at]})
    same = all(torch.equal(p.detach().cpu(), want[n])
               for n, p in fresh.named_parameters())
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "state_dtype": optc.state_dtype,
           "saved_step": saved,
           "checkpoint_gb": nbytes / 1e9, "save_s": save_s,
           "restore_s": restore_s, "loss": float(m["loss"]),
           "uninterrupted_loss": want_loss,
           "params_bitwise": same, "opt_step": int(opt.step)}
    log("train resume", json.dumps(out))
    if not (same and out["loss"] == want_loss and saved == at - 1
            and out["opt_step"] == at + 1):
        fail.append("train resume: the resumed step is not bit for bit the "
                    "uninterrupted one")
    return out


def train_cli(tmp, fail):
    """(d) ``python -m repro_torch.launch.train`` at SMOKE size on the card,
    then again with more steps: it must resume from the last checkpoint."""
    ckpt_dir = str(tmp / "train_cli")
    out = []
    first, last = TRAIN_CLI["steps"]
    for steps in (first, last):
        t0 = time.perf_counter()
        proc, lines = repro_torch_cli(
            "--arch", TRAIN["arch"], "--smoke", "--steps", str(steps),
            "--ckpt-every", str(TRAIN_CLI["ckpt_every"]), "--ckpt-dir",
            ckpt_dir, module="repro_torch.launch.train")
        for line in lines:
            log(f"train cli --steps {steps} |", line)
        rec = {"steps": steps, "rc": proc.returncode,
               "s": time.perf_counter() - t0,
               "resumed": f"resumed from step {first - 1}" in lines}
        out.append(rec)
        if proc.returncode != 0:
            log("train cli stderr |", proc.stderr[-4000:])
            fail.append(f"train cli --steps {steps}: rc {proc.returncode}")
    if not out[1]["resumed"] or out[0]["resumed"]:
        fail.append(f"train cli: the second run did not print 'resumed from "
                    f"step {first - 1}'")
    return out


def _hidden_means(model, cfg, tokens):
    """Mean-pooled last hidden state (before the final norm), no grad, as
    ``examples/train_curated_lm.py`` computes its embeddings."""
    from repro_torch.models.layers import embed
    from repro_torch.models.rwkv6 import rwkv_block
    with torch.no_grad():
        x = embed(model.embed.table, tokens)
        for blk in model.layers:
            x, _ = rwkv_block(blk, x, cfg)
        return x.float().mean(1)


def curation_kernel_checks(dev, emb, fail):
    """min_argmin and lloyd_step at the curator's call shapes (d = 4096),
    on random rows and on the model's embeddings, against their plain
    versions (to ``tol_for(d)``)."""
    c = CURATION
    n = c["batches"] * c["batch"]
    ps = path_shapes(n, c["k"], int(c["outlier_frac"] * n), c["sites"])
    d = emb.shape[1]
    g = torch.Generator(device="cpu").manual_seed(4)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)   # noqa: E731
    recs, bad = [], []
    site = emb[:ps["n_site"]].contiguous()
    pick = torch.randperm(n, generator=g).to(dev)
    cases = [("curation_alg1_round", rnd(ps["n_site"], d), rnd(ps["m"], d)),
             ("curation_alg2_reassign", rnd(ps["n_site"], d),
              rnd(ps["center_cap"], d)),
             ("curation_emb_round", site,
              emb[pick[:ps["m"]]].contiguous()),
             ("curation_emb_final", emb, emb[pick[:c["k"]]].contiguous())]
    for name, x, cc in cases:
        recs.append(check_pdist(dev, name, x, cc, "l2sq", bad))
    for name, x in (("curation_second_level", rnd(ps["n_rec"], d)),
                    ("curation_emb_second_level", emb)):
        w = torch.rand(x.shape[0], generator=g).to(dev) * 3
        cc = x[pick[:c["k"]] % x.shape[0]].contiguous()
        recs.append(check_lloyd(dev, name, x, w, cc, "l2sq", bad))
    for r in recs:
        log("check", json.dumps(r))
    fail += [f"curation kernel check {r['case']}" for r in bad]
    return recs


def _flip_verdict(x, ra, rb, metric="l2sq"):
    """(flips, bad) between two detects of the same reservoirs: the ids
    one run flagged and the other did not, and those of them that are not
    near-ties.  An id a flagged and b did not is a near-tie when its
    float64 distance to b's nearest center is within ``tol_for(d)`` (scaled
    as ``argmin_verdict``) of b's cut, the least such distance among b's
    flagged rows; and the same the other way."""
    xs = torch.as_tensor(x, dtype=torch.float64)
    ids = {n: set(r["outlier_ids"].tolist()) for n, r in (("a", ra),
                                                          ("b", rb))}
    flips = sorted(ids["a"] ^ ids["b"])
    if not flips:
        return 0, 0
    tol = tol_for(xs.shape[1])
    bad = 0
    for other, r in (("b", rb), ("a", ra)):
        c = torch.as_tensor(r["centers"], dtype=torch.float64)
        mine = sorted(ids[other])
        near = torch.cdist(xs, c).pow(2).min(1)
        cut = float(near.values[mine].min()) if mine else 0.0
        for i in flips:
            if i in ids[other]:
                continue
            scale = float(_scale(xs[i:i + 1], c[near.indices[i:i + 1]],
                                 metric)[0])
            bad += abs(float(near.values[i]) - cut) > tol * scale
    return len(flips), bad


def _curate(dev, counted, label, emb, planted):
    """``DataCurator`` fed ``emb`` (rows, d) batch by batch, each batch's
    rows split over the sites (``examples/train_curated_lm.py``'s loop),
    then ``detect``, counted as ``label``: the precision and recall of the
    flagged ``planted`` rows beside chance (the planted share).  Then the
    same reservoirs through Algorithm 3 twice more, from the curator's
    seed, on the kernels and on the plain (blocked) backend: the first
    must flag what ``detect`` flagged, the second the same ids up to
    near-tie flips (``_flip_verdict``)."""
    from repro_torch.core.curation import CuratorConfig, DataCurator
    from repro_torch.core.distributed import simulate_coordinator
    from repro_torch.core.sampler import TorchSampler
    from repro_torch.kernels.dispatch import KernelPolicy
    c = CURATION
    curator = DataCurator(n_sites=c["sites"], cfg=CuratorConfig(
        k=c["k"], outlier_frac=c["outlier_frac"], min_points=c["min_points"],
        reservoir=c["reservoir"], seed=c["seed"]), device=dev)
    for lo in range(0, emb.shape[0], c["batch"]):
        seq_ids = np.arange(lo, min(lo + c["batch"], emb.shape[0]))
        for s_i, idx in enumerate(np.array_split(seq_ids, c["sites"])):
            curator.observe(s_i, emb[idx], idx)
    t0 = time.perf_counter()
    flagged, comm = counted(label, ("min_argmin", "lloyd_step"),
                            curator.detect)
    detect_s = time.perf_counter() - t0
    flagged = np.asarray([] if flagged is None else flagged, np.int64)
    hits = len(set(flagged.tolist()) & set(planted))
    # detect's own call (core/curation.py), once per backend
    parts = [np.stack(b) for b in curator._buf if b]
    ids = np.concatenate([np.asarray(i) for i in curator._ids if len(i)])
    t = max(1, int(c["outlier_frac"] * curator.n_points))
    res = {b: simulate_coordinator(
        parts, TorchSampler(c["seed"]), k=c["k"], t=t,
        summary_alg="augmented", policy=KernelPolicy(backend=b), device=dev)
        for b in ("cuda", "blocked")}
    flips, bad = _flip_verdict(np.concatenate(parts), res["cuda"],
                               res["blocked"])
    return {"rows": curator.n_points, "planted": len(planted),
            "flagged": len(flagged), "t": t,
            "precision": hits / max(1, len(flagged)),
            "recall": hits / max(1, len(planted)),
            "chance_precision": len(planted) / max(1, curator.n_points),
            "comm_records": comm, "detect_s": detect_s,
            "flagged_unique_and_observed": bool(
                len(set(flagged.tolist())) == len(flagged)
                and set(flagged.tolist()) <= set(range(emb.shape[0]))),
            "detect_equals_cuda_run": bool(np.array_equal(
                np.sort(ids[res["cuda"]["outlier_ids"]]), np.sort(flagged))),
            "cuda_vs_blocked_flips": flips, "cuda_vs_blocked_bad": bad,
            "comm_records_cuda_blocked": [res[b]["comm_records"]
                                          for b in ("cuda", "blocked")]}


def train_curation(dev, counted, model, cfg, fail):
    """(e) 40 batches of 16 x 256 through the 8-layer model (no grad), 10%
    of each batch's rows replaced by uniform noise tokens; their
    embeddings into ``DataCurator`` over 4 sites, then ``detect`` (it must
    launch min_argmin and lloyd_step): the precision and recall of the
    flagged noise rows, reported beside chance.  The gate on the model's
    own embeddings is the kernels against their plain versions, at the
    call shapes and through Algorithm 3 end to end (``_curate``)."""
    from repro_torch.data.tokens import PipelineConfig, TokenPipeline
    c = CURATION
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=c["seq"],
                                        global_batch=c["batch"],
                                        seed=c["seed"]))
    rng = np.random.default_rng(c["seed"])
    planted = []

    def embed_rows():
        embs = []
        for step in range(c["batches"]):
            b = pipe.global_batch(step)["tokens"].copy()
            n_noise = int(c["noise_frac"] * b.shape[0])
            noisy = rng.choice(b.shape[0], n_noise, replace=False)
            b[noisy] = rng.integers(0, cfg.vocab, size=(n_noise, b.shape[1]))
            planted.extend((step * b.shape[0] + noisy).tolist())
            embs.append(_hidden_means(model, cfg,
                                      torch.as_tensor(b, device=dev)))
        out = torch.cat(embs)
        sync(dev)
        return out

    t0 = time.perf_counter()
    emb = counted("curation_embed", ("wkv_forward",), embed_rows)
    embed_s = time.perf_counter() - t0
    checks = curation_kernel_checks(dev, emb, fail)
    noise = _curate(dev, counted, "curation_detect", emb.cpu().numpy(),
                    planted)
    out = {"d": int(emb.shape[1]), "embed_s": embed_s, "checks": len(checks),
           "noise_rows": noise}
    log("train curation", json.dumps(out))
    if not (noise["flagged"] > 0 and noise["flagged_unique_and_observed"]):
        fail.append("curation: flagged ids malformed")
    if not noise["detect_equals_cuda_run"]:
        fail.append("curation: detect's ids are not its own call's")
    if noise["cuda_vs_blocked_bad"]:
        fail.append(f"curation: the kernels and the plain backend flag "
                    f"other ids ({noise['cuda_vs_blocked_bad']} of "
                    f"{noise['cuda_vs_blocked_flips']} flips not near-ties)")
    return out


def train_phase(dev, counted):
    """The "train" phase (a)-(e).  Returns the report; raises on any
    failure."""
    import gc
    import tempfile
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fail, part_s = [], {}
    t0 = time.perf_counter()

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        sync(dev)
        part_s[name] = time.perf_counter() - t
        return out

    steps_out, model, cfg = part("steps", train_steps, dev, counted, fail)
    curation_out = part("curation", train_curation, dev, counted, model,
                        cfg, fail)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    routes_out = part("routes", train_routes, dev, fail)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        resume_out = part("resume", train_resume, dev, Path(tmp), fail)
        cli_out = part("cli", train_cli, Path(tmp), fail)
    out = {"steps": steps_out, "routes": routes_out, "resume": resume_out,
           "cli": cli_out, "curation": curation_out, "part_s": part_s,
           "train_s": time.perf_counter() - t0}
    log(f"train_s {out['train_s']:.2f}", json.dumps(part_s))
    if fail:
        raise AssertionError(f"train phase failed: {fail}")
    return out


# ------------------------------------------------- dense and moe LM families
# (a) llava-next-mistral-7b FULL (32 layers, d 4,096, bf16): 4 prompts of
# 2,880 patch embeddings + 1,216 tokens = 4,096 positions, a ring for 32
# more; teacher forcing at 2,880 + 191 tokens (S + 1 = 3 x 1,024)
LM_DENSE = dict(arch="llava-next-mistral-7b", batch=4, text=1216, gen=32,
                prefills=3, tf_text=191, seed=0)
# (b) qwen3-moe-235b-a22b at its published widths, cut from 94 layers to 4;
# teacher forcing at capacity 16 on 2 prompts of 2,047 + 1 tokens
LM_MOE = dict(arch="qwen3-moe-235b-a22b", layers=4, batch=4, prompt=2048,
              gen=32, prefills=3, tf_batch=2, tf_prompt=2047, tf_cf=16.0,
              f32_layers=2, seed=1)
# (c) h2o-danube-1.8b FULL: one 8,191-token prompt, so W = 4,096 and the
# ring wraps; teacher forcing at 8,191 + 1 (S + 1 = 8 x 1,024)
LM_RING = dict(arch="h2o-danube-1.8b", batch=1, prompt=8191, gen=32,
               prefills=3, seed=2)
# (d) h2o-danube-1.8b FULL training: 2 x 4,096 tokens, remat "nothing"
LM_TRAIN = dict(arch="h2o-danube-1.8b", batch=2, seq=4096, warmup=1,
                steps=3, seed=3)
# (e) recurrentgemma-9b FULL: 4 x 4,096-token prompts, twice its 2,048-token
# local window, so the attention ring wraps; teacher forcing on 2 of them at
# 4,095 + 1 tokens (S + 1 = 4 x 1,024), in bf16 and then in f32 from the
# same weights upcast in place (~38 GB, with the bf16 copy gone); the scan
# against the stepwise recurrence at full width over ``scan_T`` tokens
LM_RGLRU = dict(arch="recurrentgemma-9b", batch=4, prompt=4096, gen=32,
                prefills=3, tf_batch=2, tf_prompt=4095, scan_T=512, seed=6)
# (f) seamless-m4t-medium FULL: 4 requests of 1,024 audio-frame embeddings
# (dim 80) and 4,096 decoder tokens, the reference's input_structs rule at
# L = 4,096; teacher forcing on 2 of them at 4,095 + 1 tokens
LM_ENCDEC = dict(arch="seamless-m4t-medium", batch=4, text=4096, gen=32,
                 prefills=3, tf_batch=2, tf_text=4095, seed=7)
# (g) recurrentgemma-9b training at its published widths cut to 5 layers
# (one group and the 2-layer tail): at 38 layers AdamW's f32 moments alone
# take ~77 GB
LM_RGLRU_TRAIN = dict(arch="recurrentgemma-9b", layers=5, batch=4, seq=1024,
                      warmup=1, steps=3, seed=8)
# The scan against the stepwise recurrence: the reference's own tolerance
# for this check (tests/test_models.py, rtol = atol = 1e-4), as a scaled
# distance.
LM_SCAN_TOL = 1e-4
# the mutation runs (``lm_mutations``): (a) and (c) cut to 4 layers
LM_MUTATION_LAYERS = 4
# Tolerances (each a scaled distance, max |a - b| / max(1, max |b|)):
# - f32 decode vs teacher forcing: both paths compute one function in f32
#   (TF32 off) and differ only in summation order (another query-chunk
#   split, a single-row product), ~1e-6 of the logits' scale; 1e-4 leaves
#   two orders of margin while a key missing from the ring moves the
#   logits by ~1e-2 (see PERF.md).
LM_TOL_F32 = 1e-4
# - bf16 at the f32 run's depth, in rms over the logits (``_rms``): the
#   bf16 prefill lies e16 from the f32 one (its bf16 rounding error); the
#   bf16 decode must lie within LM_BF16_FACTOR x e16 of both the bf16 and
#   the f32 prefill.  Clean runs on the H100 gave 0.61-0.71 x e16 and
#   0.99-1.03 x e16 (the decode's own rounding error is the prefill's size
#   and shares most of it); a ring slot off by one gave 1.50 and 1.55
#   (PERF.md, PR 23): 1.25 sits between, ~20% from each.
LM_BF16_FACTOR = 1.25
# - bf16 at a depth the f32 run does not reach (the moe's 4 layers; its
#   f32 run takes 2, for memory): the reference's own tolerance for this
#   check (tests/test_models.py, rtol = atol = 2e-2), as a scaled
#   distance.
LM_TOL_BF16_FULL = 2e-2
# The score product's precision, which teacher forcing cannot see at random
# weights (their scores are ~N(0, 1), where a bf16 score rounds less than
# the bf16 weights after the softmax do): layers._sdpa on bf16 q, k, v at
# (a)'s query-chunk shape, with q and k drawn N(0, 2.5^2) so that scores
# reach a trained model's peaks (std ~6, max ~30, where a bf16 score is off
# by up to 0.06), against a float64 oracle of the reference's semantics
# (f64 scores and softmax, the weights cast to bf16, f64 value product).
# The port's f32 scores leave the output's own bf16 rounding (half an ulp,
# 2^-9 of the output's scale) and rare flips of a weight's rounding; four
# half ulps, 2^-7, bound those.
LM_SCORE = dict(batch=1, q=1024, k=4096, sigma=2.5, seed=5)
LM_TOL_SCORE = 2.0 ** -7


def _free(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)     # also makes the context, if none yet
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def _lm_batch(cfg, B, n_text, seed, dev):
    """Tokens (B, n_text + 1) on ``dev`` and, for a vlm arch, its patch
    embeddings (B, frontend_tokens, frontend_dim) f32, for an audio arch
    its frame embeddings (B, max(n_text // 4, 8), frontend_dim) f32 (the
    reference's ``input_structs`` rule), from a seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = {"tokens": torch.randint(2, cfg.vocab, (B, n_text + 1), generator=g)
         .to(dev)}
    if cfg.frontend == "vlm_patches":
        b["patches"] = torch.randn((B, cfg.frontend_tokens, cfg.frontend_dim),
                                   generator=g).to(dev)
    elif cfg.frontend == "audio_frames":
        b["frames"] = torch.randn((B, max(n_text // 4, 8), cfg.frontend_dim),
                                  generator=g).to(dev)
    return b


def _prefix(batch, n_text):
    """The batch with its first ``n_text`` tokens (patches kept)."""
    return dict(batch, tokens=batch["tokens"][:, :n_text])


class _MoEProbe:
    """Wraps ``transformer.moe_ffn`` while on: records each call's
    ``drop_frac`` and, with ``routes`` set (off while serving is timed: it
    adds a product and a top-k a call), the sorted top-k expert ids of each
    row's last token; device tensors, read after the run."""

    def __init__(self):
        self.calls = []
        self.routes = False

    def __enter__(self):
        from repro_torch.models import transformer
        self._orig = fn = transformer.moe_ffn

        def probed(p, x, cfg, *ctx):
            y, aux = fn(p, x, cfg, *ctx)
            ids = None
            if self.routes:
                last = torch.softmax(x[:, -1].float() @ p.router, dim=-1)
                ids = torch.topk(last, cfg.top_k, dim=-1).indices.sort(
                    -1).values
            self.calls.append((aux["drop_frac"], ids))
            return y, aux

        transformer.moe_ffn = probed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.moe_ffn = self._orig

    def take(self):
        out, self.calls = self.calls, []
        return out


def _check_cache(cfg, cache, B, max_len, pos, dev, label, fail):
    from repro_torch.models.transformer import init_cache
    want = init_cache(cfg, B, max_len, device="meta")
    for name, z in want.items():
        c = cache[name]
        if c.shape != z.shape or c.dtype != z.dtype:
            fail.append(f"{label}: cache {name} {tuple(c.shape)} {c.dtype}, "
                        f"init_cache gives {tuple(z.shape)} {z.dtype}")
    if int(cache["pos"]) != pos:
        fail.append(f"{label}: cache pos {int(cache['pos'])} != {pos}")


def lm_serving(dev, counted, label, cfg, model, batch, max_len, gen,
               prefills, fail, probe=None):
    """A warm-up prefill, ``prefills`` timed prefills (their median gives
    tokens/s), then ``gen`` greedy decode steps from the last one's cache,
    through ``make_prefill_step`` / ``make_serve_step``.  Checks the caches
    against ``init_cache`` and finite logits."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    prefill = make_prefill_step(cfg, device=dev)
    serve = make_serve_step(cfg, device=dev)
    B = batch["tokens"].shape[0]
    # an encdec model's frames go to its encoder, not the decoder's prompt
    S = batch["tokens"].shape[1] + (0 if cfg.family == "encdec"
                                    else cfg.frontend_tokens)
    prefill(model, batch, max_len)
    if probe is not None:
        probe.take()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def run():
        times = []
        for _ in range(prefills):
            sync(dev)
            t0 = time.perf_counter()
            lg, cache = prefill(model, batch, max_len)
            sync(dev)
            times.append(time.perf_counter() - t0)
        return lg, cache, times

    lg, cache, times = counted(f"lm_{label}_prefill", (), run)
    if cfg.family == "encdec":     # the cache holds as many keys as frames
        cfg = cfg.replace(frontend_tokens=batch["frames"].shape[1])
    drop_pre = ([float(d) for d, _ in probe.take()[-cfg.n_layers //
                                                   cfg.moe_every:]]
                if probe is not None else None)
    _check_cache(cfg, cache, B, max_len, S, dev, f"{label} prefill", fail)
    tok0 = lg.argmax(-1, keepdim=True)
    toks, lgs, lat, cache = counted(
        f"lm_{label}_decode", (), lambda: _greedy(serve, model, cache, tok0,
                                                  gen, dev))
    _check_cache(cfg, cache, B, max_len, S + gen, dev, f"{label} decode",
                 fail)
    if not all(bool(torch.isfinite(x).all()) for x in [lg, *lgs]) \
            or lg.shape != (B, cfg.vocab):
        fail.append(f"{label}: logits not finite or malformed")
    med = float(np.median(times))
    lat_ms = np.asarray(lat) * 1e3
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.hd,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "window": cfg.sliding_window, "local_window": cfg.local_window,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": B, "positions": S, "max_len": max_len, "gen": gen,
           "frames": (int(batch["frames"].shape[1]) if "frames" in batch
                      else None),
           "cache_window": int(cache["kpos"].shape[0]),
           "cache_gb": sum(c.numel() * c.element_size()
                           for c in cache.values()) / 1e9,
           "prefill_s": times, "prefill_s_median": med,
           "prefill_tokens_per_s": B * S / med,
           "decode_p50_ms": float(np.percentile(lat_ms, 50)),
           "decode_p99_ms": float(np.percentile(lat_ms, 99)),
           "decode_tokens_per_s": B * gen / float(np.sum(lat)),
           "peak_mem_gb": _peak_gb(dev), "first_tokens": toks[:, :4].tolist()}
    if probe is not None:
        drop_dec = [float(d) for d, _ in probe.take()]
        out["drop_frac_prefill"] = drop_pre
        out["drop_frac_decode_mean"] = float(np.mean(drop_dec))
        out["capacity_decode"] = max(1, math.ceil(
            B * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return out


def _lm_teacher(dev, cfg, model, batch, max_len, probe=None):
    """(decode of the last token after prefill of the rest, prefill of all:
    its last logits[, the probe's routes of each])."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    n = batch["tokens"].shape[1] - 1
    prefill = make_prefill_step(cfg, device=dev)
    _, cache = prefill(model, _prefix(batch, n), max_len)
    if probe is not None:
        probe.take()
    step, _ = make_serve_step(cfg, device=dev)(
        model, cache, batch["tokens"][:, n:])
    r_step = probe.take() if probe is not None else None
    full, _ = prefill(model, batch, max_len)
    r_full = probe.take() if probe is not None else None
    return step, full, r_step, r_full


def _cut(model, cfg, n_entries):
    """The model's first ``n_entries`` stacked entries as a model of their
    own: the same parameters (``ModuleList`` slicing shares them)."""
    import copy
    cut = copy.copy(model)
    cut._modules = dict(model._modules, layers=model.layers[:n_entries])
    return cut, cfg.replace(n_layers=n_entries * cfg.moe_every)


def _rms(a, b):
    """rms(a - b) / rms(b), in float64: the bf16 gates' distance (a max
    over B x V logits follows one outlier; the rms over them is steady
    from run to run)."""
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def _same_routes(n_rows, *runs):
    """The rows whose last token every run (the probe's records of each
    moe layer) routes to the same experts: all rows without a probe."""
    return [r for r in range(n_rows)
            if all(torch.equal(a[1][r], b[1][r])
                   for run in runs[1:] for a, b in zip(runs[0], run))]


def lm_teacher_checks(dev, label, cfg, model, batch, max_len, fail,
                      f32_layers=None, probe=None, upcast_in_place=False):
    """Decode against teacher forcing: prefill(S) + decode(token S) against
    prefill(S + 1)'s last logits, in bf16 and in f32 from the same weights
    upcast, on the first ``f32_layers`` layers (default: all), and in bf16
    at full depth when the f32 run is cut.  ``upcast_in_place`` upcasts
    ``model`` itself (which the caller may no longer use as a bf16 model),
    so the bf16 copy is gone when the f32 one runs.  Returns the distances;
    appends a failure to ``fail``.  For a moe model (``probe`` on) a row whose last
    token two of the compared runs route to other experts (a near tie of
    the router, moved by bf16 rounding) is reported, not gated."""
    import copy
    B = batch["tokens"].shape[0]
    f32_layers = f32_layers or cfg.n_layers
    out = {}
    d16, f16, r1, r2 = _lm_teacher(dev, cfg, model, batch, max_len, probe)
    src, ccfg = model, cfg
    if f32_layers < cfg.n_layers:
        rows = (_same_routes(B, r1, r2) if probe is not None
                else list(range(B)))
        out.update(bf16_full_depth=_scaled(d16, f16),
                   bf16_full_depth_rows=rows, tol_bf16_full=LM_TOL_BF16_FULL)
        if rows and _scaled(d16[rows], f16[rows]) > LM_TOL_BF16_FULL:
            fail.append(f"{label}: bf16 decode vs teacher forcing "
                        f"{_scaled(d16[rows], f16[rows]):.3g} > "
                        f"{LM_TOL_BF16_FULL}")
        src, ccfg = _cut(model, cfg, f32_layers // cfg.moe_every)
        d16, f16, r1, r2 = _lm_teacher(dev, ccfg, src, batch, max_len,
                                       probe)
    m32 = src.float() if upcast_in_place else copy.deepcopy(src).float()
    del src
    _free(dev)
    d32, f32, r3, r4 = _lm_teacher(dev, ccfg.replace(dtype="float32"),
                                   m32, batch, max_len, probe)
    del m32
    rows = (_same_routes(B, r1, r2, r3, r4) if probe is not None
            else list(range(B)))
    out.update(layers_f32=ccfg.n_layers, rows=rows, tol_f32=LM_TOL_F32,
               bf16_factor=LM_BF16_FACTOR,
               f32=_scaled(d32, f32), bf16=_scaled(d16, f16),
               bf16_decode_vs_f32=_scaled(d16, f32),
               bf16_prefill_vs_f32=_scaled(f16, f32))
    if not rows:
        return out
    d16, f16, d32, f32 = (t[rows] for t in (d16, f16, d32, f32))
    e16 = _rms(f16, f32)
    out.update(bf16_rms=_rms(d16, f16), bf16_decode_vs_f32_rms=_rms(d16, f32),
               bf16_prefill_vs_f32_rms=e16, bf16_tol=LM_BF16_FACTOR * e16)
    if not _scaled(d32, f32) <= LM_TOL_F32:
        fail.append(f"{label}: f32 decode vs teacher forcing "
                    f"{_scaled(d32, f32):.3g} > {LM_TOL_F32}")
    if not (out["bf16_rms"] <= out["bf16_tol"]
            and out["bf16_decode_vs_f32_rms"] <= out["bf16_tol"]):
        fail.append(f"{label}: bf16 decode vs teacher forcing beyond "
                    f"{LM_BF16_FACTOR} x the bf16 prefill's rms distance "
                    f"from f32: {out}")
    return out


def lm_score_check(dev, cfg, fail):
    """``layers._sdpa`` at ``cfg``'s heads on LM_SCORE's shape against the
    float64 oracle; returns the scaled distance."""
    from repro_torch.models import layers
    c = LM_SCORE
    g = torch.Generator(device="cpu").manual_seed(c["seed"])
    B, Sq, Sk, hd = c["batch"], c["q"], c["k"], cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    q, k, v = (torch.randn(shape, generator=g).mul_(s).to(dev, torch.bfloat16)
               for shape, s in (((B, Sq, Hq, hd), c["sigma"]),
                                ((B, Sk, Hkv, hd), c["sigma"]),
                                ((B, Sk, Hkv, hd), 1.0)))
    qpos = torch.arange(Sk - Sq, Sk, device=dev)
    kpos = torch.arange(Sk, device=dev)
    got = layers._sdpa(q, k, v, qpos, kpos, None, causal=True, window=0)
    qg = q.double().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.double()) * hd ** -0.5
    mask = layers._scores_mask(qpos, kpos, causal=True, window=0)
    w = torch.softmax(torch.where(mask, s, -1e300), dim=-1)
    del s
    want = torch.einsum("bkgqt,btkd->bqkgd", w.to(torch.bfloat16).double(),
                        v.double()).reshape(B, Sq, Hq, hd)
    err = _scaled(got, want)
    if not err <= LM_TOL_SCORE:
        fail.append(f"{cfg.name}: attention at trained-model score scales "
                    f"{err:.3g} from the f64 oracle > {LM_TOL_SCORE}")
    return {"shape": [B, Sq, Sk, Hq, Hkv, hd], "sigma": c["sigma"],
            "scaled_err": err, "tol": LM_TOL_SCORE}


def lm_layer_split(dev, cfg, model, B, S):
    """CUDA-event ms (time_ms, 3 calls after a warm-up) of the last
    attention layer of the first stacked entry at (B, S): its attention
    block (projections, RoPE, the query-chunked f32-score attention, wo)
    beside torch's fused ``scaled_dot_product_attention`` on the same q, k
    and v (a yardstick only: the port never calls it), and its FFN (the
    MLP, or the MoE with its dispatch).  Off the card: host times, for
    rehearsals."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    from repro_torch.models.transformer import _ffn, _sublayers
    lyr = _sublayers(cfg, model.layers[0])[-1]
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(
        lyr.attn.wq.dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    out = {"batch": B, "seq": S}
    with torch.inference_mode():
        out["attention_ms"] = time_ms(lambda: layers.attention(
            lyr.attn, x, cfg, positions=pos, window=cfg.sliding_window), 3)
        out["ffn_ms"] = time_ms(lambda: _ffn(lyr, x, cfg), 3)
        if cfg.sliding_window == 0:
            q = layers.rope((x @ lyr.attn.wq).reshape(B, S, cfg.n_heads,
                                                      cfg.hd), pos[None],
                            cfg.rope_theta).transpose(1, 2)
            k, v = (t.transpose(1, 2) for t in layers.kv_proj(
                lyr.attn, x, cfg, pos))
            out["library_sdpa_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 3)
    return out


def lm_dense_serving(dev, counted, fail):
    """(a) llava-next-mistral-7b FULL serving and its teacher forcing."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    c = LM_DENSE
    cfg = get_config(c["arch"])
    sync(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, c["seed"], device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = _lm_batch(cfg, c["batch"], c["text"], c["seed"], dev)
    S = cfg.frontend_tokens + c["text"]
    out = lm_serving(dev, counted, "dense", cfg, model,
                     _prefix(batch, c["text"]), S + c["gen"], c["gen"],
                     c["prefills"], fail)
    out["init_s"] = init_s
    tf = dict(batch, tokens=batch["tokens"][:, :c["tf_text"] + 1])
    out["teacher"] = lm_teacher_checks(
        dev, "dense", cfg, model, tf, cfg.frontend_tokens + c["tf_text"] + 8,
        fail)
    out["score_check"] = lm_score_check(dev, cfg, fail)
    out["layer_split"] = lm_layer_split(dev, cfg, model, c["batch"], S)
    return out


def lm_moe_serving(dev, counted, fail):
    """(b) qwen3-moe at full width, 4 layers: serving with its drop
    fractions, then teacher forcing at capacity 16."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    c = LM_MOE
    cfg = get_config(c["arch"]).replace(n_layers=c["layers"])
    sync(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, c["seed"], device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = _lm_batch(cfg, c["batch"], c["prompt"], c["seed"], dev)
    with _MoEProbe() as probe:
        out = lm_serving(dev, counted, "moe", cfg, model,
                         _prefix(batch, c["prompt"]), c["prompt"] + c["gen"],
                         c["gen"], c["prefills"], fail, probe)
        out["init_s"] = init_s
        probe.routes = True
        tf = {"tokens": batch["tokens"][:c["tf_batch"], :c["tf_prompt"] + 1]}
        out["teacher"] = lm_teacher_checks(
            dev, "moe", cfg.replace(capacity_factor=c["tf_cf"]), model, tf,
            c["tf_prompt"] + 8, fail, f32_layers=c["f32_layers"],
            probe=probe)
    out["teacher"]["capacity_factor"] = c["tf_cf"]
    out["layer_split"] = lm_layer_split(dev, cfg, model, c["batch"],
                                        c["prompt"])
    out["layer_split_decode"] = lm_layer_split(dev, cfg, model, c["batch"], 1)
    return out


def lm_ring_serving(dev, counted, fail):
    """(c) h2o-danube-1.8b FULL: an 8,191-token prompt wraps the 4,096-slot
    ring; decode goes on overwriting slots; teacher forcing across it."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    c = LM_RING
    cfg = get_config(c["arch"])
    model = init_params(cfg, c["seed"], device=dev)
    batch = _lm_batch(cfg, c["batch"], c["prompt"], c["seed"], dev)
    max_len = c["prompt"] + c["gen"]
    out = lm_serving(dev, counted, "ring", cfg, model,
                     _prefix(batch, c["prompt"]), max_len, c["gen"],
                     c["prefills"], fail)
    if out["cache_window"] != cfg.sliding_window:
        fail.append(f"ring: cache window {out['cache_window']}")
    out["teacher"] = lm_teacher_checks(dev, "ring", cfg, model, batch,
                                       max_len, fail)
    return out


def lm_train(dev, counted, fail, c=LM_TRAIN, label="lm_train"):
    """(d) h2o-danube-1.8b FULL training (or (g), with ``c`` and ``label``
    given, recurrentgemma-9b cut to ``c["layers"]`` layers) through
    ``make_train_step``: batches from ``TokenPipeline``, remat "nothing",
    bf16 parameters and f32 moments.  The warm-up step runs on its own
    optimizer state, so the timed steps start at step 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    cfg = get_config(c["arch"]).replace(remat_policy="nothing")
    if "layers" in c:
        cfg = cfg.replace(n_layers=c["layers"])
    batches = _token_batches(cfg.vocab, c["seq"], c["batch"],
                             c["warmup"] + c["steps"], c["seed"], dev)
    model = init_params(cfg, c["seed"], device=dev)
    step, optc = make_train_step(cfg, device=dev)
    opt = adamw.init(model, optc)
    for b in batches[:c["warmup"]]:
        model, opt, _ = step(model, opt, {"tokens": b})
    del opt
    _free(dev)
    opt = adamw.init(model, optc)
    before = _param_sums(model)

    def run():
        nonlocal model, opt
        rows = []
        for b in batches[c["warmup"]:]:
            sync(dev)
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, {"tokens": b})
            sync(dev)
            rows.append(dict(s=time.perf_counter() - t0,
                             loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"])))
        return rows

    rows = counted(label, (), run)
    s = [r["s"] for r in rows]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "state_dtype": optc.state_dtype, "remat": cfg.remat_policy,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": c["batch"], "seq": c["seq"], "steps": rows,
           "s_per_step_median": float(np.median(s)),
           "tokens_per_s": c["batch"] * c["seq"] / float(np.median(s)),
           "peak_mem_gb": _peak_gb(dev), "opt_step": int(opt.step)}
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in rows):
        fail.append(f"{label}: a loss or grad norm is not finite")
    if out["opt_step"] != c["steps"]:
        fail.append(f"{label}: opt.step {out['opt_step']} != {c['steps']}")
    if bool(torch.equal(before, _param_sums(model))):
        fail.append(f"{label}: the parameters did not change")
    return out


def rglru_scan_check(dev, cfg, model, fail):
    """The RG-LRU block of the model's first recurrent layer, in f32 at
    full width, over ``scan_T`` tokens at once (the doubling scan) against
    one token at a time (the decode step), from gates drawn so that r is
    small and a near 1 (memory over ~50 tokens; the init's zero gates give
    a <= 0.03, which would leave the scan nothing to carry).  Also the
    scan alone at the prefill's shape (B, prompt, lru_width) f32, in
    CUDA-event ms, and its share of a prefill's 26 recurrent layers."""
    import copy
    from repro_torch.models import rglru
    c = LM_RGLRU
    rec = copy.deepcopy(model.groups[0].recs[0].rec).float()
    g = torch.Generator(device=dev).manual_seed(c["seed"] + 100)
    W = cfg.lru_width
    with torch.no_grad():
        rec.gate_r_w.copy_(torch.randn(W, generator=g, device=dev))
        rec.gate_i_w.copy_(torch.randn(W, generator=g, device=dev))
        rec.gate_r_b.copy_(torch.randn(W, generator=g, device=dev) - 4.0)
        rec.gate_i_b.copy_(torch.randn(W, generator=g, device=dev))
    c32 = cfg.replace(dtype="float32")
    T = c["scan_T"]
    x = torch.randn((2, T, cfg.d_model), generator=g, device=dev)
    with torch.inference_mode():
        y_scan, st_scan = rglru.rglru_block(rec, x, c32)
        st, ys = None, []
        for t in range(T):
            y, st = rglru.rglru_block(rec, x[:, t:t + 1], c32, st)
            ys.append(y)
        y_step = torch.cat(ys, 1)
        a = torch.rand((c["batch"], c["prompt"], W), generator=g, device=dev)
        b = torch.randn((c["batch"], c["prompt"], W), generator=g, device=dev)
        h0 = torch.zeros((c["batch"], W), device=dev)
        scan_ms = time_ms(lambda: rglru.linear_scan(a, b, h0), 3)
    out = {"T": T, "width": W, "y_err": _scaled(y_scan, y_step),
           "h_err": _scaled(st_scan["h"], st["h"]), "tol": LM_SCAN_TOL,
           "scan_shape": [c["batch"], c["prompt"], W],
           "scan_ms_per_layer": scan_ms,
           "scan_ms_per_prefill": scan_ms * (cfg.n_layers - cfg.n_layers
                                             // (cfg.rec_per_attn + 1))}
    if not (out["y_err"] <= LM_SCAN_TOL and out["h_err"] <= LM_SCAN_TOL):
        fail.append(f"rglru: scan vs stepwise {out}")
    return out


def rglru_layer_split(dev, cfg, model, B, S):
    """CUDA-event ms (3 calls after a warm-up) at (B, S) of the first
    group's recurrent layer (its RG-LRU block, then its FFN) and of its
    local-attention layer (attention at the local window, then its FFN)."""
    from repro_torch.models import layers
    from repro_torch.models.rglru import rglru_block
    from repro_torch.models.transformer import _ffn
    grp = model.groups[0]
    rec, att = grp.recs[0], grp.attn
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(
        att.attn.wq.dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        return {"batch": B, "seq": S,
                "rglru_block_ms": time_ms(
                    lambda: rglru_block(rec.rec, x, cfg), 3),
                "rec_ffn_ms": time_ms(lambda: _ffn(rec, x, cfg), 3),
                "attention_ms": time_ms(lambda: layers.attention(
                    att.attn, x, cfg, positions=pos,
                    window=cfg.local_window), 3),
                "attn_ffn_ms": time_ms(lambda: _ffn(att, x, cfg), 3)}


def lm_rglru_serving(dev, counted, fail):
    """(e) recurrentgemma-9b FULL serving: the ring of its local window
    wraps; caches, the scan on the card, then teacher forcing in bf16 and
    in f32 at full depth (the model upcast in place: the last use of it)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    c = LM_RGLRU
    cfg = get_config(c["arch"])
    sync(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, c["seed"], device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = _lm_batch(cfg, c["batch"], c["prompt"], c["seed"], dev)
    max_len = c["prompt"] + c["gen"]
    out = lm_serving(dev, counted, "rglru", cfg, model,
                     _prefix(batch, c["prompt"]), max_len, c["gen"],
                     c["prefills"], fail)
    out.update(init_s=init_s, param_count=cfg.param_count(),
               groups=len(model.groups), tail=len(model.tail))
    if out["cache_window"] != cfg.local_window:
        fail.append(f"rglru: cache window {out['cache_window']}")
    out["layer_split"] = rglru_layer_split(dev, cfg, model, c["batch"],
                                           c["prompt"])
    out["scan_check"] = rglru_scan_check(dev, cfg, model, fail)
    tf = {"tokens": batch["tokens"][:c["tf_batch"], :c["tf_prompt"] + 1]}
    out["teacher"] = lm_teacher_checks(dev, "rglru", cfg, model, tf,
                                       c["tf_prompt"] + 8, fail,
                                       upcast_in_place=True)
    return out


def encdec_cross_check(dev, cfg, model, batch, fail):
    """A prefill's cross-attention cache is each decoder layer's
    projection of the encoder's output (one ``final_norm``, no RoPE): the
    first and last layers' ``ck`` / ``cv`` bit for bit against
    ``kv_proj`` of ``_encode`` on the same frames."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import kv_proj
    from repro_torch.models.transformer import _encode
    _, cache = make_prefill_step(cfg, device=dev)(model, batch)
    with torch.inference_mode():
        x_enc, pos_e, _ = _encode(model, batch["frames"], cfg)
        same = []
        for i in (0, cfg.n_layers - 1):
            ck, cv = kv_proj(model.dec_layers[i].xattn, x_enc, cfg, pos_e,
                             use_rope=False)
            same.append(bool(torch.equal(ck, cache["ck"][i])
                             and torch.equal(cv, cache["cv"][i])))
    out = {"ck_shape": list(cache["ck"].shape), "layers_bitwise": same}
    if not all(same):
        fail.append(f"encdec: cross-attention cache {out}")
    return out


def lm_encdec_serving(dev, counted, fail):
    """(f) seamless-m4t-medium FULL serving: 1,024 frames and 4,096
    decoder tokens per request; the cross-attention cache, then teacher
    forcing in bf16 and in f32 at full depth."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    c = LM_ENCDEC
    cfg = get_config(c["arch"])
    sync(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, c["seed"], device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = _lm_batch(cfg, c["batch"], c["text"], c["seed"], dev)
    max_len = c["text"] + c["gen"]
    out = lm_serving(dev, counted, "encdec", cfg, model,
                     _prefix(batch, c["text"]), max_len, c["gen"],
                     c["prefills"], fail)
    out.update(init_s=init_s, param_count=cfg.param_count(),
               enc_layers=len(model.enc_layers))
    out["cross_cache"] = encdec_cross_check(dev, cfg, model,
                                            _prefix(batch, c["text"]), fail)
    tf = {"tokens": batch["tokens"][:c["tf_batch"], :c["tf_text"] + 1],
          "frames": batch["frames"][:c["tf_batch"]]}
    out["teacher"] = lm_teacher_checks(dev, "encdec", cfg, model, tf,
                                       c["tf_text"] + 8, fail)
    return out


def lm_rglru_train(dev, counted, fail):
    """(g) recurrentgemma-9b training at its published widths, 5 layers."""
    return lm_train(dev, counted, fail, LM_RGLRU_TRAIN, "lm_rglru_train")


def lm_phase(dev, counted):
    """The "lm" phase, parts (a)-(g), each after the previous part's model
    is released.  Returns the report; raises on any failure."""
    fail, out = [], {}
    t0 = time.perf_counter()
    for name, fn in (("dense", lm_dense_serving), ("moe", lm_moe_serving),
                     ("ring", lm_ring_serving), ("train", lm_train),
                     ("rglru", lm_rglru_serving),
                     ("encdec", lm_encdec_serving),
                     ("rglru_train", lm_rglru_train)):
        _free(dev)
        t = time.perf_counter()
        out[name] = fn(dev, counted, fail)
        sync(dev)
        out[name]["part_s"] = time.perf_counter() - t
        log(f"lm {name}", json.dumps(out[name]))
    _free(dev)
    out["lm_s"] = time.perf_counter() - t0
    log(f"lm_s {out['lm_s']:.2f}")
    if fail:
        raise AssertionError(f"lm phase failed: {fail}")
    return out


# A check of the checks (``--measure lm_mutations``): each mutation breaks
# the port in one place, monkeypatched for its run and restored after, and
# the lm checks at LM_MUTATION_LAYERS layers must fail under it.
def _sdpa_scores_bf16(q, k, v, qpos, kpos, kv_valid, *, causal, window):
    """``layers._sdpa`` with the score product left in the inputs' dtype
    (bf16 scores, as a plain bf16 einsum gives)."""
    from repro_torch.models import layers
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * (hd ** -0.5)
    mask = layers._scores_mask(qpos, kpos, causal=causal, window=window)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    w = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, hd)


def _mutations():
    """name -> (part, module, attribute, replacement)."""
    from repro_torch.models import layers, transformer
    dec, mask = transformer._decode_attn, layers._scores_mask

    def slot_off_by_one(lyr, xn, cfg, ck, cv, kpos, qpos, slot, *ctx):
        return dec(lyr, xn, cfg, ck, cv, kpos, qpos, (slot + 1) % ck.shape[1],
                   *ctx)

    def window_dropped(qpos, kpos, *, causal, window):
        return mask(qpos, kpos, causal=causal, window=0)

    return {"scores_bf16": ("dense", layers, "_sdpa", _sdpa_scores_bf16),
            "ring_slot_off_by_one": ("dense", transformer, "_decode_attn",
                                     slot_off_by_one),
            "window_mask_dropped": ("ring", layers, "_scores_mask",
                                    window_dropped)}


def lm_mutations(dev):
    """(a)'s and (c)'s teacher-forcing checks (and (a)'s score check) at
    LM_MUTATION_LAYERS layers, clean and under each mutation.  Returns each
    run's distances and whether the checks failed; raises if a mutation
    passed them."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    out, models = {}, {}
    for part, c, n_text in (("dense", LM_DENSE, LM_DENSE["tf_text"]),
                            ("ring", LM_RING, LM_RING["prompt"])):
        cfg = get_config(c["arch"]).replace(n_layers=LM_MUTATION_LAYERS)
        model = init_params(cfg, c["seed"], device=dev)
        batch = _lm_batch(cfg, 1, n_text, c["seed"], dev)
        models[part] = (cfg, model, batch,
                        cfg.frontend_tokens + n_text + 8)
        fail = []
        out[f"{part}_clean"] = dict(lm_teacher_checks(
            dev, part, cfg, model, batch, models[part][3], fail), failed=fail)
        if part == "dense":
            out["dense_clean"]["score_check"] = lm_score_check(dev, cfg, fail)
    for name, (part, mod, attr, repl) in _mutations().items():
        cfg, model, batch, max_len = models[part]
        orig, fail = getattr(mod, attr), []
        setattr(mod, attr, repl)
        try:
            res = lm_teacher_checks(dev, part, cfg, model, batch, max_len,
                                    fail)
            if part == "dense":
                res["score_check"] = lm_score_check(dev, cfg, fail)
        finally:
            setattr(mod, attr, orig)
        out[name] = dict(res, failed=fail, caught=bool(fail))
        log(f"lm mutation {name}", json.dumps(out[name]))
    missed = [n for n in _mutations() if not out[n]["caught"]]
    if any(out[f"{p}_clean"]["failed"] for p in ("dense", "ring")) or missed:
        raise AssertionError(f"lm mutations: clean runs {out} / passed the "
                             f"checks: {missed}")
    return out


# --------------------------------------------------------------- timings
# ---------------------------------------------------------------- robust
# The "robust" phase: gradient compression, the paper's outlier detection
# guarding data-parallel training, and the elastic runner.
# (a) int8 / bf16 error-feedback compression of (g)'s model's gradient at
# one recurrent layer's leaves (~201 M), over ``ef_steps`` steps
# (b) robust_mean_grads on ``ranks`` gloo ranks sharing the card, each
# holding a gradient tree of one recurrentgemma-9b recurrent layer's leaf
# shapes at full width: a shared base plus ``noise`` x N(0, 1) from the
# rank's seed; rank ``bad`` holds ``blowup`` in every entry (the reference
# test's corruption)
ROBUST = dict(ranks=4, bad=2, noise=0.01, blowup=1000.0, budget=1, seed=0,
              ef_steps=50, ef_batch=2, ef_seq=1024)
# (c) the reference test's elastic scenario (tests/test_checkpoint_runtime.py)
# on 8 logical replicas of the card, then an ElasticRunner over
# make_train_step of recurrentgemma at d = 512 (4 layers: a group and a
# 1-layer tail; the vocabulary cut to 32,768 so that each of its six
# checkpoints of params and f32 moments is ~0.5 GB, not ~2.7 GB), a failure
# after the step-3 checkpoint, against the uninterrupted run
ELASTIC = dict(steps=60, replicas=8, fail_at={23: 4, 41: 2}, ckpt_every=5,
               dim=16)
ELASTIC_TRAIN = dict(layers=4, d_model=512, n_heads=4, head_dim=128,
                     lru_width=512, d_ff=1536, vocab=32_768, batch=2,
                     seq=256, steps=8, ckpt_every=3, fail_at={5: 4},
                     replicas=8, seed=6)


def _rec_leaf_shapes() -> dict:
    """{name: shape} of one recurrentgemma-9b recurrent layer (FULL)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RecLayer
    cfg = get_config("recurrentgemma-9b")
    return {n: tuple(p.shape) for n, p in
            RecLayer(cfg, torch.bfloat16, "meta").named_parameters()}


def _robust_grads(rank, dev, shapes) -> dict:
    """Rank ``rank``'s f32 gradient tree (see ROBUST), made on ``dev``."""
    c = ROBUST
    g = torch.Generator(device=dev).manual_seed(c["seed"])
    tree = {n: torch.randn(shapes[n], generator=g, device=dev)
            for n in sorted(shapes)}
    if rank == c["bad"]:
        return {n: t.fill_(c["blowup"]) for n, t in tree.items()}
    g = torch.Generator(device=dev).manual_seed(c["seed"] + 1 + rank)
    return {n: t.add_(torch.randn(t.shape, generator=g, device=dev),
                      alpha=c["noise"]) for n, t in tree.items()}


def _tree_maxabs(a: dict, b: dict) -> float:
    return max(float((a[n] - b[n]).abs().max()) for n in a)


def robust_rank(rank, n, workdir, dev, shapes):
    """One rank of (b): ``robust_mean_grads`` on its tree, its launches, a
    digest of its mean and its sketch (the row it adds to the gathered
    sketches); rank 0 also rebuilds every rank's tree to hold the robust
    mean against the honest ranks' mean and their spread."""
    import hashlib
    from repro_torch.runtime.robust_agg import robust_mean_grads, sketch
    c = ROBUST
    kernels = _kernel_objects()
    grads = _robust_grads(rank, dev, shapes)
    own_sketch = sketch(grads, c["seed"]).cpu()
    sync(dev)
    t0 = time.perf_counter()
    (mean, (n_honest, flagged)), launches = _count(
        kernels, lambda: robust_mean_grads(
            grads, byzantine_budget=c["budget"], seed=c["seed"]))
    sync(dev)
    wall = time.perf_counter() - t0
    del grads
    h = hashlib.sha256()
    for name in sorted(mean):
        h.update(mean[name].cpu().numpy().tobytes())
    out = {"rank": rank, "flagged": bool(flagged), "n_honest": int(n_honest),
           "digest": h.hexdigest(), "s": wall, "launches": launches,
           "sketch": own_sketch, "dtype": str(mean[next(iter(mean))].dtype),
           "leaves": len(mean),
           "elements": sum(t.numel() for t in mean.values())}
    if rank == 0:
        honest = [r for r in range(n) if r != c["bad"]]
        total = None
        for r in honest:
            t = _robust_grads(r, dev, shapes)
            total = t if total is None else {k: total[k].add_(t[k])
                                             for k in total}
        want = {k: v / len(honest) for k, v in total.items()}
        spread = max(_tree_maxabs(_robust_grads(r, dev, shapes), want)
                     for r in honest)
        bad = _robust_grads(c["bad"], dev, shapes)
        naive = {k: (total[k] + bad[k]) / n for k in total}
        out.update(robust_err=_tree_maxabs(mean, want), honest_spread=spread,
                   naive_err=_tree_maxabs(naive, want))
        del total, want, bad, naive
    return out


def robust_kernel_checks(dev, sketches, fail):
    """``lloyd_step`` and ``min_argmin`` at the robust path's shape, on the
    ranks' gathered sketches (ranks, PROJ) with unit weights, f32, l2sq,
    against their plain versions: one center where k-means++ seeds it (a
    sketch) and one where the Lloyd loop settles (the honest sketches'
    mean)."""
    x = sketches.to(dev, torch.float32).contiguous()
    w = torch.ones(x.shape[0], dtype=torch.float32, device=dev)
    honest = [r for r in range(x.shape[0]) if r != ROBUST["bad"]]
    recs = []
    for name, c in (("robust_seed_center", x[:1].clone()),
                    ("robust_honest_center",
                     x[honest].mean(0, keepdim=True))):
        recs.append(check_lloyd(dev, name, x, w, c, "l2sq", fail))
        recs.append(check_pdist(dev, name, x, c, "l2sq", fail))
    return recs


def robust_aggregation(dev, tmp, fail):
    """(b): ``robust_mean_grads`` on ROBUST["ranks"] gloo ranks sharing the
    card (their tensors on the card, gloo staging them through the host),
    then its two kernels on the gathered sketches against their plain
    versions.  Returns (report, every rank's launches as per-run
    counts)."""
    from repro_torch.core.collective import gathered_bytes
    from repro_torch.runtime.robust_agg import PROJ
    c, n = ROBUST, ROBUST["ranks"]
    shapes = _rec_leaf_shapes()
    rs, wall = spawn_ranks(robust_rank, n, tmp, dev, shapes)
    elements = rs[0]["elements"]
    out = {"ranks": n, "backend": "gloo (ranks share one card; not NVLink)",
           "bad_rank": c["bad"], "budget": c["budget"],
           "leaves": rs[0]["leaves"], "elements_per_rank": elements,
           "ranks_wall_s": wall,
           "sketch_gather_bytes": gathered_bytes(torch.zeros(1, PROJ), n),
           "allreduce_payload_bytes_per_rank": 4 * elements,
           "rank_s": [r["s"] for r in rs],
           "flags": [r["flagged"] for r in rs],
           "n_honest": [r["n_honest"] for r in rs],
           "means_bitwise": len({r["digest"] for r in rs}) == 1
           and all(r["dtype"] == "torch.float32" for r in rs),
           "robust_err": rs[0]["robust_err"],
           "honest_spread": rs[0]["honest_spread"],
           "naive_err": rs[0]["naive_err"],
           "launches_per_rank": [r["launches"] for r in rs]}
    if not out["means_bitwise"]:
        fail.append("robust: the ranks' means differ")
    for i, r in enumerate(rs):
        if not (r["launches"]["lloyd_step"] > 0
                and r["launches"]["min_argmin"] > 0):
            fail.append(f"robust rank {i}: a kernel was not launched: "
                        f"{r['launches']}")
    if out["flags"] != [r == c["bad"] for r in range(n)] \
            or set(out["n_honest"]) != {n - 1}:
        fail.append(f"robust: flags {out['flags']}, honest {out['n_honest']}")
    if not (out["robust_err"] <= out["honest_spread"]
            and out["naive_err"] > 100 * out["honest_spread"]):
        fail.append(f"robust: robust mean {out['robust_err']:.3g} / naive "
                    f"{out['naive_err']:.3g} from the honest mean, whose "
                    f"spread is {out['honest_spread']:.3g}")
    out["kernel_checks"] = robust_kernel_checks(
        dev, torch.stack([r["sketch"] for r in rs]), fail)
    return out, {f"robust_rank{i}": r["launches"] for i, r in enumerate(rs)}


def robust_compression(dev, fail):
    """(a): the gradient of (g)'s model (its config and seed) on one batch
    at its first recurrent layer's leaves, encoded and decoded with error
    feedback for ROBUST["ef_steps"] steps in each scheme.  Per leaf: the
    int8 residual within half a quantization step at every step, and the
    time-average of the decoded steps within twice its bound (the last
    residual over the steps: half a step, or half a bf16 ulp, over 50) of
    the gradient."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import forward_train, init_params
    from repro_torch.optim import compression as C
    c, t = ROBUST, LM_RGLRU_TRAIN
    cfg = get_config(t["arch"]).replace(n_layers=t["layers"])
    model = init_params(cfg, t["seed"], device=dev)
    tokens = _token_batches(cfg.vocab, c["ef_seq"], c["ef_batch"], 1,
                            t["seed"], dev)[0]
    leaves = {n: p for n, p in model.named_parameters()
              if n.startswith("groups.0.recs.0.")}
    loss, _ = forward_train(model, {"tokens": tokens}, cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    del model, leaves, loss
    _free(dev)
    gmax = {n: float(g.float().abs().max()) for n, g in grads.items()}
    out = {"leaves": len(grads), "elements": sum(g.numel()
                                                 for g in grads.values()),
           "grad_dtype": str(next(iter(grads.values())).dtype),
           "steps": c["ef_steps"]}
    for scheme in ("bf16", "int8"):
        enc, dec = getattr(C, f"encode_{scheme}"), getattr(C,
                                                           f"decode_{scheme}")
        ef = C.init_ef(grads)
        acc = {n: torch.zeros_like(g, dtype=torch.float32)
               for n, g in grads.items()}
        worst_res, times = 0.0, []
        for _ in range(c["ef_steps"]):
            sync(dev)
            t0 = time.perf_counter()
            q, ef = enc(grads, ef)
            d = dec(q)
            sync(dev)
            times.append(time.perf_counter() - t0)
            for n in acc:
                acc[n] += d[n]
            if scheme == "int8":
                worst_res = max(worst_res, max(
                    float(ef.residual[n].abs().max()) / float(q[n][1])
                    for n in q))
        bound = 2.0 / 127 if scheme == "int8" else 2.0 ** -8
        avg = max(float((acc[n] / c["ef_steps"] - grads[n].float()).abs()
                        .max()) / max(gmax[n], 1e-30) for n in acc)
        out[scheme] = {"avg_err_rel": avg,
                       "avg_tol_rel": bound / c["ef_steps"],
                       "ms_per_step_median": 1e3 * float(np.median(times))}
        if scheme == "int8":
            out[scheme]["residual_over_scale_max"] = worst_res
            if not worst_res <= 0.5 + 2 ** -16:
                fail.append(f"compression int8: residual {worst_res} x the "
                            f"scale > half a step")
        if not avg <= bound / c["ef_steps"]:
            fail.append(f"compression {scheme}: time-average off by {avg:.3g}"
                        f" of the gradient > {bound / c['ef_steps']:.3g}")
    return out


def _elastic_regression_runner(dev, tmp):
    """The reference test's scenario: a linear regression, the global
    batch of 8 rows split evenly over the mesh's replicas and their
    gradients averaged."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.elastic import ElasticConfig, ElasticRunner
    D = ELASTIC["dim"]

    def make_step(mesh):
        def run(state, batch):
            w, opt_step = state
            x = torch.as_tensor(batch["x"], device=mesh[0])
            y = torch.as_tensor(batch["y"], device=mesh[0])
            w = w.detach().requires_grad_(True)
            losses = [((xs @ w - ys) ** 2).mean() for xs, ys in
                      zip(x.chunk(len(mesh)), y.chunk(len(mesh)))]
            loss = sum(losses) / len(losses)
            (g,) = torch.autograd.grad(loss, [w])
            return ((w - 0.1 * g).detach(), opt_step + 1), \
                {"loss": loss.detach()}
        return run

    w_true = np.random.default_rng(0).normal(size=D)

    def data_fn(step):
        r = np.random.default_rng(step)
        x = r.normal(size=(8, D)).astype(np.float32)
        return {"x": x, "y": (x @ w_true).astype(np.float32)}

    return ElasticRunner(
        make_step=make_step,
        init_state=lambda mesh: (torch.zeros(D, device=mesh[0]), torch.zeros(
            (), dtype=torch.int32, device=mesh[0])),
        state_shardings=lambda mesh, state: mesh[0], data_fn=data_fn,
        ckpt=CheckpointManager(tmp),
        cfg=ElasticConfig(ckpt_every=ELASTIC["ckpt_every"]))


def _elastic_train_runner(dev, tmp):
    """An ElasticRunner over ``make_train_step`` of recurrentgemma at
    ELASTIC_TRAIN's narrow width: the state is (params, opt_state) in the
    checkpoint's layout, loaded into a model on the mesh's first device
    for each step."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_state_tree
    from repro_torch.models.transformer import (build_model, init_params,
                                                load_params_)
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import ElasticConfig, ElasticRunner
    c = ELASTIC_TRAIN
    cfg = get_config("recurrentgemma-9b").replace(
        n_layers=c["layers"], d_model=c["d_model"], n_heads=c["n_heads"],
        head_dim=c["head_dim"], lru_width=c["lru_width"], d_ff=c["d_ff"],
        vocab=c["vocab"])
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=c["seq"],
                                        global_batch=c["batch"],
                                        seed=c["seed"]))

    def make_step(mesh):
        step, optc = make_train_step(cfg, device=mesh[0])
        holder = build_model(cfg, mesh[0])

        def run(state, batch):
            params, opt_tree = state
            load_params_(holder, params)
            opt = adamw.opt_state_from_numpy(opt_tree, cfg, mesh[0])
            model, opt, m = step(holder, opt, batch)
            return train_state_tree(model, opt), m
        return run

    def init_state(mesh):
        model = init_params(cfg, c["seed"], device=mesh[0])
        _, optc = make_train_step(cfg, device=mesh[0])
        return train_state_tree(model, adamw.init(model, optc))

    return cfg, ElasticRunner(
        make_step=make_step, init_state=init_state,
        state_shardings=lambda mesh, state: mesh[0],
        data_fn=lambda step: {"tokens": pipe.global_batch(step)["tokens"]},
        ckpt=CheckpointManager(tmp),
        cfg=ElasticConfig(ckpt_every=c["ckpt_every"]))


def robust_elastic(dev, tmp, fail):
    """(c): the reference test's scenario, then a restart of the train step
    bit for bit against the uninterrupted run."""
    e = ELASTIC
    t0 = time.perf_counter()
    state, log = _elastic_regression_runner(dev, tmp / "regression").run(
        e["steps"], devices=[dev] * e["replicas"], fail_at=dict(e["fail_at"]))
    sync(dev)
    out = {"regression": {
        "s": time.perf_counter() - t0, "remesh_steps": log["remesh_steps"],
        "devices_seen": sorted(set(log["device_counts"]), reverse=True),
        "final_loss": log["losses"][-1], "opt_step": int(state[1])}}
    r = out["regression"]
    if not (len(r["remesh_steps"]) == 2 and r["devices_seen"] == [8, 4, 2]
            and r["final_loss"] < 1e-2):
        fail.append(f"elastic: {r}")
    c = ELASTIC_TRAIN
    t0 = time.perf_counter()
    _, plain = _elastic_train_runner(dev, tmp / "train_plain")
    _, lp = plain.run(c["steps"], devices=[dev] * c["replicas"])
    _, failing = _elastic_train_runner(dev, tmp / "train_fail")
    _, lf = failing.run(c["steps"], devices=[dev] * c["replicas"],
                        fail_at=dict(c["fail_at"]))
    sync(dev)
    (fail_step,) = c["fail_at"]
    restart = lf["remesh_steps"][0] if lf["remesh_steps"] else None
    same = (restart is not None
            and lf["losses"] == lp["losses"][:fail_step]
            + lp["losses"][restart:])
    out["train"] = {"s": time.perf_counter() - t0, "steps": c["steps"],
                    "fail_at": {str(k): v for k, v in c["fail_at"].items()},
                    "restart_step": restart, "losses_plain": lp["losses"],
                    "losses_restarted": lf["losses"],
                    "devices_seen": sorted(set(lf["device_counts"]),
                                           reverse=True),
                    "bitwise": same}
    if not same or not np.isfinite(lp["losses"]).all():
        fail.append(f"elastic train: {out['train']}")
    return out


def robust_phase(dev):
    """The "robust" phase, (a) to (c).  Raises on any failure, after every
    part has run.  Returns (report, launches of the robust ranks)."""
    import tempfile
    fail, out = [], {}
    t0 = time.perf_counter()
    _free(dev)
    out["compression"] = robust_compression(dev, fail)
    log("robust compression", json.dumps(out["compression"]))
    _free(dev)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-robust-") as tmp:
        tmp = Path(tmp)
        (tmp / "ranks").mkdir()
        out["aggregation"], launches = robust_aggregation(dev, tmp / "ranks",
                                                          fail)
        log("robust aggregation", json.dumps(out["aggregation"]))
        out["elastic"] = robust_elastic(dev, tmp, fail)
        log("robust elastic", json.dumps(out["elastic"]))
    _free(dev)
    out["robust_s"] = time.perf_counter() - t0
    log(f"robust_s {out['robust_s']:.2f}")
    if fail:
        raise AssertionError(f"robust phase failed: {fail}")
    return out, launches


# ---- the "mesh" phase: the mesh tooling on the card
MESH = dict(sites=256, n_per_site=65_536, d=32, k=100, t=131_072,
            seed=0, job_sites=4,
            dry_cells=(("h2o-danube-1.8b", "train_4k", "single"),
                       ("h2o-danube-1.8b", "decode_32k", "multi"),
                       ("qwen2.5-32b", "long_500k", "single"),
                       ("rwkv6-7b", "long_500k", "single")),
            steps_arch="h2o-danube-1.8b", steps_batch=4, steps_seq=64,
            steps_gen=4, tol=1e-5)
JOB_LINES = (r"sites=(\d+) n=(\d+) partition=random wall=([\d.]+)s",
             r"communication: (\d+) records \(([\d.]+)% of data\)",
             r"l1=(\S+) l2=(\S+)",
             r"preRec=([\d.]+) prec=([\d.]+) recall=([\d.]+)")


def mesh_cluster_dryrun(dev, counted, fail):
    """(a): ``launch/cluster_dryrun.py`` at its single-pod defaults (256
    sites x 65,536 x 32, k = 100, t = 131,072, plain summaries,
    block_n = 16,384) on the card, its record checked, then ``min_argmin``
    at a site's Alg. 1 round (65,536 x the round's centers x 32) and
    ``lloyd_step`` at the second level (the gathered records, k = 100)
    against their plain versions."""
    from repro_torch.core.distributed import local_budget
    from repro_torch.core.summary import _plan
    from repro_torch.launch.cluster_dryrun import run as cluster_run
    c = MESH
    _free(dev)
    rec, ctx = counted("mesh_cluster_dryrun", ("min_argmin", "lloyd_step"),
                       lambda: cluster_run(sites=c["sites"],
                                           n=c["n_per_site"], d=c["d"],
                                           k=c["k"], t=c["t"], seed=c["seed"],
                                           device=dev))
    truth = set(ctx["out_ids"].cpu().tolist())
    found = set(np.asarray(ctx["result"]["outlier_ids"]).tolist())
    summ = set(np.asarray(ctx["result"]["summary_ids"]).tolist())
    rec["recall"] = len(truth & found) / len(truth)
    rec["precision"] = len(truth & found) / max(len(found), 1)
    rec["preRec"] = len(truth & summ) / len(truth)
    rec["peak_gb"] = _peak_gb(dev)
    terms = [rec[k] for k in ("hlo_flops", "hlo_bytes", "wire_bytes",
                              "compute_s", "memory_s", "collective_s")]
    if not (rec["status"] == "ok" and np.isfinite(terms).all()
            and min(terms) > 0 and 0 < rec["comm_fraction"] < 1
            and rec["recall"] > 0.5 and rec["preRec"] > 0.5):
        fail.append(f"cluster_dryrun: implausible record {rec}")
    x0 = ctx["x"][0]
    t_i = local_budget(c["t"], c["sites"], "random")
    m = _plan(c["n_per_site"], c["k"], t_i, 2.0, 0.45)[1]
    g = torch.Generator(device="cpu").manual_seed(7)
    cen = x0[torch.randperm(x0.shape[0], generator=g)[:m].to(dev)]
    pts = torch.cat(ctx["points"]).float().contiguous()
    wts = torch.cat(ctx["weights"]).float().contiguous()
    c2 = pts[torch.randperm(pts.shape[0], generator=g)[:c["k"]].to(dev)]
    checks = [check_pdist(dev, "cluster_dryrun_site_round", x0.contiguous(),
                          cen.contiguous(), "l2sq", fail),
              check_lloyd(dev, "cluster_dryrun_second_level", pts, wts,
                          c2.contiguous(), "l2sq", fail)]
    del ctx
    _free(dev)
    return rec, checks


def mesh_job_rank(rank, n, workdir, dev, argv):
    """(b), in a rank: ``cluster_job``'s part of rank ``rank`` (its
    ``site_job``, with the flags ``argv``), its kernels' launches counted
    from 0."""
    from repro_torch.launch import cluster_job
    args = cluster_job.parse_args(argv)
    lines, launches = _count(_kernel_objects(),
                             lambda: cluster_job.site_job(rank, n, args, dev))
    return {"lines": lines, "launches": launches}


def mesh_cluster_job(dev, tmp, fail):
    """(b): ``python -m repro_torch.launch.cluster_job --sites 4``'s job on
    four gloo ranks sharing the card, one site each: its four lines, and
    both distance kernels launched in every rank (each rank runs its site's
    summary and the replicated second level).  Returns (report, every
    rank's launches)."""
    import re
    n = MESH["job_sites"]
    rs, wall = spawn_ranks(mesh_job_rank, n, tmp, dev,
                           ["--sites", str(n)])
    lines = rs[0]["lines"] or []
    out = {"lines": lines, "wall_s": wall,
           "launches_per_rank": [r["launches"] for r in rs]}
    for i, r in enumerate(rs):
        if not (r["launches"]["min_argmin"] > 0
                and r["launches"]["lloyd_step"] > 0):
            fail.append(f"cluster_job rank {i}: a kernel was not launched: "
                        f"{r['launches']}")
    got = [re.fullmatch(p + r".*", ln) for p, ln in zip(JOB_LINES, lines)]
    if len(lines) != 4 or not all(got):
        fail.append(f"cluster_job: lines {lines}")
    else:
        pre, prec, rec = (float(v) for v in got[3].groups())
        out.update(sites=int(got[0].group(1)), preRec=pre, precision=prec,
                   recall=rec, comm_percent=float(got[1].group(2)))
        if out["sites"] != n or pre < 0.5 or rec < 0.5:
            fail.append(f"cluster_job: implausible result {out}")
    return out, {f"cluster_job_rank{i}": r["launches"]
                 for i, r in enumerate(rs)}


def _src_env():
    import os
    root = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=str(root / "src"))


def mesh_dryrun_cells(tmp, fail):
    """(c): the port's dry run of the reference test's cells, each in its
    own process (a fake process group of 256 or 512 ranks is global to a
    process), the four side by side, on fake tensors of the device type
    the build allows (printed)."""
    t0 = time.perf_counter()
    procs = {}
    for arch, shape, mesh in MESH["dry_cells"]:
        procs[(arch, shape, mesh)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_src_env())
    out = {}
    for (arch, shape, mesh), p in procs.items():
        so, se = p.communicate(timeout=900)
        tag = f"{arch}__{shape}__{mesh}"
        path = Path(tmp) / f"{tag}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        keep = {k: rec.get(k) for k in (
            "status", "chips", "device_type", "reason", "error", "lower_s",
            "compile_s", "hlo_flops", "hlo_bytes", "wire_bytes", "compute_s",
            "memory_s", "collective_s", "bottleneck", "useful_flops_ratio",
            "model_flops_per_chip", "memory")}
        keep["collectives"] = {k: v.get("count") for k, v in
                               (rec.get("collectives") or {}).items()}
        out[tag] = keep
        log("mesh dryrun", tag, json.dumps(keep))
        want = "skipped" if arch == "qwen2.5-32b" else "ok"
        if p.returncode or rec.get("status") != want:
            fail.append(f"dryrun {tag}: rc {p.returncode}, status "
                        f"{rec.get('status')}, {rec.get('error')} "
                        f"{se[-1500:]}")
        elif want == "ok" and not (rec["hlo_flops"] > 0 and rec["chips"] in
                                   (256, 512)):
            fail.append(f"dryrun {tag}: implausible record {keep}")
    c = out.get("h2o-danube-1.8b__train_4k__single", {})
    if c.get("status") == "ok" and not (
            c["hlo_flops"] > 0.5 * c["model_flops_per_chip"]
            and 0.05 < c["useful_flops_ratio"] < 1.5
            and c["memory"]["argument_bytes"] < 80e9):
        fail.append(f"dryrun danube train_4k: implausible terms {c}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def mesh_steps_rank(rank, n, workdir, dev):
    """(d), in a rank of a one-rank NCCL group: a SMOKE-width dense config
    (f32) built on a (1, 1) ``DeviceMesh`` on the card as the launcher
    builds it (``init_sharded_params``, ``init_opt_state``), one train step
    and a prefill + one decode step, against ``mesh=None`` on the card."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models.sharding import (init_opt_state,
                                             init_sharded_params)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    c = MESH
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(c["steps_arch"], smoke=True).replace(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (c["steps_batch"],
                                                    c["steps_seq"]),
                                     generator=g, device=dev)}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    m0 = init_params(cfg, 0, device=dev)
    m1 = init_sharded_params(cfg, 0, mesh, device=dev)   # the launcher's
    st0, optc = make_train_step(cfg, None, device=dev)
    st1, _ = make_train_step(cfg, mesh, device=dev)
    _, _, r0 = st0(m0, adamw.init(m0, optc), batch)
    _, _, r1 = st1(m1, init_opt_state(m1, optc, mesh), batch)
    p0 = dict(m0.named_parameters())
    out = {"mesh": str(mesh), "loss": (float(r0["loss"]), float(r1["loss"])),
           "grad_norm": (float(r0["grad_norm"]), float(r1["grad_norm"])),
           "param_rel": max(rel(p.detach().full_tensor(), p0[k].detach())
                            for k, p in m1.named_parameters())}
    L = c["steps_seq"] + c["steps_gen"]
    lg0, c0 = make_prefill_step(cfg, None, device=dev)(m0, batch, L)
    lg1, c1 = make_prefill_step(cfg, mesh, device=dev)(m1, batch, L)
    tok = lg0.argmax(-1, keepdim=True)
    d0, _ = make_serve_step(cfg, None, device=dev)(m0, c0, tok)
    d1, _ = make_serve_step(cfg, mesh, device=dev)(m1, c1, tok)
    out["prefill_rel"] = rel(lg1.full_tensor(), lg0)
    out["decode_rel"] = rel(d1.full_tensor(), d0)
    return out


def mesh_steps(dev, tmp, fail):
    """(d): DTensor steps on the card.  Gloo ranks sharing the card do not
    carry DTensor's collectives on CUDA tensors (a rank died with SIGSEGV
    when tried, PERF.md), so the mesh is (1, 1) over one NCCL rank."""
    rs, wall = spawn_ranks(mesh_steps_rank, 1, tmp, dev)
    out = dict(rs[0], wall_s=wall, backend="nccl, one rank")
    tol = MESH["tol"]
    (l0, l1), (n0, n1) = out["loss"], out["grad_norm"]
    if not (abs(l1 - l0) <= tol * abs(l0) and abs(n1 - n0) <= tol * abs(n0)
            and out["param_rel"] <= tol and out["prefill_rel"] <= tol
            and out["decode_rel"] <= tol):
        fail.append(f"mesh steps: sharded and one-device steps differ {out}")
    return out


def mesh_phase(dev, counted):
    """The "mesh" phase, (a) to (d).  Raises on any failure, after every
    part has run.  Returns (report, its kernel check records, the launches
    of (b)'s ranks, which report their own counts)."""
    import tempfile
    fail, out = [], {}
    t0 = time.perf_counter()
    out["cluster_dryrun"], checks = mesh_cluster_dryrun(dev, counted, fail)
    log("mesh cluster_dryrun", json.dumps(out["cluster_dryrun"]))
    for r in checks:
        log("check", json.dumps(r))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        tmp = Path(tmp)
        for sub in ("job", "cells", "ranks"):
            (tmp / sub).mkdir()
        out["cluster_job"], launches = mesh_cluster_job(dev, tmp / "job",
                                                        fail)
        log("mesh cluster_job", json.dumps(out["cluster_job"]))
        out["dryrun"] = mesh_dryrun_cells(tmp / "cells", fail)
        out["steps"] = mesh_steps(dev, tmp / "ranks", fail)
    log("mesh steps", json.dumps(out["steps"]))
    out["mesh_s"] = time.perf_counter() - t0
    log(f"mesh_s {out['mesh_s']:.2f}")
    if fail:
        raise AssertionError(f"mesh phase failed: {fail}")
    return out, checks, launches


def cdist_min(x, c, chunk=16_384):
    """Yardstick only: row-chunked ``torch.cdist`` + min (never in the
    port)."""
    for i in range(0, x.shape[0], chunk):
        torch.cdist(x[i:i + chunk], c).min(dim=1)


def timing_row(rows, kernel, shape_name, shape, work, k_fn, p_fn, lib_fn,
               reps):
    """Append one timing row: the kernel, its plain version and the library
    yardstick (``lib_fn``, or None) by CUDA events, beside the bound."""
    ms = time_ms(k_fn, reps)
    plain = time_ms(p_fn, max(1, reps // 2))
    lib = None if lib_fn is None else time_ms(lib_fn, max(1, reps // 2))
    b, by = bound_ms(*work)
    rows.append(dict(kernel=kernel, shape_name=shape_name, shape=shape,
                     ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                     bound_by=by, bytes=work[0], flops=work[1]))
    log(f"timing {kernel} {shape_name} {shape}: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, library "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms "
        f"({by})")


def kernel_timings(dev, kdd_x, kdd_res, kdd_model, gauss_x, ks, gs):
    """Kernel, plain and yardstick times at the main path's shapes, with
    inputs from this run (kdd site 0, its summary records, its model)."""
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
    from repro_torch.kernels.lloyd.ops import lloyd_step_blocked
    from repro_torch.kernels.pdist.kernel import (_launch_route,
                                                  min_argmin_cuda, route)
    from repro_torch.kernels.pdist.ops import min_argmin_blocked
    from repro_torch.kernels.score.kernel import score_cuda
    from repro_torch.kernels.score.ops import score_blocked

    g = torch.Generator(device="cpu").manual_seed(1)
    n_site, cap, d = ks["n_site"], ks["center_cap"], kdd_x.shape[1]
    site = kdd_x[:n_site]
    pick = torch.randperm(n_site, generator=g)[:cap].to(dev)
    rows = []

    def row(*args):
        timing_row(rows, *args)

    def pdist_row(shape_name, x, c, metric, reps, chunk=16_384):
        """A min_argmin row, with both routes timed beside the routed call
        (the rowscan route is the one-row-per-thread kernel, PR 11's)."""
        n, d = x.shape
        row("min_argmin", shape_name, [n, c.shape[0], d],
            pdist_work(n, c.shape[0], d, metric),
            lambda: min_argmin_cuda(x, c, metric=metric),
            lambda: min_argmin_blocked(x, c, metric=metric),
            lambda: cdist_min(x, c, chunk), reps)
        r = rows[-1]
        r["route"] = route(n, c.shape[0], d, metric)
        for how in ("rowscan", "tiled"):
            r[f"{how}_ms"] = time_ms(
                lambda: _launch_route(how, x, c, metric=metric), reps)
        log(f"timing min_argmin {shape_name} routed {r['route']}: rowscan "
            f"{r['rowscan_ms']:.4f} ms, tiled {r['tiled_ms']:.4f} ms")

    c = site[pick].contiguous()
    pdist_row("kdd_alg2_reassign", site, c, "l2sq", 5)
    rows[-1]["blocks_per_sm"] = _blocks_per_sm("pdist", d)
    # the baselines' assignment: a site against b of its rows (rand, uniform
    # and k-means||'s last call)
    b = h2h_budget(kdd_res)
    pdist_row("kdd_baseline_assign", site,
              site[torch.randperm(n_site, generator=g)[:b].to(dev)]
              .contiguous(), "l2sq", 5)
    cen = kdd_model.centers
    # gauss-0.1's Alg. 2 reassignment (d = 5)
    gsite = gauss_x[:gs["n_site"]]
    gpick = torch.randperm(gsite.shape[0], generator=g)[:gs["center_cap"]]
    gpick = gpick.to(dev)
    pdist_row("gauss_alg2_reassign", gsite, gsite[gpick].contiguous(),
              "l2sq", 20)
    # the small-m calls: kdd's and gauss's Alg. 1 rounds, kdd's losses, the
    # stream's refit assignment and merge round, cluster_dryrun's site round
    rows += pdist_small_m(dev, small_m_shapes(dev, kdd_x, gauss_x, ks, gs,
                                              cen))
    blocked = KernelPolicy(backend="blocked")
    for name, (lx, lw, lc) in lloyd_inputs(dev, kdd_x, kdd_res, kdd_model,
                                           gauss_x, gs).items():
        (ln, ld), lkc = lx.shape, lc.shape[0]
        row("lloyd_step", name, [ln, lkc, ld], lloyd_work(ln, lkc, ld),
            lambda: lloyd_step_cuda(lx, lw, lc),
            lambda: lloyd_step_blocked(lx, lw, lc, policy=blocked), None, 20)
        rows[-1].update(lloyd_split(dev, lx, lw, lc))
    gk = GAUSS["k"]
    # the serving read: kdd's model, and a micro-batch of gauss rows against
    # 100 of its rows (k = 100, d = 5); the "ms" column stays CUDA events
    # around back-to-back calls, beside the device/host split
    thr = kdd_model.threshold
    gcen = gauss_x[torch.randperm(gauss_x.shape[0],
                                  generator=g)[:gk].to(dev)].contiguous()
    for name, xb, cc in (("kdd_micro_batch", kdd_x[:MICRO_BATCH], cen),
                         ("gauss_micro_batch", gauss_x[:MICRO_BATCH], gcen)):
        xb = xb.contiguous()
        kk, dd = cc.shape
        row("score", name, [MICRO_BATCH, kk, dd],
            pdist_work(MICRO_BATCH, kk, dd, "l2sq", extra_out=4),
            lambda: score_cuda(xb, cc, thr),
            lambda: score_blocked(xb, cc, thr),
            lambda: torch.cdist(xb, cc).min(dim=1), 200)
        rows[-1].update(score_split(dev, xb, cc, thr))
    return rows


def _host_us(fn, reps=2000):
    """Host microseconds per call: the host clock over ``reps`` calls with no
    synchronise inside the loop, one after it (valid while the device keeps
    up, which the graph reading shows)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def _graph_device_us(fn, reps=200, replays=5, kernel="score_kernel"):
    """Device microseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed between CUDA events (the ctypes launch takes the
    current stream, the capture stream inside ``torch.cuda.graph``); if the
    capture fails, the profiler's device time of the kernels whose names
    hold ``kernel``, per call.  Returns (us, method)."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(replays):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) * 1e3 / (replays * reps), "cuda_graph"
    except RuntimeError as exc:
        log(f"graph capture failed ({exc}); profiler device time instead")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0) for e in evs)
    return total / reps, "profiler"


def _spy_launch(call):
    """(C entry, arguments) that one call of a wrapper last hands to ctypes,
    read by wrapping ``_build.bind`` for the call; every tensor the call
    made with ``torch.empty`` (outputs and scratch) is kept alive with
    them, so the pointers stay valid."""
    from repro_torch.kernels import _build
    seen, real, empty = {"made": []}, _build.bind, torch.empty

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def rec(*args):
            seen["fn"], seen["args"] = fn, args
            return fn(*args)
        return rec

    def made(*a, **kw):
        t = empty(*a, **kw)
        seen["made"].append(t)
        return t
    _build.bind, torch.empty = spy, made
    try:
        seen["out"] = call()
    finally:
        _build.bind, torch.empty = real, empty
    return seen["fn"], seen["args"], seen


def score_split(dev, x, c, thr, metric="l2sq"):
    """The serving read's time split at one micro-batch shape: device us per
    launch (CUDA graph), host us per call through ``score`` (the op
    ``_score_batch`` calls) and through the wrapper ``score_cuda``, and a
    host breakdown, each step its own loop of 2,000 calls."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.pdist.kernel import check_operands
    from repro_torch.kernels.score.kernel import score_cuda
    from repro_torch.kernels.score.ops import score
    n, d = x.shape
    m = c.shape[0]
    kw = dict(metric=metric, n=n, m=m, d=d, dtype=x.dtype)
    reg, bn, bm = dispatch.resolve_tiles(
        "score", None, platform=dispatch.platform_of(x), **kw)
    fn, args, _keep = _spy_launch(lambda: score_cuda(x, c, thr, metric=metric))
    dev_us, method = _graph_device_us(lambda: score_cuda(x, c, thr,
                                                         metric=metric))
    buf = torch.empty((3, n), dtype=torch.float32, device=x.device)
    steps = {
        "score_op": lambda: score(x, c, thr, metric=metric),
        "backend": lambda: reg.impl(x, c, thr, metric=metric, block_n=bn,
                                    block_m=bm),
        "wrapper": lambda: score_cuda(x, c, thr, metric=metric),
        "resolve": lambda: dispatch.resolve_tiles(
            "score", None, platform=dispatch.platform_of(x), **kw),
        "check_operands": lambda: check_operands(x, c, metric, "score_cuda"),
        "as_tensor_thr": lambda: torch.as_tensor(thr, dtype=torch.float32,
                                                 device=x.device),
        "contiguous_x": lambda: x.contiguous(),
        "thr_reshape_contiguous": lambda: thr.reshape(1).contiguous(),
        "empty_n": lambda: torch.empty((n,), dtype=torch.float32,
                                       device=x.device),
        "empty_3n": lambda: torch.empty((3, n), dtype=torch.float32,
                                        device=x.device),
        "unbind_int32_view": lambda: (lambda o: (o[0], o[1].view(
            torch.int32), o[2]))(buf.unbind(0)),
        "data_ptr": lambda: x.data_ptr(),
        "stream_of_device": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "stream_current": lambda: torch.cuda.current_stream().cuda_stream,
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(
            x.get_device()),
        "ctypes_launch": lambda: fn(*args),
    }
    host = {name: _host_us(f) for name, f in steps.items()}
    torch.cuda.synchronize()
    out = {"shape": [n, m, d], "device_us_per_launch": dev_us,
           "device_method": method, "host_us_per_call": host["score_op"],
           "host_us_per_wrapper_call": host["wrapper"],
           "host_breakdown_us": host}
    log(f"score_split {[n, m, d]}: device {dev_us:.3f} us/launch ({method}),"
        f" host {host['score_op']:.3f} us/call (wrapper "
        f"{host['wrapper']:.3f}); breakdown "
        + json.dumps({k: round(v, 3) for k, v in host.items()}))
    return out


# The H100's issue rate: 132 SMs x 4 schedulers x one warp instruction (32
# threads) a clock at the 1.98 GHz that PEAK_FP32_FLOPS assumes (67 TFLOP/s
# = 132 x 128 lanes x 2 x 1.98 GHz).
INSTR_RATE = 132 * 128 * 1.98e9          # thread instructions per second


def pair_instructions(d, metric, m=None):
    """Instructions a thread issues per (row, center) pair in the small-m
    route's scan (``pdist.cu``: scan_centers), counted from its code: one
    fused multiply-add a coordinate (l1: a subtract and an add with the
    absolute value folded in) over the chain's length DX (d at d = 5 and
    34, else the padded DP), a 16-byte broadcast load per four coordinates
    of a center shared by the R rows a thread holds, a quarter of the
    16-byte load of four norms, the bit-exact epilogue (add, multiply,
    subtract, max; l2 adds a correctly rounded square root, ~8), the
    strict-``<`` compare with its two selects, and (given m) the row's own
    norm spread over its m centers."""
    from repro_torch.kernels.pdist import kernel as pk
    dp = pk.padded_width(d) or d
    dx = d if (dp, d) in ((8, 5), (40, 34)) else dp
    r = pk.rows_per_thread(dp) if pk.padded_width(d) else 1
    per = (2 * dx if metric == "l1" else dx) + math.ceil(dx / 4) / r + 3
    if metric != "l1":
        per += 0.25 / r + 4 + (8 if metric == "l2" else 0)
        if m:
            per += dx / m
    return per


def instr_floor_ms(n, m, d, metric):
    """The least time the scan's instructions allow: instructions per pair
    x pairs / the card's issue rate (``INSTR_RATE``)."""
    return pair_instructions(d, metric, m) * n * m / INSTR_RATE * 1e3


def pdist_split(dev, x, c, metric="l2sq", reps=2000):
    """min_argmin's time split at one small-m shape: device us per launch
    (200 calls in one CUDA graph), host us per call through ``min_argmin``
    (the op the main path calls) and through the wrapper
    ``min_argmin_cuda``, and a host breakdown, each step its own loop of
    ``reps`` calls (fewer for a call the device cannot keep up with)."""
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.pdist import kernel as pk
    from repro_torch.kernels.pdist.ops import min_argmin, min_argmin_cuda
    n, d = x.shape
    m = c.shape[0]
    kw = dict(metric=metric, n=n, m=m, d=d, dtype=x.dtype)
    call = lambda: min_argmin_cuda(x, c, metric=metric)      # noqa: E731
    fn, args, _keep = _spy_launch(call)
    dev_us, method = _graph_device_us(call, kernel="min_argmin")
    short = reps if dev_us < 15.0 else max(20, reps // 20)
    steps = {
        "min_argmin_op": (lambda: min_argmin(x, c, metric=metric), short),
        "wrapper": (call, short),
        "resolve": (lambda: dispatch.resolve(
            "min_argmin", None, platform=dispatch.platform_of(x), **kw),
            reps),
        "contiguous_x_c": (lambda: (x.contiguous(), c.contiguous()), reps),
        "check_operands": (lambda: pk.check_operands(x, c, metric,
                                                     "min_argmin_cuda"),
                           reps),
        "empty_2n": (lambda: torch.empty((2, n), dtype=torch.float32,
                                         device=x.device), reps),
        "data_ptr": (lambda: x.data_ptr(), reps),
        "stream_ptr": (lambda: _build.stream_ptr(x), reps),
        "ctypes_launch": (lambda: fn(*args), short),
    }
    if hasattr(pk, "launch_plan"):
        buf = torch.empty((2, n), dtype=torch.float32, device=x.device)
        plan = pk.launch_plan(n, m, d)
        steps["plan"] = (lambda: pk.launch_plan(n, m, d), reps)
        steps["launch_args"] = (lambda: pk._rowscan_args(
            n, m, d, metric, x.dtype, plan), reps)
        steps["split_outputs"] = (lambda: pk.split_outputs(buf, n), reps)
    host = {name: _host_us(f, r) for name, (f, r) in steps.items()}
    torch.cuda.synchronize()
    out = {"shape": [n, m, d], "device_us_per_launch": dev_us,
           "device_method": method, "host_us_per_call": host["min_argmin_op"],
           "host_us_per_wrapper_call": host["wrapper"],
           "host_breakdown_us": host}
    if hasattr(pk, "launch_plan"):
        plan = pk.launch_plan(n, m, d)
        out["plan"] = plan._asdict()
        if plan.route == "rowscan" and plan.smem_bytes:
            out["blocks_per_sm"] = _blocks_per_sm(
                "pdist_rows", d, plan.rows, plan.smem_bytes)
    log(f"pdist_split {[n, m, d]}: device {dev_us:.3f} us/launch ({method}),"
        f" host {host['min_argmin_op']:.3f} us/call (wrapper "
        f"{host['wrapper']:.3f}); plan {out.get('plan')}, CTAs/SM "
        f"{out.get('blocks_per_sm')}; breakdown "
        + json.dumps({k: round(v, 3) for k, v in host.items()}))
    return out


def small_m_shapes(dev, kdd_x, gauss_x, ks, gs, kdd_centers=None):
    """min_argmin's small-m calls on the main path, as (x, c, metric):
    kdd's Alg. 1 round and losses and gauss's Alg. 1 round on the data's own
    site rows (the losses against ``kdd_centers``, the fit's model, or 3 of
    the rows), the stream refit's last assignment (1,048,576 x 20 x 5), the
    stream's merge round (two level-2 nodes' 16,384 records x 40 x 5) and
    ``cluster_dryrun``'s site round (65,536 x 200 x 32), these three on
    normal rows from a seed (the kernel's time does not depend on the
    values)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    site, gsite = kdd_x[:ks["n_site"]], gauss_x[:gs["n_site"]]
    pick = lambda rows, k: rows[torch.randperm(                 # noqa: E731
        rows.shape[0], generator=g)[:k].to(dev)].contiguous()
    if kdd_centers is None:
        kdd_centers = pick(site, KDD["k"])
    stream = torch.randn((1_048_576, STREAM["d"]), generator=g).to(dev)
    merged = torch.randn((4 * 2 * STREAM["leaf_size"], STREAM["d"]),
                         generator=g).to(dev)
    dry = torch.randn((MESH["n_per_site"], MESH["d"]), generator=g).to(dev)
    return {
        "kdd_alg1_round": (site, pick(site, ks["m"]), "l2sq"),
        "kdd_losses_l2": (kdd_x, kdd_centers.contiguous(), "l2"),
        "gauss_alg1_round": (gsite, pick(gsite, gs["m"]), "l2sq"),
        "stream_refresh_assign": (stream, pick(stream, STREAM["k"]), "l2sq"),
        "stream_merge_round": (merged, pick(merged, merge_round_m(
            merged.shape[0])), "l2sq"),
        "cluster_dryrun_site_round": (dry, pick(dry, 200), "l2sq"),
    }


def pdist_small_m(dev, shapes, reps=50):
    """The small-m shapes' timing rows (kernel, plain, library, bound, the
    instruction floor, both routes) with their time split."""
    from repro_torch.kernels.pdist import kernel as pk
    from repro_torch.kernels.pdist.kernel import (_launch_route,
                                                  min_argmin_cuda, route)
    from repro_torch.kernels.pdist.ops import min_argmin_blocked
    rows = []
    for name, (x, c, metric) in shapes.items():
        (n, d), m = x.shape, c.shape[0]
        timing_row(rows, "min_argmin", name, [n, m, d],
                   pdist_work(n, m, d, metric),
                   lambda: min_argmin_cuda(x, c, metric=metric),
                   lambda: min_argmin_blocked(x, c, metric=metric),
                   lambda: cdist_min(x, c, 1 << 20), reps)
        r = rows[-1]
        r["route"] = route(n, m, d, metric)
        if hasattr(pk, "rows_per_thread"):      # the small-m route's scan
            r["floor_ms"] = instr_floor_ms(n, m, d, metric)
            r["instructions_per_pair"] = pair_instructions(d, metric, m)
        for how in ("rowscan", "tiled"):
            r[f"{how}_ms"] = time_ms(
                lambda: _launch_route(how, x, c, metric=metric), reps)
        r.update(pdist_split(dev, x, c, metric))
        log(f"timing min_argmin {name}: floor {r.get('floor_ms')} ms "
            f"({r.get('instructions_per_pair')} instructions a pair); "
            f"rowscan {r['rowscan_ms']:.4f} ms, tiled {r['tiled_ms']:.4f} ms")
    return rows


def pdist_plan_ladder(dev, shapes):
    """The small-m route's launch plan against others, the measurement
    behind ``launch_plan``'s choices: at each small-m shape, rows per tile
    from 64 to 512 (R = 2 rows a thread), one and two row buffers, and a
    grid of as many CTAs as the SMs hold (persistent) or one CTA per tile,
    each the device us of one call (a CUDA graph of 200) through the C
    entry, its result bit for bit the routed call's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pdist import kernel as pk
    fn = _build.bind("pdist", "rt_min_argmin", 4, 0)
    out = []
    for name, (x, c, metric) in shapes.items():
        (n, d), m = x.shape, c.shape[0]
        dp = pk.padded_width(d)
        want = pk.min_argmin_cuda(x, c, metric=metric)
        chosen = pk.launch_plan(n, m, d)
        for rows in range(32 * pk.rows_per_thread(dp), 513, 64):
            for nbuf in (1, 2):
                smem = pk._rowscan_smem(rows, m, d, dp, nbuf)
                if smem > pk.SMEM_MAX or rows // pk.rows_per_thread(dp) > 256:
                    continue
                tiles = -(-n // rows)
                res = _blocks_per_sm("pdist_rows", d, rows, smem)
                if res < 1:
                    continue
                for grid in sorted({min(tiles, pk.SMS * res), tiles}):
                    plan = pk.LaunchPlan("rowscan", rows, grid, smem, m, nbuf)
                    args = pk._rowscan_args(n, m, d, metric, x.dtype, plan)
                    buf = torch.empty((2, n), dtype=torch.float32,
                                      device=x.device)
                    call = lambda: fn(x.data_ptr(), c.data_ptr(),  # noqa
                                      buf.data_ptr(), args,
                                      _build.stream_ptr(x))
                    _build.check(call(), "pdist_plan_ladder")
                    sync(dev)
                    dist, idx = pk.split_outputs(buf, n)
                    same = bool(torch.equal(dist, want[0])
                                and torch.equal(idx, want[1]))
                    us = _graph_device_us(call, reps=50 if n > 10**6
                                          else 200, kernel="min_argmin")[0]
                    rec = {"shape": name, "n": n, "m": m, "d": d,
                           "rows": rows, "buffers": nbuf, "grid": grid,
                           "persistent": grid < tiles, "us": us,
                           "chosen": plan == chosen, "bitwise": same}
                    out.append(rec)
                    log("pdist_plan", json.dumps(rec))
                    if not same:
                        raise AssertionError(f"plan {plan} changed the "
                                             f"result at {name}")
    return out


def lloyd_inputs(dev, kdd_x, kdd_res, kdd_model, gauss_x, gs):
    """The Lloyd step's two timed calls, as (x, w, c): the kdd fit's
    gathered summary records with their weights against its model's centers
    (the second level's shape, 874,751 x 3 x 34), and gauss-0.1's first
    n_rec rows, unit weights, against 100 of them (180,040 x 100 x 5)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    ids = torch.as_tensor(kdd_res["summary_ids"], device=dev)
    wts = torch.as_tensor(kdd_res["summary_weights"], device=dev)
    gx = gauss_x[:gs["n_rec"]].contiguous()
    gc = gx[torch.randperm(gx.shape[0], generator=g)[:GAUSS["k"]].to(dev)]
    return {"kdd_second_level": (kdd_x[ids].contiguous(), wts.float(),
                                 kdd_model.centers.contiguous()),
            "gauss_second_level_like": (gx, torch.ones((gx.shape[0],),
                                                       device=dev),
                                        gc.contiguous())}


def lloyd_split(dev, x, w, c, metric="l2sq"):
    """The Lloyd step's time split at one shape: device us per call of the
    kernel pair (200 calls in one CUDA graph), device us of the assignment
    alone (min_argmin's rowscan route on the same x and c, the scan the
    Lloyd kernels run), so accumulate + reduce ~ the difference; host us per
    call through ``lloyd_step`` (the op k-means-- calls) and through the
    wrapper (200 calls, one sync after: fewer launches than the queue
    holds), and a host breakdown, each step its own loop."""
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.lloyd import kernel as lk
    from repro_torch.kernels.lloyd.ops import lloyd_step
    from repro_torch.kernels.pdist.kernel import (_launch_route,
                                                  check_operands)
    n, d = x.shape
    k = c.shape[0]
    call = lambda: lk.lloyd_step_cuda(x, w, c, metric=metric)   # noqa: E731
    fn, args, _keep = _spy_launch(call)
    dev_us, method = _graph_device_us(call, kernel="lloyd")
    asg_us, asg_method = _graph_device_us(
        lambda: _launch_route("rowscan", x, c, metric=metric),
        kernel="min_argmin")
    kw = dict(metric=metric, n=n, m=k, d=d, dtype=x.dtype)
    words = k * d + k + 2 * n
    steps = {
        "lloyd_step_op": (lambda: lloyd_step(x, w, c, metric=metric), 200),
        "wrapper": (call, 200),
        "resolve": (lambda: dispatch.resolve(
            "lloyd_step", None, platform=dispatch.platform_of(x), **kw),
            2000),
        "check_operands": (lambda: check_operands(x, c, metric,
                                                  "lloyd_step_cuda"), 2000),
        "empty_out": (lambda: torch.empty((words,), dtype=torch.float32,
                                          device=x.device), 2000),
        "data_ptr": (lambda: x.data_ptr(), 2000),
        "stream_ptr": (lambda: _build.stream_ptr(x), 2000),
        "ctypes_launch": (lambda: fn(*args), 200),
    }
    buf = torch.empty((words,), dtype=torch.float32, device=x.device)
    steps["plan"] = (lambda: lk.lloyd_plan(n, k, d), 2000)
    steps["split_outputs"] = (lambda: lk.split_outputs(buf, n, k, d), 2000)
    host = {name: _host_us(f, reps) for name, (f, reps) in steps.items()}
    torch.cuda.synchronize()
    out = {"shape": [n, k, d], "device_us_per_call": dev_us,
           "device_method": method, "assign_only_us": asg_us,
           "assign_method": asg_method,
           "accumulate_reduce_us": dev_us - asg_us,
           "host_us_per_call": host["lloyd_step_op"],
           "host_us_per_wrapper_call": host["wrapper"],
           "host_breakdown_us": host}
    log(f"lloyd_split {[n, k, d]}: device {dev_us:.3f} us/call ({method}), "
        f"assignment alone {asg_us:.3f} us ({asg_method}), so accumulate + "
        f"reduce {dev_us - asg_us:.3f} us; host {host['lloyd_step_op']:.3f} "
        f"us/call (wrapper {host['wrapper']:.3f}); breakdown "
        + json.dumps({k: round(v, 3) for k, v in host.items()}))
    return out


def _blocks_per_sm(lib, *args):
    """Resident CTAs per SM of a new kernel (the occupancy calculator's
    answer): pdist's tiled route at width d (l2sq, f32), its small-m route
    at (d, rows, smem bytes) (l2sq, f32), or the WKV chunk sweep at (K, c,
    dtype code)."""
    import ctypes
    from repro_torch.kernels import _build
    if lib == "pdist":
        fn = _build.load("pdist").rt_min_argmin_tiled_blocks_per_sm
        fn.argtypes, call = [ctypes.c_int] * 3, (args[0], 0, 0)
    elif lib == "pdist_rows":
        fn = _build.load("pdist").rt_min_argmin_rows_blocks_per_sm
        fn.argtypes, call = [ctypes.c_int] * 5, (args[0], 0, 0, *args[1:])
    else:
        fn = _build.load("wkv").rt_wkv_blocks_per_sm
        fn.argtypes, call = [ctypes.c_int] * 3, args
    fn.restype = ctypes.c_int
    return fn(*call)


LADDER_M = (26, 48, 64, 96, 112, 128, 144, 160, 192, 224, 256, 320, 384,
            512, 1024, 2048, 5001)


def route_ladder(dev, kdd_x, gauss_x, ks, gs):
    """Both min_argmin routes over a ladder of m, the measurement behind
    kernel.py's route: at the kdd site's rows (n = 244,922, d = 34), the
    gauss site's (n = 50,250, d = 5), and normal rows at d = 16 and 64;
    per rung the CUDA-event ms of 30 back-to-back calls (what a caller
    waits, the host's share included) and the device us of one call (a
    CUDA graph of 200)."""
    from repro_torch.kernels.pdist.kernel import _launch_route
    g = torch.Generator(device="cpu").manual_seed(4)
    wide = torch.randn((ks["n_site"], 64), generator=g).to(dev)
    sites = (("kdd", kdd_x[:ks["n_site"]]), ("gauss", gauss_x[:gs["n_site"]]),
             ("normal16", wide[:, :16].contiguous()), ("normal64", wide))
    out = []
    for label, site in sites:
        for m in LADDER_M:
            c = site[torch.randperm(site.shape[0], generator=g)[:m].to(dev)]
            rec = {"site": label, "n": site.shape[0], "m": m,
                   "d": site.shape[1]}
            for how in ("rowscan", "tiled"):
                call = lambda: _launch_route(how, site, c)     # noqa: E731
                rec[f"{how}_ms"] = time_ms(call, 30)
                rec[f"{how}_device_us"] = _graph_device_us(
                    call, reps=20 if m > 1024 else 200,
                    kernel="min_argmin")[0]
            out.append(rec)
            log(f"route_ladder {label} d={rec['d']} m={m}: rowscan "
                f"{rec['rowscan_ms']:.4f} ms ({rec['rowscan_device_us']:.2f}"
                f" us device), tiled {rec['tiled_ms']:.4f} ms "
                f"({rec['tiled_device_us']:.2f} us device)")
    return out


WIDE_LADDER_D = (65, 96, 128, 160, 200, 256)
WIDE_LADDER_M = (8, 16, 32, 48, 64, 96, 128, 160, 192, 256, 512, 1024)
WIDE_SHAPES = ((62_500, 6_000, 257), (62_500, 6_000, 384),
               (62_500, 6_000, 768), (62_500, 6_000, 1024),
               (366_000, 100, 768), (62_500, 200, 768))


def wide_route_ladder(dev):
    """The measurement behind kernel.py's CHUNKED_MIN_M: the small-m and
    chunked min_argmin routes over a ladder of m at each d of
    WIDE_LADDER_D (n = 62,500 unit rows, the curation cell's site), device
    us of one call (a CUDA graph of 20-200); then the chunked route alone
    at WIDE_SHAPES (the curation cell's reassignment, its second level's
    assignment, an Alg. 1 round), its device us and its share of the fp32
    roofline (2 n m d operations at 67 TFLOP/s), and its resident CTAs an
    SM."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.pdist.kernel import _launch_route
    g = torch.Generator(device="cpu").manual_seed(5)
    out = {"ladder": [], "shapes": []}
    fn = _build.load("pdist").rt_min_argmin_chunked_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    out["chunked_ctas_per_sm"] = fn(0, 0)
    log(f"wide_ladder chunked CTAs an SM (l2sq, f32): "
        f"{out['chunked_ctas_per_sm']}")
    unit = lambda n, d: torch.nn.functional.normalize(      # noqa: E731
        torch.randn((n, d), generator=g), dim=1).to(dev)
    for d in WIDE_LADDER_D:
        x = unit(62_500, d)
        for m in WIDE_LADDER_M:
            c = x[torch.randperm(x.shape[0], generator=g)[:m].to(dev)]
            rec = {"n": x.shape[0], "m": m, "d": d}
            for how in ("rowscan", "chunked"):
                call = lambda: _launch_route(how, x, c)     # noqa: E731
                rec[f"{how}_device_us"] = _graph_device_us(
                    call, reps=20 if m > 256 else 100,
                    kernel="min_argmin")[0]
            out["ladder"].append(rec)
            log(f"wide_ladder d={d} m={m}: rowscan "
                f"{rec['rowscan_device_us']:.2f} us, chunked "
                f"{rec['chunked_device_us']:.2f} us")
    for n, m, d in WIDE_SHAPES:
        x = unit(n, d)
        c = x[torch.randperm(n, generator=g)[:m].to(dev)]
        us = _graph_device_us(lambda: _launch_route("chunked", x, c),
                              reps=10, kernel="min_argmin")[0]
        share = 100.0 * (2.0 * n * m * d / 67e12) / (us * 1e-6)
        out["shapes"].append({"n": n, "m": m, "d": d, "device_us": us,
                              "roofline_pct": share})
        log(f"wide_ladder chunked {n} x {m} x {d}: {us:.1f} us, "
            f"{share:.2f}% of the fp32 roofline")
    return out


def lloyd_ladder(dev, inputs):
    """The Lloyd step's routes over a ladder of k, the measurement behind
    ``lloyd_plan``'s choice: at the two timed calls' rows and weights (kdd's
    874,751 x 34 summary records, gauss's 180,040 x 5 rows), k centers drawn
    from those rows, the device us per call (a CUDA graph) of each route
    whose blocks fit; then the call's own plan with its rows split over
    more, smaller CTAs (caps of ``MAX_CTAS`` and above, each a plan handed
    to ``_launch_route``)."""
    from repro_torch.kernels.lloyd import kernel as lk
    g = torch.Generator(device="cpu").manual_seed(6)
    ladder, caps = [], []
    for label, (x, w, c0) in inputs.items():
        (n, d), k0 = x.shape, c0.shape[0]
        for k in (2, 3, 4, 6, 8, 16, 32, 100):
            c = x[torch.randperm(n, generator=g)[:k].to(dev)].contiguous()
            rec = {"shape": label, "n": n, "d": d, "k": k,
                   "routed": lk.lloyd_plan(n, k, d).route}
            for how in lk.ROUTES:
                try:
                    lk.lloyd_plan(n, k, d, how)
                except ValueError:
                    rec[f"{how}_us"] = None
                    continue
                rec[f"{how}_us"] = _graph_device_us(
                    lambda: lk._launch_route(how, x, w, c),
                    kernel="lloyd")[0]
            ladder.append(rec)
            log("lloyd_ladder", json.dumps(rec))
        plan = lk.lloyd_plan(n, k0, d)
        tiles = -(-n // plan.threads)
        for cap in (lk.MAX_CTAS, 2 * lk.MAX_CTAS, 4 * lk.MAX_CTAS, 4096):
            rows = plan.threads * max(1, -(-tiles // cap))
            p = plan._replace(rows=rows, grid=-(-n // rows))
            us = _graph_device_us(lambda: lk._launch_route(p, x, w, c0),
                                  kernel="lloyd")[0]
            rec = {"shape": label, "n": n, "d": d, "k": k0, "max_ctas": cap,
                   "grid": p.grid, "us": us}
            caps.append(rec)
            log("lloyd_ctas", json.dumps(rec))
    return {"ladder": ladder, "ctas": caps}


def wkv_timings(dev):
    """The WKV kernel at the rwkv6 prefill's call shape (bf16 r/k/v, f32 lw,
    per-row u, as the model hands them) beside its plain version and its
    bound.  No single PyTorch call computes a chunked WKV, so there is no
    library time."""
    from repro_torch.kernels.wkv.kernel import (wkv_chunk_w_cuda,
                                                wkv_forward_cuda,
                                                wkv_forward_plain)
    g = torch.Generator(device="cpu").manual_seed(3)
    BH, T, K, c = (WKV_MAIN[n] for n in ("BH", "T", "K", "chunk"))
    args = wkv_inputs(dev, g, BH, T, K, torch.bfloat16, per_row_u=True,
                      decay="init")
    ms = time_ms(lambda: wkv_forward_cuda(*args, chunk=c), 20)
    plain = time_ms(lambda: wkv_forward_plain(*args, chunk=c), 2)
    work = wkv_work(BH, T, K, 2, c)
    b, by = bound_ms(*work)
    # the first pass alone; B = 1 (BH = 64)
    first = time_ms(lambda: wkv_chunk_w_cuda(args[0], args[1], args[3],
                                             args[4], chunk=c), 10)
    b1 = [a[:BH // 4].contiguous() for a in args]
    b1_ms = time_ms(lambda: wkv_forward_cuda(*b1, chunk=c), 20)
    b1_bound = bound_ms(*wkv_work(BH // 4, T, K, 2, c))[0]
    occ = _blocks_per_sm("wkv", K, c, 1)
    log(f"timing wkv_forward rwkv6_prefill [{BH}, {T}, {K}] c={c}: kernel "
        f"{ms:.4f} ms (first pass alone {first:.4f} ms), plain "
        f"{plain:.4f} ms, library n/a, "
        f"bound {b:.4f} ms ({by}); B = 1 ({BH // 4} rows) {b1_ms:.4f} ms, "
        f"bound {b1_bound:.4f} ms; CTAs/SM {occ}")
    return [dict(kernel="wkv_forward", shape_name="rwkv6_prefill_bf16",
                 shape=[BH, T, K, c], ms=ms, plain_ms=plain, library_ms=None,
                 library_note="no single PyTorch call computes a chunked WKV",
                 bound_ms=b, bound_by=by, bytes=work[0], flops=work[1],
                 first_pass_ms=first,
                 b1_ms=b1_ms, b1_bound_ms=b1_bound, blocks_per_sm=occ)]


def wkv_train_timings(dev):
    """The WKV kernel at the train cell's call shape (BH = 4 x 64, T =
    1024, bf16 r/k/v, per-row u) beside its plain version and bound, and
    the backward pass of ``wkv_forward`` there: the step oracle recomputed
    under autograd (``kernels/wkv/ops.py``), as the reference does."""
    from repro_torch.kernels.wkv.kernel import (wkv_forward_cuda,
                                                wkv_forward_plain)
    from repro_torch.kernels.wkv.ops import wkv_forward
    g = torch.Generator(device="cpu").manual_seed(6)
    BH, T, K, c = 4 * 64, TRAIN["seq"], 64, WKV_MAIN["chunk"]
    args = wkv_inputs(dev, g, BH, T, K, torch.bfloat16, per_row_u=True,
                      decay="init")
    ms = time_ms(lambda: wkv_forward_cuda(*args, chunk=c), 20)
    plain = time_ms(lambda: wkv_forward_plain(*args, chunk=c), 2)
    leaves = [a.clone().requires_grad_(True) for a in args]
    o, sT = wkv_forward(*leaves, c)
    do, dsT = torch.randn_like(o), torch.randn_like(sT)
    bwd = time_ms(lambda: torch.autograd.grad((o, sT), leaves, (do, dsT),
                                              retain_graph=True), 2)
    work = wkv_work(BH, T, K, 2, c)
    b, by = bound_ms(*work)
    log(f"timing wkv_forward rwkv6_train [{BH}, {T}, {K}] c={c}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}); "
        f"backward (step oracle under autograd) {bwd:.1f} ms")
    return [dict(kernel="wkv_forward", shape_name="rwkv6_train_bf16",
                 shape=[BH, T, K, c], ms=ms, plain_ms=plain, library_ms=None,
                 bound_ms=b, bound_by=by, bytes=work[0], flops=work[1],
                 backward_oracle_ms=bwd)]


# ------------------------------------------------------------------- main
def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare_runs(dev, x, ra, rb) -> dict:
    """How far apart two fits are: each center's distance to the other
    run's nearest center (max, and weighted by the mass of ``x`` each center
    serves), the outlier sets' Jaccard overlap, and the costs."""
    from repro_torch.kernels.pdist.ops import min_argmin_blocked
    ca, cb = ra["centers"], rb["centers"]
    pair = np.sqrt(((ca[:, None, :] - cb[None, :, :]) ** 2).sum(-1))
    wmean = []
    for c, nn in ((ca, pair.min(1)), (cb, pair.min(0))):
        _, idx = min_argmin_blocked(x, torch.as_tensor(c, device=dev))
        mass = np.bincount(idx.cpu().numpy(), minlength=len(c))
        wmean.append(float((mass * nn).sum() / mass.sum()))
    oa, ob = set(ra["outlier_ids"].tolist()), set(rb["outlier_ids"].tolist())
    return {"centers_max_matched_diff": float(max(pair.min(1).max(),
                                                  pair.min(0).max())),
            "centers_mass_weighted_matched_diff": max(wmean),
            "outlier_jaccard": len(oa & ob) / max(len(oa | ob), 1),
            "cost_rel_diff": abs(ra["cost"] - rb["cost"])
            / max(abs(ra["cost"]), 1e-30)}


def make_data(dev):
    """Both data sets at the paper's size, on ``dev``, with their main
    path's call shapes."""
    from repro_torch.data.synthetic import gauss, kdd_like
    t0 = time.perf_counter()
    kdd_np, kdd_truth = kdd_like(n=KDD["n"], d=KDD["d"], seed=KDD["seed"])
    gauss_np, gauss_truth = gauss(
        n_centers=GAUSS["n_centers"], per_center=GAUSS["per_center"],
        d=GAUSS["d"], sigma=GAUSS["sigma"], t=GAUSS["t"], seed=GAUSS["seed"])
    kdd_x = torch.from_numpy(kdd_np).to(dev)
    gauss_x = torch.from_numpy(gauss_np).to(dev)
    log(f"data_s {time.perf_counter() - t0:.2f} kdd {tuple(kdd_x.shape)} "
        f"({kdd_x.numel() * 4 / 1e6:.0f} MB on the card, "
        f"{len(kdd_truth)} planted outliers), gauss {tuple(gauss_x.shape)}")
    ks = path_shapes(kdd_x.shape[0], KDD["k"], len(kdd_truth), KDD["sites"])
    gs = path_shapes(gauss_x.shape[0], GAUSS["k"], GAUSS["t"], GAUSS["sites"])
    log("path_shapes", json.dumps({"kdd": ks, "gauss": gs}))
    return kdd_np, kdd_truth, kdd_x, gauss_np, gauss_truth, gauss_x, ks, gs


MEASURES = ("serve", "lloyd_split", "lloyd_ladder", "stream", "train", "lm",
            "lm_mutations", "robust", "mesh", "pdist_split", "pdist_plans",
            "route_ladder", "wide_ladder")


def counted_runs(kernels, per_run):
    """``counted(label, needs, fn)``: every kernel's launch count set to 0
    just before ``fn`` and read just after into ``per_run[label]``; raises
    unless each kernel named in ``needs`` launched."""
    def counted(label, needs, fn):
        for kern in kernels:
            kern.launches = 0
        out = fn()
        per_run[label] = {k.name: k.launches for k in kernels}
        log("launches", label, json.dumps(per_run[label]))
        for name in needs:
            if per_run[label][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by "
                                     f"the {label} run")
        return out
    return counted


def run_measure(dev: torch.device, card: str, phases) -> dict:
    """Only the named measurements (of MEASURES), after the fits that feed
    them, in the full run's order: the kdd fit, serving, the gauss fit, then
    the Lloyd step's split and ladder at its two timed shapes.  One fresh
    process per reading; ``serve`` calls only the port's entry points, so
    this script can read it on another tree of the port as well.  ``train``
    (the train phase and the WKV's timings at its shape) needs no fit and
    runs alone."""
    from repro_torch.api.session import _model_from_result
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import KernelPolicy
    log(f"card: {card}")
    if {"lm", "lm_mutations"} & set(phases):
        if len(phases) > 1:
            raise ValueError("--measure lm and lm_mutations run alone")
        if phases == ["lm_mutations"]:
            return {"card": card, "lm_mutations": lm_mutations(dev)}
        per_run = {}
        counted = counted_runs(_kernel_objects(), per_run)
        return {"card": card, "lm": lm_phase(dev, counted),
                "launches_per_run": per_run}
    pdist_measures = {"pdist_split", "pdist_plans", "route_ladder",
                      "wide_ladder"}
    if pdist_measures & set(phases):
        if not set(phases) <= pdist_measures:
            raise ValueError(f"--measure {sorted(pdist_measures)} run "
                             f"without the others")
        return {"card": card, **pdist_measure(dev, phases)}
    _build.build_all()
    if "mesh" in phases:
        if len(phases) > 1:
            raise ValueError("--measure mesh runs alone")
        per_run = {}
        counted = counted_runs(_kernel_objects(), per_run)
        mesh, checks, launches = mesh_phase(dev, counted)
        per_run.update(launches)
        return {"card": card, "mesh": mesh, "checks": checks,
                "launches_per_run": per_run}
    if "robust" in phases:
        if len(phases) > 1:
            raise ValueError("--measure robust runs alone")
        robust, launches = robust_phase(dev)
        return {"card": card, "robust": robust,
                "launches_per_run": launches}
    if "train" in phases:
        if len(phases) > 1:
            raise ValueError("--measure train runs alone")
        from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
        from repro_torch.kernels.pdist.kernel import min_argmin_cuda
        from repro_torch.kernels.score.kernel import score_cuda
        from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
        per_run = {}
        counted = counted_runs((min_argmin_cuda, lloyd_step_cuda, score_cuda,
                                wkv_forward_cuda), per_run)
        return {"card": card, "train": train_phase(dev, counted),
                "wkv_train_timings": wkv_train_timings(dev),
                "launches_per_run": per_run}
    kdd_np, kdd_truth, kdd_x, _, gauss_truth, gauss_x, _, gs = make_data(dev)
    auto = KernelPolicy()
    out = {"card": card}
    kdd_res, kdd_out = run_oneshot(
        dev, kdd_x, kdd_truth, k=KDD["k"], t=len(kdd_truth),
        sites=KDD["sites"], second_iters=KDD["second_iters"],
        seed=KDD["seed"], policy=auto, label="kddFull_like")
    if "serve" in phases:
        model, out["serve"] = serve_model(dev, kdd_x, kdd_np, kdd_truth,
                                          kdd_res, auto)
        log("serve", json.dumps(out["serve"]))
    else:
        model = _model_from_result(kdd_x, kdd_res,
                                   kdd_pipeline(kdd_truth, auto), 1,
                                   device=dev)
    _, g_out = run_oneshot(
        dev, gauss_x, gauss_truth, k=GAUSS["k"], t=GAUSS["t"],
        sites=GAUSS["sites"], second_iters=GAUSS["second_iters"],
        seed=GAUSS["seed"], policy=auto, label="gauss_0.1")
    out["phase_s"] = {o["run"]: o["phase_s"] for o in (kdd_out, g_out)}
    log("phase_s", json.dumps(out["phase_s"]))
    if {"lloyd_split", "lloyd_ladder"} & set(phases):
        inputs = lloyd_inputs(dev, kdd_x, kdd_res, model, gauss_x, gs)
    if "lloyd_split" in phases:
        out["lloyd_split"] = {name: lloyd_split(dev, *xwc)
                              for name, xwc in inputs.items()}
    if "lloyd_ladder" in phases:
        out["lloyd_ladder"] = lloyd_ladder(dev, inputs)
    if "stream" in phases:
        out["stream"] = stream_measure(dev)
        log("stream", json.dumps(out["stream"]))
    return out


def pdist_measure(dev, phases) -> dict:
    """``pdist_split``: the small-m route's edge checks (on a tree whose
    wrapper has ``launch_plan``), then its timing rows and time split at the
    small-call shapes; ``pdist_plans``: its plan ladder there;
    ``route_ladder``: both routes over m; ``wide_ladder``: the small-m
    and chunked routes past d = 64 (on rows of its own).  Only the pdist and
    score kernels are built, at their first call."""
    from repro_torch.kernels.pdist import kernel as pk
    out = {}
    if "wide_ladder" in phases:
        out["wide_ladder"] = wide_route_ladder(dev)
        if set(phases) == {"wide_ladder"}:
            return out
    _, _, kdd_x, _, _, gauss_x, ks, gs = make_data(dev)
    if "pdist_split" in phases:
        if hasattr(pk, "launch_plan"):
            g = torch.Generator(device="cpu").manual_seed(0)
            rnd = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa
            fail = []
            t0 = time.perf_counter()
            recs = small_m_checks(dev, rnd, fail)
            log(f"small_m_checks_s {time.perf_counter() - t0:.2f}: "
                f"{len(recs)} checks, {len(fail)} failed")
            for r in fail:
                log("FAILED CHECK", json.dumps(r))
            if fail:
                raise AssertionError(f"{len(fail)} small-m checks failed")
            out["checks"] = len(recs)
        out["pdist_split"] = pdist_small_m(
            dev, small_m_shapes(dev, kdd_x, gauss_x, ks, gs))
    if "pdist_plans" in phases:
        out["pdist_plans"] = pdist_plan_ladder(
            dev, small_m_shapes(dev, kdd_x, gauss_x, ks, gs))
    if "route_ladder" in phases:
        out["route_ladder"] = route_ladder(dev, kdd_x, gauss_x, ks, gs)
    return out


def stream_measure(dev) -> dict:
    """The stream deployment's readings through ``StreamService``'s entry
    points alone (so any tree of the port runs it): ingest rows/s resident
    and under ``StoreSpec(hot_levels=1)``, then 400 micro-batches of 256
    through submit + drain on the resident service (p50 / p99 ms)."""
    import tempfile
    from repro_torch.data.synthetic import gauss
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.store import StoreSpec
    from repro_torch.stream import StreamService
    x, _ = gauss(n_centers=STREAM["n_centers"],
                 per_center=STREAM["per_center"], d=STREAM["d"],
                 sigma=STREAM["sigma"], t=STREAM["t"], seed=STREAM["seed"])
    n, auto = x.shape[0], KernelPolicy()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-measure-") as tmp:
        for label, over in (("resident", {}), ("tiered", {"store": StoreSpec(
                hot_levels=1, directory=str(Path(tmp) / "spill"))})):
            svc = StreamService(stream_config(n, STREAM["t"], auto, **over),
                                device=dev)
            wall, _ = stream_ingest(svc, x)
            out[f"ingest_rows_per_s_{label}"] = n / wall
            if label == "resident":
                rng = np.random.default_rng(3)
                lat = []
                for _ in range(SERVE_BATCHES):
                    q = x[rng.integers(0, n, MICRO_BATCH)]
                    t0 = time.perf_counter()
                    svc.submit(q)
                    svc.drain()
                    lat.append(time.perf_counter() - t0)
                lat_ms = np.asarray(lat) * 1e3
                out["batch_p50_ms"] = float(np.percentile(lat_ms, 50))
                out["batch_p99_ms"] = float(np.percentile(lat_ms, 99))
            elif svc.tree.store is not None:
                svc.tree.store.close()
    return out


def run(dev: torch.device, card: str) -> dict:
    """Every phase on ``dev``; returns the report.  Raises on any failure."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.lloyd.kernel import lloyd_step_cuda
    from repro_torch.kernels.pdist.kernel import min_argmin_cuda
    from repro_torch.kernels.score.kernel import score_cuda
    from repro_torch.kernels.wkv.kernel import wkv_forward_cuda

    t_start = time.perf_counter()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build_s {build_s:.2f} (nvcc, sm_90a, {len(_build.SOURCES)} "
        f"sources in parallel)")

    kdd_np, kdd_truth, kdd_x, gauss_np, gauss_truth, gauss_x, ks, gs = \
        make_data(dev)

    # ---- 2. kernels against their plain versions
    t0 = time.perf_counter()
    checks, failed = kernel_checks(dev, kdd_x, gauss_x, ks, gs)
    wkv_recs, wkv_failed = wkv_checks(dev)
    checks += wkv_recs
    failed += wkv_failed
    for r in wkv_recs:
        log("wkv_check", json.dumps(r))
    log(f"kernel_checks_s {time.perf_counter() - t0:.2f}: {len(checks)} "
        f"checks, {len(failed)} failed")
    for r in failed:
        log("FAILED CHECK", json.dumps(r))
    if failed:
        raise AssertionError(f"{len(failed)} kernel checks failed")

    # ---- 3. the main path: each run driven with every counter at 0 just
    # before it and read just after it
    kernels = (min_argmin_cuda, lloyd_step_cuda, score_cuda,
               wkv_forward_cuda)
    per_run = {}
    counted = counted_runs(kernels, per_run)

    auto = KernelPolicy()
    kdd_res, kdd_out = counted("kddFull_like_fit", ("min_argmin",
                                                    "lloyd_step"),
                               lambda: run_oneshot(
        dev, kdd_x, kdd_truth, k=KDD["k"], t=len(kdd_truth),
        sites=KDD["sites"], second_iters=KDD["second_iters"],
        seed=KDD["seed"], policy=auto, label="kddFull_like"))
    log("main_path", json.dumps(kdd_out))
    t0 = time.perf_counter()
    kdd_model, serve_out = counted("kddFull_like_serve", ("min_argmin",
                                                          "score"),
                                   lambda: serve_model(dev, kdd_x, kdd_np,
                                                       kdd_truth, kdd_res,
                                                       auto))
    log("serve", json.dumps(serve_out),
        f"(model + serving {time.perf_counter() - t0:.2f} s)")
    g_res, g_out = counted("gauss_0.1_fit", ("min_argmin", "lloyd_step"),
                           lambda: run_oneshot(
        dev, gauss_x, gauss_truth, k=GAUSS["k"], t=GAUSS["t"],
        sites=GAUSS["sites"], second_iters=GAUSS["second_iters"],
        seed=GAUSS["seed"], policy=auto, label="gauss_0.1"))
    log("main_path", json.dumps(g_out))
    for out in (kdd_out, g_out):
        if not (np.isfinite([out["l1_loss"], out["l2_loss"]]).all()
                and out["recall"] > 0.5 and out["preRec"] > 0.5):
            raise AssertionError(f"{out['run']}: implausible result {out}")
    if not np.isfinite(kdd_res["centers"]).all() or \
            kdd_res["centers"].shape != (KDD["k"], KDD["d"]):
        raise AssertionError("kdd centers malformed")

    # ---- 4. gauss again on the plain torch path, same seed, and on the
    # kernel path with another seed (the yardstick of two independent draws)
    for kern in kernels:
        kern.launches = 0
    gkw = dict(k=GAUSS["k"], t=GAUSS["t"], sites=GAUSS["sites"],
               second_iters=GAUSS["second_iters"])
    b_res, b_out = run_oneshot(dev, gauss_x, gauss_truth, seed=GAUSS["seed"],
                               policy=KernelPolicy(backend="blocked"),
                               label="gauss_0.1_blocked", **gkw)
    if any(k.launches for k in kernels):
        raise AssertionError("backend='blocked' launched a kernel")
    s_res, s_out = run_oneshot(dev, gauss_x, gauss_truth,
                               seed=GAUSS["seed"] + 1, policy=auto,
                               label="gauss_0.1_seed+1", **gkw)
    cmp = {"identical_summaries_and_outliers": bool(
               np.array_equal(g_res["summary_ids"], b_res["summary_ids"])
               and np.array_equal(g_res["outlier_ids"],
                                  b_res["outlier_ids"])),
           "centers_max_same_index_diff": float(
               np.abs(g_res["centers"] - b_res["centers"]).max()),
           "kernel_vs_blocked": compare_runs(dev, gauss_x, g_res, b_res),
           "kernel_vs_other_seed": compare_runs(dev, gauss_x, g_res, s_res),
           "blocked": b_out, "other_seed": s_out}
    log("kernel_vs_blocked", json.dumps(cmp))
    # Tolerances.  The kernels and the plain path sum distances in different
    # orders, so a point within an ulp of a round's ball radius can fall on
    # either side of it; from there the sampler draws from a different
    # remainder and the two runs are two draws of the same randomized
    # algorithm.  So: if they never parted, the centers must agree to 1e-4
    # (only Lloyd sums in another order differ); if they did, they must be
    # no further apart than two runs from independent seeds (x1.5 for the
    # spread of that yardstick), in the mass-weighted distance from each
    # center to the other run's nearest (a max is meaningless here: k-means--
    # parks a few low-mass centers on planted outliers, differently per
    # draw), with outlier sets overlapping by Jaccard >= 0.9 and costs within
    # 5% (the planted outliers are shifted by U[-2, 2]^5; only those shifted
    # by little are borderline).
    kb, ks_ = cmp["kernel_vs_blocked"], cmp["kernel_vs_other_seed"]
    ok = (cmp["centers_max_same_index_diff"] <= 1e-4
          if cmp["identical_summaries_and_outliers"] else
          kb["centers_mass_weighted_matched_diff"]
          <= 1.5 * ks_["centers_mass_weighted_matched_diff"])
    if not (ok and kb["outlier_jaccard"] >= 0.9
            and kb["cost_rel_diff"] <= 0.05):
        raise AssertionError(f"kernel path and blocked path disagree: {cmp}")

    # ---- 3c. the paper's Table 3 head-to-head on kddFull-like at the
    # budget of the kdd fit's summary; first min_argmin at the baselines'
    # assignment shape (a site against b of its rows) against its plain
    # version and route against route
    b = h2h_budget(kdd_res)
    site = kdd_x[:ks["n_site"]]
    g = torch.Generator(device="cpu").manual_seed(2)
    c_b = site[torch.randperm(ks["n_site"], generator=g)[:b].to(dev)]
    c_b = c_b.contiguous()
    h2h_fail = []
    for rec in (check_pdist(dev, "kdd_baseline_assign", site, c_b, "l2sq",
                            h2h_fail),
                route_bitwise(dev, "kdd_baseline_assign", site, c_b, "l2sq",
                              h2h_fail)):
        log("check", json.dumps(rec))
        checks.append(rec)
    if h2h_fail:
        raise AssertionError(f"min_argmin at the baselines' shape: "
                             f"{h2h_fail}")
    t0 = time.perf_counter()
    h2h = head_to_head(dev, kdd_x, kdd_truth, b, auto, counted)
    log(f"h2h_s {time.perf_counter() - t0:.2f} (budget {b} per site)")

    # ---- 3d. the streaming service (the "stream" phase)
    stream_out, stream_rows, resident = stream_phase(dev, counted, kernels,
                                                     checks)

    # ---- 3e. the front door (the "session" phase)
    session_out = session_phase(dev, counted, kdd_np, kdd_truth, kdd_x,
                                resident)

    # ---- 3g. the serving scheduler under concurrent clients, the
    # telemetry plane on and off (the "serving" phase)
    serving_out = serving_phase(dev, counted, resident["x"], checks)
    del resident

    # ---- 3f. the one round of communication (the "sharded" phase): its
    # rank processes report their own launch counts
    sharded_out, rank_launches = sharded_phase(
        dev, counted, kdd_np, kdd_x, kdd_truth, kdd_out, gauss_x,
        gauss_truth)
    per_run.update(rank_launches)

    # ---- 3b and 4b. rwkv6-7b serving (prefill + decode), then its
    # plain-WKV twin and the teacher-forcing check
    rwkv_out = rwkv_serving(dev, counted)

    # ---- 3h. rwkv6-7b training (the "train" phase), with the serving
    # model released
    train_out = train_phase(dev, counted)

    # ---- 3i. the dense and moe families (the "lm" phase): plain torch, no
    # kernel of the port on their path; each part's launches are read
    lm_out = lm_phase(dev, counted)

    # ---- 3j. compression, robust aggregation and the elastic runner (the
    # "robust" phase): its rank processes report their own launch counts
    robust_out, robust_launches = robust_phase(dev)
    per_run.update(robust_launches)

    # ---- 3k. the mesh tooling (the "mesh" phase): the paper's job at the
    # pod's size, cluster_job's ranks (reporting their own launch counts),
    # the dry run's cells, DTensor steps
    mesh_out, mesh_checks, mesh_launches = mesh_phase(dev, counted)
    per_run.update(mesh_launches)
    checks += mesh_checks
    launches = {k.name: sum(r[k.name] for r in per_run.values())
                for k in kernels}
    log("main_path_launches", json.dumps(launches))

    # ---- 5. timings at the main path's shapes
    timings = kernel_timings(dev, kdd_x, kdd_res, kdd_model, gauss_x, ks, gs)
    timings += stream_rows + wkv_timings(dev) + wkv_train_timings(dev)
    ladder = route_ladder(dev, kdd_x, gauss_x, ks, gs)

    entries = []
    for name, (src, replaces) in KERNELS.items():
        mine = [r for r in checks if r["kernel"] == name]
        main_row = next(r for r in timings if r["kernel"] == name)
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "timed_shape": main_row["shape_name"],
            "checks": len(mine),
            "argmin_mismatches": sum(r.get("argmin_mismatch", 0)
                                     for r in mine),
        })
    report = {"card": card, "build_s": build_s, "checks": checks,
              "main_path": [kdd_out, g_out], "serve": serve_out,
              "rwkv6_serving": rwkv_out, "train": train_out, "lm": lm_out,
              "robust": robust_out, "mesh": mesh_out,
              "kernel_vs_blocked": cmp, "head_to_head": h2h,
              "stream": stream_out, "session": session_out,
              "serving": serving_out,
              "sharded": sharded_out,
              "h2h_budget_per_site": b, "timings": timings,
              "route_ladder": ladder,
              "launches": launches, "launches_per_run": per_run,
              "kernels": entries,
              "total_s": time.perf_counter() - t_start}
    log(f"total_s {report['total_s']:.1f}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--measure", default=None,
                    help="comma-separated readings of " + ", ".join(MEASURES)
                    + ": run only these (after the fits they need) and print "
                    "them as one JSON line, for comparing two trees in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    card = nvidia_smi()
    if args.measure:
        phases = args.measure.split(",")
        if not set(phases) <= set(MEASURES):
            ap.error(f"--measure takes {MEASURES}, got {phases}")
        print(json.dumps(run_measure(torch.device("cuda", 0), card, phases)))
        return 0
    report = run(torch.device("cuda", 0), card)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1) + "\n")
    print(card)
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
