"""Production training launcher, port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--smoke] \
        [--steps N] [--mesh auto] [--ckpt-dir DIR] [--set key=value ...] \
        [--device cuda|cpu]

One device: ``--mesh auto`` runs with ``mesh=None``.  ``single`` and
``multi`` build the reference's TPU production mesh (``launch/mesh.py``),
which the port does not have, so they raise.  The loop is the reference's:
the token pipeline, the train step (forward, backward, AdamW), a
checkpoint of (params, opt_state) every ``--ckpt-every`` steps in the
reference's layout, a resume from the latest one, and the straggler
monitor fed each step's time.  It prints the reference's lines.  An arch
with a modality frontend is refused: the pipeline feeds tokens only, and
the reference's launcher fails on it (``ROADMAP.md`` queue 3, item 8).
Either package's launcher resumes the other's checkpoint, but for bf16
leaves: the reference's restore cannot read those back, not even its own
(``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import PipelineConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import (build_model, init_params,
                                            load_params_, params_tree)
from repro_torch.optim import adamw
from repro_torch.runtime.straggler import StragglerMonitor


def train_state_tree(model, opt: adamw.AdamWState):
    """(params, opt_state) in the reference's checkpoint layout."""
    return params_tree(model), adamw.opt_state_tree(opt)


def restore_train_state(ckpt: CheckpointManager, model, cfg, optc, device,
                        step: int | None = None):
    """Load the checkpoint at ``step`` (default: latest) into ``model``;
    returns (model, the restored opt_state, the checkpoint's step)."""
    like_model = build_model(cfg, "meta")
    like_opt = adamw.init(like_model, optc)
    (params, opt_tree), step = ckpt.restore(
        train_state_tree(like_model, like_opt), step, device=device)
    load_params_(model, params)
    return model, adamw.opt_state_from_numpy(opt_tree, cfg, device), step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="auto", choices=["auto", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if overrides:
        cfg = cfg.replace(**overrides)

    if cfg.frontend != "none":
        raise ValueError(
            f"--arch {args.arch} has a {cfg.frontend!r} frontend, and the "
            f"token pipeline feeds tokens only: the reference's launcher "
            f"fails there (KeyError: 'patches' or 'frames'; ROADMAP.md queue "
            f"3, item 8).  Train it through make_train_step with its "
            f"features in the batch")
    if args.mesh != "auto":
        raise NotImplementedError(
            f"--mesh {args.mesh} builds the reference's TPU production mesh "
            f"(launch/mesh.py), which is not ported; the port trains on one "
            f"device with --mesh auto (ROADMAP.md, queue 1)")
    n_dev = 1
    print(f"arch={cfg.name} devices={n_dev} mesh=None")

    model = init_params(cfg, args.seed, device=dev)
    step_fn, optc = make_train_step(cfg, None, device=dev)
    opt = adamw.init(model, optc)

    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
    monitor = StragglerMonitor(n_sites=max(n_dev, 1), device=dev)

    start = 0
    if ckpt.latest_step() is not None:
        model, opt, start = restore_train_state(ckpt, model, cfg, optc,
                                                dev)
        start += 1
        print(f"resumed from step {start - 1}")

    for step in range(start, args.steps):
        batch = {"tokens": torch.as_tensor(pipe.global_batch(step)["tokens"],
                                           device=dev)}
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.observe(np.full(max(n_dev, 1), dt, np.float32))
        if step % 10 == 0:
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f} ms")
        if step % args.ckpt_every == args.ckpt_every - 1:
            ckpt.save(step, train_state_tree(model, opt))
    ckpt.wait()
    print(f"done; checkpoints at {ckpt.all_steps()}")


if __name__ == "__main__":
    main()
