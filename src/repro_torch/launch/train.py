"""Production training launcher, port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--smoke] \
        [--steps N] [--mesh auto] [--ckpt-dir DIR] [--set key=value ...] \
        [--device cuda|cpu]

One device: ``--mesh auto`` runs with ``mesh=None``.  ``single`` and
``multi`` (and ``auto`` on 256 ranks or more) build the production
``DeviceMesh`` (``launch/mesh.py``) over the ranks ``torchrun`` starts (or
a default group already initialized), lay the model and its moments out
by ``models/sharding.py`` and train on DTensors; with another number of
ranks ``make_production_mesh`` raises a ``ValueError`` naming both counts.
On a mesh the model is drawn one layer at a time and each rank keeps only
its shards, and the moments are made sharded.  A checkpoint holds the
whole tensors in the reference's layout: gathered one leaf at a time to
rank 0's host, which writes them; a resume reads them on each rank's host
and cuts them into its shards a leaf at a time.  So a card never holds the
whole state, but a host does (``ROADMAP.md``).  The loop is the
reference's:
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
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import PipelineConfig, TokenPipeline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import _whole, make_train_step
from repro_torch.models.layers import is_dtensor
from repro_torch.models.sharding import (init_opt_state,
                                         init_sharded_params, load_sharded,
                                         load_sharded_params, param_specs)
from repro_torch.models.transformer import (build_model, init_params,
                                            load_params_, params_tree,
                                            tensor_from_numpy)
from repro_torch.optim import adamw
from repro_torch.runtime.straggler import StragglerMonitor


def train_state_tree(model, opt: adamw.AdamWState, *, keep: bool = True):
    """(params, opt_state) in the reference's checkpoint layout.  DTensor
    leaves are gathered whole one at a time (a collective: every rank
    calls it) and moved to the host at once, so a card holds at most one
    whole leaf beyond its shards; a rank with ``keep`` False drops them and
    gets None."""
    if any(is_dtensor(p) for p in model.parameters()):
        def host(t):
            w = _whole(t.detach())
            return w.cpu() if keep else None
        whole = {n: host(p) for n, p in model.named_parameters()}
        m = {n: host(t) for n, t in opt.m.items()}
        v = {n: host(t) for n, t in opt.v.items()}
        if not keep:
            return None
        from repro_torch.models.transformer import stack_layers
        return stack_layers(whole), adamw.opt_state_tree(
            adamw.AdamWState(step=opt.step.cpu(), m=m, v=v))
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


def restore_sharded_train_state(ckpt: CheckpointManager, cfg, optc, mesh,
                                device, step: int | None = None):
    """:func:`restore_train_state` on ``mesh``: the checkpoint read to the
    host, then each leaf moved to ``device`` and cut into this rank's
    shards one at a time (the weights by ``param_specs``, the moments by
    the FSDP rules).  Returns (model, opt_state, the checkpoint's step)."""
    like_model = build_model(cfg, "meta")
    like_opt = adamw.init(like_model, optc)
    (params, opt_tree), step = ckpt.restore(
        train_state_tree(like_model, like_opt), step)
    model = load_sharded_params(cfg, params, mesh,
                                fsdp_params=(cfg.zero_stage >= 3),
                                device=device)
    specs = param_specs(like_model, mesh)   # the moments': the FSDP rules
    opt = adamw.AdamWState(
        step=tensor_from_numpy(opt_tree.step).to(device, torch.int32),
        m=load_sharded(opt_tree.m, specs, mesh, device),
        v=load_sharded(opt_tree.v, specs, mesh, device))
    return model, opt, step


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
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        # started by torchrun: its environment names the group
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dev = torch.device("cuda", torch.cuda.current_device())
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = None
    if args.mesh != "auto" or n_dev >= 256:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                    device_type=dev.type)
    print(f"arch={cfg.name} devices={n_dev} mesh="
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None}")

    step_fn, optc = make_train_step(cfg, mesh, device=dev)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
    monitor = StragglerMonitor(n_sites=max(n_dev, 1), device=dev)

    start = 0
    resume = ckpt.latest_step() is not None
    if mesh is None:
        model = init_params(cfg, args.seed, device=dev)
        opt = adamw.init(model, optc)
        if resume:
            model, opt, start = restore_train_state(ckpt, model, cfg, optc,
                                                    dev)
    elif resume:
        model, opt, start = restore_sharded_train_state(ckpt, cfg, optc,
                                                        mesh, dev)
    else:
        # a unit at a time: no rank holds the whole model or its moments
        model = init_sharded_params(cfg, args.seed, mesh,
                                    fsdp_params=(cfg.zero_stage >= 3),
                                    device=dev)
        opt = init_opt_state(model, optc, mesh)
    if resume:
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
            tree = train_state_tree(model, opt, keep=(rank == 0))
            if rank == 0:
                ckpt.save(step, tree)
    ckpt.wait()
    print(f"done; checkpoints at {ckpt.all_steps()}")


if __name__ == "__main__":
    main()
