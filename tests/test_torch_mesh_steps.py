"""The sharded steps against the one-device steps, on the CPU: four gloo
ranks (spawned processes, a ``FileStore`` under ``tmp_path``) form a (2, 2)
``DeviceMesh`` (``data``, ``model``); each rank runs the same SMOKE model
(f32, the same seed) both as DTensors laid out by ``models/sharding.py``
under the steps' ``ShardCtx`` and with ``mesh=None``, on the same batch.

For a SMOKE config of each family (dense, moe, rwkv6, rglru_hybrid,
encdec, and a vlm-frontend dense arch), ZeRO-2 on the dense one, and the
dense one with a batch of 1 (which the data axis does not divide, so it
stays whole on every rank):

* one train step: the loss and the clipping norm (global: every rank's
  shards summed once) agree within rtol 1e-5; every parameter after AdamW
  within rtol 1e-5, atol 1e-7; every gradient of the loss within 1e-5 of
  its leaf's largest magnitude (the sums run in another order across
  ranks; f32);
* prefill's last-position logits and one decode step's logits agree within
  1e-5 of their largest magnitude.

MoE groups are cut from each batch shard's tokens on a mesh (the
reference's ``_group_tokens``), so the moe config fixes
``moe_group_tokens`` to a shard's size in both runs: the same groups,
capacity and drops.
"""
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

B, S, GEN = 4, 16, 4
ARCHS = {"dense": "h2o-danube-1.8b", "moe": "qwen3-moe-235b-a22b",
         "rwkv6": "rwkv6-7b", "rglru_hybrid": "recurrentgemma-9b",
         "encdec": "seamless-m4t-medium", "vlm": "llava-next-mistral-7b",
         "zero2": "h2o-danube-1.8b", "batch1": "h2o-danube-1.8b"}


def _rank_main(rank, n, workdir, fn, args):
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=60))
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def spawn(fn, n, workdir, *args):
    workdir = str(workdir)
    mp.start_processes(_rank_main, args=(n, workdir, fn, args), nprocs=n,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def _cfg(kind):
    from repro_torch.configs import get_config
    cfg = get_config(ARCHS[kind], smoke=True).replace(dtype="float32")
    if kind == "moe":
        cfg = cfg.replace(moe_group_tokens=B // 2)   # a decode shard's tokens
    if kind == "zero2":
        cfg = cfg.replace(zero_stage=2)
    return cfg


def _batch(cfg, b):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int64)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, 8, cfg.frontend_dim)) \
            .astype(np.float32)
    elif cfg.frontend == "vlm_patches":
        batch["patches"] = rng.normal(
            size=(b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _steps_rank(kind):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.steps import (_lay_out, _scope, make_ctx,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models.sharding import (batch_specs, shard_model_,
                                             shard_opt_state_)
    from repro_torch.models.transformer import forward_train, init_params
    from repro_torch.optim import adamw
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = _cfg(kind)
    fsdp = cfg.zero_stage >= 3
    batch = _batch(cfg, 1 if kind == "batch1" else B)
    out = {}

    def sharded():
        return shard_model_(init_params(cfg, 0, device="cpu"), mesh,
                            fsdp_params=fsdp)

    # gradients of the loss
    m0, m1 = init_params(cfg, 0, device="cpu"), sharded()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    l0, _ = forward_train(m0, tb, cfg)
    g0 = torch.autograd.grad(l0, list(m0.parameters()))
    ctx = make_ctx(cfg, mesh)
    with _scope(ctx):
        l1, _ = forward_train(m1, _lay_out(tb, batch_specs(tb, mesh), ctx),
                              cfg, ctx)
        g1 = torch.autograd.grad(l1, list(m1.parameters()))
    out["grad"] = {n: _rel(b.full_tensor(), a) for (n, _), a, b in
                   zip(m0.named_parameters(), g0, g1)}
    out["placements"] = {n: str(p.placements)
                         for n, p in m1.named_parameters()}

    # one train step
    m0, m1 = init_params(cfg, 0, device="cpu"), sharded()
    st0, optc = make_train_step(cfg, None, device="cpu")
    st1, _ = make_train_step(cfg, mesh, device="cpu")
    o0 = adamw.init(m0, optc)
    o1 = shard_opt_state_(adamw.init(m1, optc), mesh)
    _, o0, r0 = st0(m0, o0, batch)
    _, o1, r1 = st1(m1, o1, batch)
    out["loss"] = (float(r0["loss"]), float(r1["loss"]))
    out["grad_norm"] = (float(r0["grad_norm"]), float(r1["grad_norm"]))
    p0 = dict(m0.named_parameters())
    out["params"] = {n: (p.detach().full_tensor(), p0[n].detach())
                     for n, p in m1.named_parameters()}
    out["moments"] = max(_rel(o1.m[n].full_tensor(), o0.m[n])
                         for n in o0.m if o0.m[n].abs().max() > 0)

    # prefill, then one decode step
    m0, m1 = init_params(cfg, 0, device="cpu"), sharded()
    lg0, c0 = make_prefill_step(cfg, None, device="cpu")(m0, batch, S + GEN)
    lg1, c1 = make_prefill_step(cfg, mesh, device="cpu")(m1, batch, S + GEN)
    out["prefill"] = _rel(lg1.full_tensor(), lg0)
    dcfg = cfg.replace(frontend_tokens=8) if cfg.family == "encdec" else cfg
    tok = lg0.argmax(-1, keepdim=True)
    d0, _ = make_serve_step(dcfg, None, device="cpu")(m0, c0, tok)
    d1, _ = make_serve_step(dcfg, mesh, device="cpu")(m1, c1, tok)
    out["decode"] = _rel(d1.full_tensor(), d0)
    return out


@pytest.mark.parametrize("kind", list(ARCHS))
def test_sharded_steps_match_one_device(kind, tmp_path):
    outs = spawn(_steps_rank, 4, tmp_path, kind)
    r = outs[0]
    l0, l1 = r["loss"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    n0, n1 = r["grad_norm"]
    assert abs(n1 - n0) <= 1e-5 * abs(n0)
    bad = {n: e for n, e in r["grad"].items() if not e <= 1e-5}
    assert not bad, bad
    for n, (a, b) in r["params"].items():
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=n)
    assert r["moments"] <= 1e-5
    assert r["prefill"] <= 1e-5 and r["decode"] <= 1e-5, r
    # every rank sees the same whole results
    for o in outs[1:]:
        assert o["loss"] == r["loss"] and o["prefill"] == r["prefill"]
    if kind == "zero2":   # weights TP-only: no Shard on the data axis
        assert all("Shard" not in pl.split(",")[0]
                   for pl in r["placements"].values())


INIT_KINDS = ("dense", "moe", "rwkv6", "rglru_hybrid", "encdec", "vlm",
              "zero2")


def _init_rank(kind):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.sharding import (init_opt_state,
                                             init_sharded_params,
                                             shard_model_, shard_opt_state_)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = _cfg(kind)
    fsdp = cfg.zero_stage >= 3
    want = shard_model_(init_params(cfg, 0, device="cpu"), mesh,
                        fsdp_params=fsdp)
    got = init_sharded_params(cfg, 0, mesh, fsdp_params=fsdp, device="cpu")
    pw, pg = dict(want.named_parameters()), dict(got.named_parameters())
    out = {"names": list(pw) == list(pg),
           "placements": all(pg[n].placements == p.placements
                             for n, p in pw.items()),
           "local_equal": all(torch.equal(pg[n].to_local(), p.to_local())
                              for n, p in pw.items()),
           "meta": any(p.to_local().is_meta for p in pg.values())}
    _, optc = make_train_step(cfg, mesh, device="cpu")
    ow = shard_opt_state_(adamw.init(want, optc), mesh)
    og = init_opt_state(got, optc, mesh)
    out["moments"] = all(
        og_t[n].placements == t.placements and og_t[n].dtype == t.dtype
        and og_t[n].shape == t.shape and not og_t[n].to_local().any()
        for ow_t, og_t in ((ow.m, og.m), (ow.v, og.v))
        for n, t in ow_t.items())
    out["step"] = (og.step.dtype, int(og.step)) == (ow.step.dtype,
                                                   int(ow.step))
    return out


@pytest.mark.parametrize("kind", INIT_KINDS)
def test_sharded_init_matches_init_params(kind, tmp_path):
    """``init_sharded_params`` (a unit at a time from ``meta``) holds, on
    every rank, exactly the shards that ``shard_model_(init_params(...))``
    cuts from the whole model (the same draws, bit for bit), and
    ``init_opt_state`` the zero moments ``shard_opt_state_`` lays out."""
    for r in spawn(_init_rank, 4, tmp_path, kind):
        assert r == {"names": True, "placements": True, "local_equal": True,
                     "meta": False, "moments": True, "step": True}, r


def _launcher_rank(ckpt_dir, argv):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import train
    # the launcher's production mesh needs 256 ranks: a (2, 2) one stands
    # in for it, the rest of the launcher as it runs on a pod
    train.make_production_mesh = lambda **_: init_device_mesh(
        "cpu", (2, 2), mesh_dim_names=("data", "model"))
    train.main(argv + ["--steps", "2", "--ckpt-dir", ckpt_dir])
    dist.barrier()   # rank 0's checkpoint is written before any reads it
    train.main(argv + ["--steps", "3", "--ckpt-dir", ckpt_dir])
    return True


def test_launcher_trains_and_resumes_on_a_mesh(tmp_path):
    """``python -m repro_torch.launch.train --mesh single`` on 4 gloo ranks
    (a (2, 2) mesh in place of the pod's): two steps, a resume from the
    step-1 checkpoint, a third step.  Its last checkpoint (gathered to rank
    0's host) holds what three one-device steps hold: every weight and
    moment within rtol 1e-5, atol 1e-7 (f32; sums in another order)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import _leaves, build_model
    from repro_torch.optim import adamw
    argv = ["--arch", "h2o-danube-1.8b", "--smoke", "--batch", "4", "--seq",
            "16", "--ckpt-every", "1", "--set", "dtype=float32", "--device",
            "cpu"]
    mesh_dir, one_dir = str(tmp_path / "mesh"), str(tmp_path / "one")
    spawn(_launcher_rank, 4, tmp_path, mesh_dir, argv + ["--mesh", "single"])
    train.main(argv + ["--steps", "3", "--ckpt-dir", one_dir])
    cfg = get_config("h2o-danube-1.8b", smoke=True).replace(dtype="float32")
    _, optc = make_train_step(cfg, None, device="cpu")
    like = build_model(cfg, "meta")
    like = train.train_state_tree(like, adamw.init(like, optc))
    got, s1 = CheckpointManager(mesh_dir).restore(like)
    want, s2 = CheckpointManager(one_dir).restore(like)
    assert s1 == s2 == 2
    flat_g = list(_leaves({"p": got[0], "m": got[1].m,
                                 "v": got[1].v}))
    flat_w = dict(_leaves({"p": want[0], "m": want[1].m,
                                 "v": want[1].v}))
    assert len(flat_g) == len(flat_w) and int(got[1].step) == 3
    for k, a in flat_g:
        np.testing.assert_allclose(a, flat_w[k], rtol=1e-5, atol=1e-7,
                                   err_msg="/".join(k))
