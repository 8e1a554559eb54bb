"""The port's launch tooling against the reference's, on the CPU:
``launch/shapes.py``, ``launch/hlo.py``'s wire model and cost mode,
``launch/mesh.py``, ``launch/cluster_job.py``, ``launch/cluster_dryrun.py``
and the training launcher's ``--mesh``.

The cost mode mirrors the reference's five analyzer tests
(``tests/test_hlo_optim.py``): a loop of L matmuls counts L x the flops, a
batched product 2 * out * contract, an all-gather and a reduce-scatter on a
fake group of 16 give the ring model's bytes, the materialised bytes stay
at or below the raw bytes; and a sharded matmul's per-rank flops times the
ranks equals the global flops (DTensor's propagation on global shapes is
not counted).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.hlo as RH
import repro.launch.shapes as RSH
from repro.configs import get_config as ref_get_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import hlo as H
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import make_production_mesh, mesh_shape

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dt(d):
    return {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32,
            jnp.dtype("bfloat16"): torch.bfloat16}[np.dtype(d)]


# ------------------------------------------------------------ shapes
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_structs_match_the_reference(arch):
    """``input_structs`` and ``decode_structs``: equal shapes and dtypes
    for every shape of the arch (FULL configs; meta tensors, no data)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert list(SH.SHAPES) == list(RSH.SHAPES)
    for name, sp in SH.SHAPES.items():
        rsp = RSH.SHAPES[name]
        assert (sp.seq_len, sp.global_batch, sp.kind) == \
            (rsp.seq_len, rsp.global_batch, rsp.kind)
        ok, why = SH.cell_supported(cfg, sp)
        assert (ok, why) == RSH.cell_supported(rcfg, rsp)
        if sp.kind in ("train", "prefill"):
            mine, ref = SH.input_structs(cfg, sp), RSH.input_structs(rcfg, rsp)
        elif ok:
            (mine, tok), (ref, rtok) = SH.decode_structs(cfg, sp), \
                RSH.decode_structs(rcfg, rsp)
            assert tuple(tok.shape) == tuple(rtok.shape)
        else:
            continue
        assert set(mine) == set(ref), (name, set(mine) ^ set(ref))
        for k, t in mine.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), (name, k)
            assert t.dtype == _dt(ref[k].dtype), (name, k)


def test_concrete_batch_draws_from_its_generator():
    cfg = get_config("llava-next-mistral-7b", smoke=True)
    a = SH.concrete_batch(cfg, 32, 2, torch.Generator().manual_seed(3))
    b = SH.concrete_batch(cfg, 32, 2, torch.Generator().manual_seed(3))
    assert set(a) == {"patches", "tokens"}
    assert a["tokens"].shape == (2, 32 - cfg.frontend_tokens)
    assert a["tokens"].dtype == torch.int32 and int(a["tokens"].max()) < \
        cfg.vocab
    for k in a:
        assert torch.equal(a[k], b[k])


# ------------------------------------------------------------ wire model
def test_wire_bytes_match_the_reference():
    for op in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
               "collective-permute"):
        for n in (1, 2, 4, 16, 256, 512):
            for s in (0.0, 1.0, 4096.0, 3.5e9):
                assert H._wire_bytes(op, s, n) == RH._wire_bytes(op, s, n)


# ------------------------------------------------------------ cost mode
def test_loop_of_matmuls_counts_each_pass():
    x, w = torch.randn(128, 128), torch.randn(128, 128)

    def f(x, w):
        for _ in range(8):
            x = x @ w
        return x

    _, a = H.analyze_step(f, x, w)
    assert a["flops"] == 2 * 128 ** 3 * 8


def test_batched_product_flops_are_two_out_contract():
    a, b = torch.randn(4, 32, 16), torch.randn(4, 16, 8)
    _, r = H.analyze_step(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                          a, b)
    assert r["flops"] == 2 * 4 * 32 * 8 * 16


def test_materialised_bytes_below_raw():
    x, w = torch.randn(256, 256), torch.randn(256, 256)
    _, a = H.analyze_step(
        lambda x, w: torch.relu((torch.tanh(x) * 2 + 1) @ w) - 0.5, x, w)
    assert 0 < a["hbm_bytes"] <= a["hbm_bytes_raw"]


@pytest.mark.parametrize("name", ["min_argmin", "score", "lloyd_step",
                                  "wkv_forward"])
def test_a_kernel_launch_is_counted_by_its_own_formula(name):
    """A launch through ``ctypes`` dispatches no aten op: the counter bills
    the kernel's own ``flops`` and its inputs and outputs once.  Here each
    kernel's entry runs with a stand-in launch that only bumps its count
    (the card's launch path is not run on the CPU)."""
    import importlib

    from repro_torch.kernels._build import CudaKernel
    mod = importlib.import_module(
        {"min_argmin": "repro_torch.kernels.pdist.kernel",
         "score": "repro_torch.kernels.score.kernel",
         "lloyd_step": "repro_torch.kernels.lloyd.kernel",
         "wkv_forward": "repro_torch.kernels.wkv.kernel"}[name])
    real = next(v for v in vars(mod).values()
                if isinstance(v, CudaKernel) and v.name == name)
    x, c = torch.randn(64, 8), torch.randn(5, 8)
    args = {"min_argmin": (x, c), "score": (x, c, 1.0),
            "lloyd_step": (x, torch.ones(64), c),
            "wkv_forward": tuple(torch.randn(3, 16, 4) for _ in range(4))
            + (torch.randn(3, 4), torch.randn(3, 4, 4))}[name]
    want = {"min_argmin": 3 * 64 * 5 * 8, "score": 3 * 64 * 5 * 8,
            "lloyd_step": 3 * 64 * 5 * 8 + 2 * 64 * 8,
            "wkv_forward": 4 * 3 * 16 * 4 * 4}[name]
    out = torch.zeros(7)

    def launch(kern, *a, **k):
        kern.launches += 1
        return out

    kern = CudaKernel(name, launch, real.flops)
    _, r = H.analyze_step(kern, *args)
    b = sum(t.numel() * t.element_size() for t in args
            if isinstance(t, torch.Tensor)) + out.numel() * 4
    assert (r["flops"], r["hbm_bytes"]) == (want, b)
    assert [(w["kind"], w["op"], w["count"]) for w in r["rows"]] == \
        [("kernel", name, 1)]
    _, r = H.analyze_step(real, *args)   # on the CPU: no launch, no count
    assert kern.launches == 1 and not CudaKernel.observers


_FAKE16 = r"""
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.hlo import analyze_step
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("data",))
out = {}
with FakeTensorMode():
    t = distribute_tensor(torch.empty(1024, 256), mesh, [Shard(0)])
    out["ag"] = analyze_step(lambda t: t.redistribute(mesh, [Replicate()]),
                             t)[1]["collectives"]
    p = DTensor.from_local(torch.empty(1024, 256), mesh, [Partial()])
    out["rs"] = analyze_step(lambda t: t.redistribute(mesh, [Shard(0)]),
                             p)[1]["collectives"]
    x = distribute_tensor(torch.empty(512, 128), mesh, [Shard(0)])
    w = distribute_tensor(torch.empty(128, 64), mesh, [Replicate()])
    out["mm"] = analyze_step(lambda a, b: a @ b, x, w)[1]["flops"]
dist.destroy_process_group()
json.dump(out, sys.stdout)
"""


def test_collectives_on_a_fake_group_of_16():
    """An all-gather of a (1024, 256) f32 tensor sharded 16 ways and a
    reduce-scatter of a (1024, 256) partial sum: the reference's ring
    model on the local operand; a row-sharded matmul's flops per rank x 16
    is the global 2 m k n (a subprocess: the process group is global)."""
    import json
    r = subprocess.run([sys.executable, "-c", _FAKE16], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH="src"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout)
    ag, rs = out["ag"]["all-gather"], out["rs"]["reduce-scatter"]
    assert ag["count"] == 1 and rs["count"] == 1
    assert ag["wire_bytes"] == RH._wire_bytes("all-gather", 64 * 256 * 4, 16)
    assert rs["wire_bytes"] == \
        RH._wire_bytes("reduce-scatter", 1024 * 256 * 4, 16)
    assert out["mm"] * 16 == 2 * 512 * 128 * 64


# ------------------------------------------------------------ meshes
def test_mesh_shapes_and_the_rank_check():
    assert mesh_shape() == ((16, 16), ("data", "model"))
    assert mesh_shape(multi_pod=True) == ((2, 16, 16),
                                          ("pod", "data", "model"))
    assert mesh_shape(dp_tp=(64, 4)) == ((64, 4), ("data", "model"))
    with pytest.raises(ValueError, match="256 ranks.*has 1"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_launcher_mesh_needs_the_production_ranks(tmp_path):
    from repro_torch.launch.train import main
    for mesh in ("single", "multi"):
        with pytest.raises(ValueError, match="ranks; the process group"):
            main(["--arch", "h2o-danube-1.8b", "--smoke", "--mesh", mesh,
                  "--device", "cpu", "--steps", "1",
                  "--ckpt-dir", str(tmp_path)])


# ------------------------------------------------------------ the paper's job
def test_cluster_job_prints_the_reference_lines():
    """Four gloo ranks on the CPU, one site each, and the reference's
    program on one device: the same four lines, and the outliers found."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    args = ["--n", "8000", "--k", "8", "--t", "80"]
    mine = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster_job", "--sites",
         "4", *args, "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert mine.returncode == 0, mine.stderr[-2000:]
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.cluster_job", "--sites", "1",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    lm = mine.stdout.strip().splitlines()
    lr = ref.stdout.strip().splitlines()
    assert [ln.split("=")[0].split(":")[0] for ln in lm] == \
        [ln.split("=")[0].split(":")[0] for ln in lr]
    assert lm[0].startswith("sites=4 n=8000 partition=random wall=")
    scores = dict(kv.split("=") for kv in lm[3].split())
    assert float(scores["preRec"]) == 1.0 and float(scores["recall"]) >= 0.9


def test_cluster_dryrun_counts_each_site_and_the_gather():
    """The paper's job small on the CPU: 4 sites, the busiest site's
    counted work plus the second level's, one gather of the records."""
    from repro_torch.launch.cluster_dryrun import run
    rec, ctx = run(sites=4, n=2048, d=8, k=5, t=64, device="cpu")
    assert rec["status"] == "ok" and rec["chips"] == 4
    assert rec["hlo_flops"] == rec["site_flops"]["max"] + \
        rec["second_level"]["flops"]
    records = sum(p.shape[0] for p in ctx["points"])
    assert rec["comm_records"] == records < 4 * 2048
    assert rec["collectives"]["all-gather"]["count"] == 1
    assert rec["wire_bytes"] == rec["collectives"]["all-gather"][
        "operand_bytes"] * 3
    assert min(rec[k] for k in ("compute_s", "memory_s", "collective_s")) > 0
    truth = set(ctx["out_ids"].tolist())
    found = set(ctx["result"]["outlier_ids"].tolist())
    assert len(truth & found) >= 0.9 * len(truth)
