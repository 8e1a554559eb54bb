"""The port's dry run (``python -m repro_torch.launch.dryrun``): the
counterparts of the reference's ``tests/test_dryrun.py``.  Each cell runs
in a subprocess (its fake process group of 256 or 512 ranks is global to
the process) on fake tensors, and its record is held to sane roofline
terms; the train cell's argument bytes to the reckoning from the
reference's own PartitionSpecs."""
import functools
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np

import repro.models.sharding as RS
from repro.configs import get_config as ref_get_config
from repro.launch.shapes import SHAPES, input_structs
from repro.models.transformer import init_params as ref_init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cell(tmp_path, arch, shape, mesh="single"):
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-1000:])
    return json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                      .read_text())


def _reckoned_argument_bytes(arch, shape_name, mesh_shape, names):
    """Local bytes on one rank of the parameters, the two AdamW moments and
    the batch, each sharded by the reference's rules (``_leaf_spec``,
    ``_stack_depth``, ``fix_divisibility``; moments FSDP-sharded)."""
    cfg = ref_get_config(arch)
    mesh = SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=mesh_shape))
    sizes = dict(zip(names, mesh_shape))
    fsdp_t = RS.fsdp_axes(mesh)
    fsdp = fsdp_t if len(fsdp_t) > 1 else fsdp_t[0]

    def local(shape, spec):
        n = 1
        for d, e in zip(shape, list(spec) + [None] * len(shape)):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= d // math.prod(sizes[a] for a in axes)
        return n

    tree = jax.eval_shape(functools.partial(ref_init_params, cfg),
                          jax.random.key(0))
    total = 0
    state_bytes = np.dtype(cfg.opt_state_dtype).itemsize
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        names_ = [str(k.key) for k in path]
        depth = RS._stack_depth(path)
        s = RS._leaf_spec("/".join(names_), len(leaf.shape) - depth, fsdp)
        moments = RS.fix_divisibility(
            RS.P(*([None] * depth + list(s))), leaf.shape, mesh)
        if cfg.zero_stage < 3:
            s = RS._strip_axes(s, set(fsdp_t))
        weights = RS.fix_divisibility(
            RS.P(*([None] * depth + list(s))), leaf.shape, mesh)
        total += local(leaf.shape, weights) * leaf.dtype.itemsize
        total += 2 * local(leaf.shape, moments) * state_bytes
    for st in input_structs(cfg, SHAPES[shape_name]).values():
        spec = RS.fix_divisibility(
            RS.P(fsdp_t, *([None] * (len(st.shape) - 1))), st.shape, mesh)
        total += local(st.shape, spec) * st.dtype.itemsize
    return total


def test_train_cell_runs_single_pod(tmp_path):
    rec = _run_cell(tmp_path, "h2o-danube-1.8b", "train_4k")
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    assert rec["hlo_flops"] > rec["model_flops_per_chip"] * 0.5
    assert 0.05 < rec["useful_flops_ratio"] < 1.5
    coll = rec["collectives"]
    assert coll.get("all-reduce", {}).get("count", 0) + \
        coll.get("reduce-scatter", {}).get("count", 0) > 0
    # parameters, moments and batch: the reference's layout, within HBM
    arg = rec["memory"]["argument_bytes"]
    assert arg == _reckoned_argument_bytes("h2o-danube-1.8b", "train_4k",
                                           (16, 16), ("data", "model"))
    assert arg < 80e9
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_decode_cell_runs_multi_pod(tmp_path):
    rec = _run_cell(tmp_path, "h2o-danube-1.8b", "decode_32k", mesh="multi")
    assert rec["status"] == "ok"
    assert rec["chips"] == 512
    assert rec["hlo_flops"] > 0 and rec["memory"]["argument_bytes"] > 0


def test_long_context_skip_policy(tmp_path):
    rec = _run_cell(tmp_path, "qwen2.5-32b", "long_500k")
    assert rec["status"] == "skipped"
    rec2 = _run_cell(tmp_path, "rwkv6-7b", "long_500k")
    assert rec2["status"] == "ok"
