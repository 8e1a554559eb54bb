"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference's (``repro.models.sharding``), on the CPU.

* Every parameter of all ten archs, FULL and SMOKE, on the logical meshes
  (16, 16), (2, 16, 16), (128, 2) and (64, 4), with ``fsdp_params`` True
  and False: the port's spec equals the reference's with the layer-stack
  dims dropped.  The reference's rules (``_leaf_spec``, ``_stack_depth``,
  ``fix_divisibility``) are called with a duck-typed mesh (``axis_names``
  and ``devices.shape`` are all they read) and the reference's flat name
  of each port parameter (``transformer.reference_key``); for SMOKE the
  reference's own parameter tree (``jax.eval_shape`` of its
  ``init_params``) is held to the port's names and stacked shapes first.
* The whole ``param_specs`` / ``batch_specs`` / ``cache_specs`` of the
  reference on a real (2, 2, 2) JAX mesh, in a subprocess with 8 host
  devices, against the port's on a logical mesh of the same shape.
* ``to_placements`` and ``shard_model_`` on a fake process group.
"""
import functools
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import repro.models.sharding as RS
from repro.configs import get_config as ref_get_config
from repro.models.transformer import init_params as ref_init_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.shapes import ShapeSpec, decode_structs, input_structs
from repro_torch.models.sharding import (_strip_axes, batch_specs,
                                         cache_specs, fix_divisibility,
                                         param_specs, to_placements)
from repro_torch.models.transformer import build_model, reference_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (128, 2): ("data", "model"), (64, 4): ("data", "model")}


def port_mesh(shape, names):
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def ref_mesh(shape, names):
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def as_tuple(spec):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def ref_spec(name, shape, mesh, fsdp_params):
    """The reference's ``param_specs`` rule for the port parameter
    ``name`` (its stacked leaf's spec, stack dims dropped)."""
    keys, index = reference_key(name)
    path = [SimpleNamespace(key=k) for k in keys]
    depth = RS._stack_depth(path)
    assert depth == len(index), (name, depth, index)
    fsdp_t = RS.fsdp_axes(mesh)
    fsdp = fsdp_t if len(fsdp_t) > 1 else fsdp_t[0]
    s = RS._leaf_spec("/".join(keys), len(shape), fsdp)
    if not fsdp_params:
        s = RS._strip_axes(s, set(fsdp_t))
    stacked = (1,) * depth + tuple(shape)   # stack dims are None anyway
    full = RS.fix_divisibility(RS.P(*([None] * depth + list(s))), stacked,
                               mesh)
    return as_tuple(full)[depth:]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, "meta")
    if smoke:   # the reference's tree: same names, stacked shapes
        tree = jax.eval_shape(
            functools.partial(ref_init_params, ref_get_config(arch, True)),
            jax.random.key(0))
        ref = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
        seen = {}
        for n, p in model.named_parameters():
            keys, index = reference_key(n)
            seen.setdefault("/".join(keys), set()).add(index)
            assert ref["/".join(keys)][len(index):] == tuple(p.shape), n
        assert set(seen) == set(ref)
    for shape, names in MESHES.items():
        pm, rm = port_mesh(shape, names), ref_mesh(shape, names)
        for fsdp_params in (True, False):
            specs = param_specs(model, pm, fsdp_params=fsdp_params)
            for n, p in model.named_parameters():
                assert specs[n] == ref_spec(n, tuple(p.shape), rm,
                                            fsdp_params), (n, shape)


def test_fix_divisibility_and_strip_match_the_reference():
    pm, rm = port_mesh((2, 16, 16), ("pod", "data", "model")), \
        ref_mesh((2, 16, 16), ("pod", "data", "model"))
    for spec, shape in (((("pod", "data"), "model"), (64, 48)),
                        ((("pod", "data"), "model"), (2, 256206)),
                        (("model", None, ("pod", "data")), (128, 5, 96)),
                        ((("pod", "data"), None), (1, 1))):
        assert fix_divisibility(spec, shape, pm) == \
            as_tuple(RS.fix_divisibility(RS.P(*spec), shape, rm))
        assert _strip_axes(spec, {"pod", "data"}) == \
            as_tuple(RS._strip_axes(RS.P(*spec), {"pod", "data"}))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = port_mesh((2, 16, 16), ("pod", "data", "model"))
    assert to_placements((("pod", "data"), "model"), m) == \
        [Shard(0), Shard(0), Shard(1)]
    assert to_placements((None, None), m) == [Replicate()] * 3
    assert to_placements(("model", None, "data"), m) == \
        [Replicate(), Shard(2), Shard(0)]
    with pytest.raises(ValueError, match="order"):
        to_placements((("data", "pod"),), m)


_SUBPROCESS = r"""
import functools, json, sys
import jax
from jax.sharding import PartitionSpec
from repro.configs import ARCH_IDS, get_config
from repro.launch.shapes import ShapeSpec, decode_structs, input_structs
from repro.models.sharding import batch_specs, cache_specs, param_specs
from repro.models.transformer import init_params

def enc(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
shape = ShapeSpec("adhoc", 64, 8, "decode")
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch, smoke=True)
    pt = jax.eval_shape(functools.partial(init_params, cfg),
                        jax.random.key(0))
    rec = {}
    for fsdp in (True, False):
        sp = param_specs(pt, mesh, fsdp_params=fsdp)
        rec[f"params{int(fsdp)}"] = {
            "/".join(str(k.key) for k in p): enc(s) for p, s in
            jax.tree_util.tree_leaves_with_path(sp)}
    b = batch_specs(input_structs(cfg, ShapeSpec("adhoc", 64, 8, "train")),
                    mesh)
    rec["batch"] = {k: enc(v) for k, v in b.items()}
    cache, _ = decode_structs(cfg, shape)
    c = cache_specs(cache, mesh, cfg)
    rec["cache"] = {k: enc(v) for k, v in c.items()}
    out[arch] = rec
json.dump(out, sys.stdout)
"""


def _tup(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def test_whole_specs_match_the_reference_on_eight_devices():
    """The reference's param / batch / cache specs on a real (2, 2, 2)
    mesh of 8 host devices (a subprocess: the device count is fixed when
    jax starts) against the port's, every SMOKE arch."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _SUBPROCESS], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout)
    mesh = port_mesh((2, 2, 2), ("pod", "data", "model"))
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, "meta")
        for fsdp in (True, False):
            specs = param_specs(model, mesh, fsdp_params=fsdp)
            want = ref[arch][f"params{int(fsdp)}"]
            for n, spec in specs.items():
                keys, index = reference_key(n)
                assert spec == _tup(want["/".join(keys)])[len(index):], \
                    (arch, n)
        b = input_structs(cfg, ShapeSpec("adhoc", 64, 8, "train"))
        assert {k: v for k, v in batch_specs(b, mesh).items()} == \
            {k: _tup(v) for k, v in ref[arch]["batch"].items()}, arch
        cache, _ = decode_structs(cfg, ShapeSpec("adhoc", 64, 8, "decode"))
        assert cache_specs(cache, mesh, cfg) == \
            {k: _tup(v) for k, v in ref[arch]["cache"].items()}, arch


def test_shard_model_lays_out_every_parameter_on_a_fake_group():
    """``shard_model_`` on a fake group of 16 ranks, (4, 4) mesh: every
    parameter becomes a DTensor with its spec's placements and the local
    shape those imply; ZeRO-2 keeps the weights TP-only and
    ``shard_opt_state_`` gives the moments the FSDP layout."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models.sharding import (param_spec, shard_model_,
                                             shard_opt_state_)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        for fsdp in (True, False):
            model = shard_model_(init_params(cfg, 0, device="cpu"), mesh,
                                 fsdp_params=fsdp)
            for n, p in model.named_parameters():
                assert isinstance(p, DTensor) and p.requires_grad
                spec = param_spec(n, tuple(p.shape), mesh, fsdp_params=fsdp)
                assert list(p.placements) == to_placements(spec, mesh), n
            opt = shard_opt_state_(adamw.init(model, adamw.AdamWConfig()),
                                   mesh)
            for n, m in opt.m.items():
                spec = param_spec(n, tuple(m.shape), mesh)
                assert list(m.placements) == to_placements(spec, mesh), n
                assert list(opt.v[n].placements) == list(m.placements)
    finally:
        dist.destroy_process_group()
