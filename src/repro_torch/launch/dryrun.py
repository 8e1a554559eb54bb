"""Production-mesh dry run: every (architecture x input shape x mesh) cell
runs one step on fake tensors over a fake process group of the mesh's rank
count, and its roofline terms are counted.  Port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell with ``jax.jit(...,
in_shardings=...)`` on 512 placeholder devices and reads the partitioned
HLO.  Here one process is rank 0 of a ``fake`` group of 256 (``--mesh
multi``: 512) ranks: the model is built under ``FakeTensorMode`` (shapes,
no memory), laid out on the production ``DeviceMesh`` by
``models/sharding.py``, and the step (forward, backward and AdamW; a
prefill; or one decode step from ``decode_structs``) runs once under
``launch/hlo.py``'s counter.  DTensor inserts the collectives, the fake
group performs none, and nothing is computed.

Per cell the record has the reference's keys.  ``lower_s`` is the time to
build and lay out the model and its inputs, ``compile_s`` the counted
step's; ``raw_cost_analysis`` holds the matrix-product flops alone and the
raw bytes.  ``memory.argument_bytes`` is the exact local bytes of the
parameters, moments, batch and cache; ``temp_bytes`` the peak of the bytes
the step allocated; ``alias_bytes`` what a train step updates in place
(parameters and moments), as the reference's donation.

The roofline terms are reckoned against one H100's published peaks
(NVIDIA's data sheet, SXM, dense), not measured.  A collective whose group
lies in one 8-GPU node is priced at NVLink's rate, one that spans nodes at
the node's InfiniBand rate.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi # 512 ranks
Artifacts: one JSON per cell under artifacts/dryrun/.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.hlo import analyze_step
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.launch.shapes import (SHAPES, cell_supported, decode_config,
                                       decode_structs, input_structs)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.sharding import (batch_specs, cache_specs,
                                         shard_model_, shard_opt_state_,
                                         to_placements)
from repro_torch.models.transformer import build_model
from repro_torch.optim import adamw

# One H100 SXM (NVIDIA's data sheet; the hopper-kernels guide's table)
PEAK_FLOPS = 989e12        # bf16 dense tensor-core flop/s
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s each way, to the other GPUs of a node
# HGX H100 nodes give each GPU one 400 Gb/s InfiniBand NDR port (NVIDIA's
# DGX H100 / HGX H100 system data sheets): 50e9 bytes/s each way
INTER_NODE_BW = 50e9


def _jsonable(x):
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return str(x)


def fake_device_type() -> str:
    """``cuda`` where the torch build has CUDA (fake CUDA tensors need no
    card), else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_world(n: int):
    """The default process group as rank 0 of a ``fake`` group of ``n``
    ranks for the block, torn down after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group to be "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tensors) -> int:
    from repro_torch.models.layers import is_dtensor
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in tensors)


def _fake_zeros(meta: dict, specs: dict, mesh, dev) -> dict:
    """DTensors (rank <= 1: plain tensors) of the meta tensors' shapes and
    dtypes, laid out by ``specs``, each rank holding only its shard."""
    from torch.distributed.tensor import zeros
    out = {}
    for k, m in meta.items():
        if m.dim() <= 1:
            out[k] = torch.zeros(m.shape, dtype=m.dtype, device=dev)
        else:
            out[k] = zeros(m.shape, dtype=m.dtype, device_mesh=mesh,
                           placements=to_placements(specs[k], mesh))
    return out


def _tokens(shape, cfg) -> int:
    """Tokens processed per step (for MODEL_FLOPS = 6*N*D): train / prefill
    B*S (prefill is forward-only: 2*N*D, folded in as 1/3 of the tokens);
    decode: B tokens."""
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len // 3
    return shape.global_batch // 3 or 1


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               dump_hlo: str | None = None, cfg_overrides: dict | None = None,
               dp_tp: tuple | None = None):
    """Build, lay out and count one cell; returns the stats dict.
    ``dump_hlo``: a path to write the counted per-op rows to (JSON; there
    is no HLO)."""
    mshape, _ = mesh_shape(multi_pod=multi_pod, dp_tp=dp_tp)
    chips = math.prod(mshape)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}
    from torch._subclasses.fake_tensor import FakeTensorMode
    dtype = fake_device_type()
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, dp_tp=dp_tp,
                                    device_type=dtype)
        dev = torch.device(dtype)
        with FakeTensorMode(allow_non_fake_inputs=True):
            t0 = time.perf_counter()
            model = build_model(cfg, dev)
            shard_model_(model, mesh, fsdp_params=(cfg.zero_stage >= 3))
            params = list(model.parameters())
            alias = 0
            if shape.kind == "train":
                step, optc = make_train_step(cfg, mesh, device=dev)
                opt = shard_opt_state_(adamw.init(model, optc), mesh)
                meta = input_structs(cfg, shape)
                batch = _fake_zeros(meta, batch_specs(meta, mesh), mesh, dev)
                args = (model, opt, batch)
                state = params + list(opt.m.values()) + list(opt.v.values())
                alias = _local_bytes(state)
                inputs = state + list(batch.values())
            elif shape.kind == "prefill":
                step = make_prefill_step(cfg, mesh, device=dev)
                meta = input_structs(cfg, shape)
                batch = _fake_zeros(meta, batch_specs(meta, mesh), mesh, dev)
                args = (model, batch)
                inputs = params + list(batch.values())
            else:
                cfg_d = decode_config(cfg, shape)
                step = make_serve_step(cfg_d, mesh, device=dev)
                cmeta, tmeta = decode_structs(cfg, shape)
                cache = _fake_zeros(cmeta, cache_specs(cmeta, mesh, cfg_d),
                                    mesh, dev)
                tok = _fake_zeros({"tokens": tmeta},
                                  batch_specs({"tokens": tmeta}, mesh), mesh,
                                  dev)["tokens"]
                args = (model, cache, tok)
                inputs = params + list(cache.values()) + [tok]
            t_lower = time.perf_counter() - t0
            t0 = time.perf_counter()
            out, an = analyze_step(step, *args)
            t_step = time.perf_counter() - t0
            from torch.utils._pytree import tree_flatten
            out_b = _local_bytes([t for t in tree_flatten(out)[0]
                                  if isinstance(t, torch.Tensor)])
            arg_b = _local_bytes(inputs)

    if dump_hlo:
        Path(dump_hlo).parent.mkdir(parents=True, exist_ok=True)
        Path(dump_hlo).write_text(json.dumps(_jsonable(an["rows"])))
    coll = an["collectives"]
    flops = float(an["flops"])
    bytes_accessed = float(an["hbm_bytes"])
    wire = float(an["total_wire_bytes"])
    intra = sum(v.get("intra_node_wire_bytes", 0.0) for v in coll.values())
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = intra / NVLINK_BW + (wire - intra) / INTER_NODE_BW
    model_flops = 6 * cfg.param_count(active_only=True) * _tokens(shape, cfg)
    dot_flops = sum(r["flops"] for r in an["rows"] if r["kind"] == "dot")
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": int(chips), "device_type": dtype,
        "status": "ok",
        "lower_s": round(t_lower, 2), "compile_s": round(t_step, 2),
        "hlo_flops": flops, "hlo_bytes": bytes_accessed,
        "hlo_bytes_raw": float(an["hbm_bytes_raw"]),
        "wire_bytes": wire, "intra_node_wire_bytes": intra,
        "raw_cost_analysis": {"flops": float(dot_flops),
                              "bytes_accessed": float(an["hbm_bytes_raw"])},
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(
            (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)), key=lambda kv: kv[1])[0],
        "model_flops_global": float(model_flops),
        "model_flops_per_chip": float(model_flops / chips),
        "useful_flops_ratio": (float(model_flops / chips / flops)
                               if flops else None),
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": an["peak_live_bytes"], "alias_bytes": alias,
                   "generated_code_bytes": None},
        "collectives": coll,
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-arch beyond-baseline settings "
                         "(configs.OPTIMIZED)")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import OPTIMIZED
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    print(f"fake tensors on {fake_device_type()}", flush=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                suffix = "-opt" if args.optimized else ""
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}{suffix}"
                path = out_dir / f"{tag}.json"
                ov, dp_tp = (OPTIMIZED.get(arch, ({}, None))
                             if args.optimized else ({}, None))
                try:
                    rec = lower_cell(arch, shape, mp, cfg_overrides=ov or None,
                                     dp_tp=dp_tp)
                    if args.optimized and isinstance(rec, dict):
                        rec["mesh"] = rec.get("mesh", "single") + "-opt"
                        rec["optimized"] = {"overrides": ov, "dp_tp": dp_tp}
                except Exception as e:  # a failing cell is recorded
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "fail", "error": str(e),
                           "trace": traceback.format_exc()[-2000:]}
                path.write_text(json.dumps(_jsonable(rec), indent=1))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "fail"
                msg = {"ok": f"step {rec.get('compile_s')}s flops/chip "
                             f"{rec.get('hlo_flops', 0):.3g}",
                       "skipped": rec.get("reason", ""),
                       "fail": rec.get("error", "")[:200]}[st]
                print(f"[{st:7s}] {tag}: {msg}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
