"""Cost model of one step, counterpart of ``repro.launch.hlo``.

The reference walks the partitioned HLO of a compiled step.  The port has
no HLO: this module reads none, and counts instead the aten ops a step
dispatches on each rank's local shards, through a ``TorchDispatchMode``
(:class:`StepCounter`).  Under a DTensor step the mode sees DTensor's local
computation (``mm`` on local shards, the ``_c10d_functional`` collectives
with their local shapes); the calls DTensor makes on global shapes to
propagate metadata are not counted.  With fake tensors over a fake process
group (``launch/dryrun.py``) the counts are one rank's at the production
mesh's sizes, and nothing is computed.

  flops: ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, attention) on local shapes; a
  pointwise op counts its output's elements and a reduction its input's,
  as the reference's walk does.  The step is a Python loop, so every layer
  is dispatched and counted once per pass: the reference's trip-count
  correction of ``while`` bodies has no counterpart.

  bytes: the reference's two models.  ``hbm_bytes_raw`` bills the operands
  and outputs of every op but the ones that move nothing (views, metadata).
  ``hbm_bytes`` (the roofline input) bills them only at materialisation
  points, the reference's ``_MATERIALIZE`` mapped to aten: matrix products
  and convolutions, reductions, sorts, gathers / scatters / index ops,
  concatenations, copies and collectives; pointwise ops count as fused
  into their consumers.

  collectives: each ``_c10d_functional`` (and DTensor's
  ``shard_dim_alltoall``) op under the reference's name, with the group
  size from the op's group, priced by the reference's ring model
  (:func:`_wire_bytes`, as it is).

  kernels: a hand-written kernel launched through ``ctypes`` dispatches
  no aten op; each launch is counted from its arguments instead: its
  inputs read and outputs written once, and the flops of the kernel's own
  formula (``CudaKernel.flops``).

  memory: the peak of the bytes live in the outputs of non-view ops the
  step allocated (each counted until its tensor is freed; a view that
  outlives its base is not followed).

A step counted here runs under ``no_grad``, not ``inference_mode``: under
inference mode the mode missed DTensor's local products and saw
global-shaped ones instead (torch 2.13), so the serving steps on a mesh
use ``no_grad`` (``launch/steps.py``).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
# An HGX H100 node: a collective whose ranks all lie in one node of this
# many consecutive ranks rides NVLink, any other the inter-node links
GPUS_PER_NODE = 8

# the reference's _MATERIALIZE, as aten op names (pointwise ops are fused)
_MATERIALIZE = {
    "mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
    "convolution_backward", "sort", "argsort", "topk", "cumsum", "gather",
    "scatter", "scatter_add", "scatter_add_", "index", "index_put",
    "index_put_", "_index_put_impl_", "index_select", "index_add",
    "index_add_", "index_copy", "index_copy_", "embedding",
    "embedding_dense_backward", "cat", "stack", "copy_", "clone",
    "_to_copy", "bincount", "masked_scatter", "nonzero", "kthvalue",
    "_unsafe_index", "_unsafe_index_put", "slice_scatter",
    "select_scatter", "constant_pad_nd",
}
# reductions (a reduction counts its input's elements as flops)
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "var", "std", "var_mean", "std_mean",
    "norm", "linalg_vector_norm", "argmax", "argmin", "any", "all",
    "cumsum", "cumprod", "_softmax_backward_data",
    "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward",
}
# ops that move no bytes themselves
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "set_", "resize_", "wait_tensor", "is_same_size"}


def _wire_bytes(op: str, s: float, n: int) -> float:
    if op == "all-gather":
        return s * (n - 1)
    if op == "reduce-scatter":
        return s * (n - 1) / max(n, 1)
    if op == "all-reduce":
        return 2.0 * s * (n - 1) / max(n, 1)
    if op == "all-to-all":
        return s * (n - 1) / max(n, 1)
    return float(s)  # collective-permute


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group(func, args) -> tuple:
    """(size, global ranks) of a functional collective's group, from the
    group its ``group_name`` argument names."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a, v in zip(func._schema.arguments, args):
        if a.name == "group_name":
            pg = _resolve_process_group(v)
            return pg.size(), dist.get_process_group_ranks(pg)
    raise ValueError(f"{func} names no group")


class _Propagation:
    """While DTensor propagates an op's metadata on global shapes, the
    counter ignores what it sees."""
    depth = 0


@contextlib.contextmanager
def _skip_propagation():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = ("_propagate_tensor_meta_non_cached"
            if hasattr(ShardingPropagator,
                       "_propagate_tensor_meta_non_cached")
            else "_propagate_tensor_meta")
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *a, **k):
        _Propagation.depth += 1
        try:
            return orig(self, *a, **k)
        finally:
            _Propagation.depth -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class StepCounter(TorchDispatchMode):
    """Counts flops, bytes, collectives and live bytes of the local ops
    dispatched under it (see the module docstring).  A collective whose
    group's ranks all lie in one node (``GPUS_PER_NODE``) also adds its
    wire bytes to ``intra_node_wire_bytes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_raw = 0.0
        self.coll = defaultdict(lambda: defaultdict(float))
        self.rows = {}
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def _kernel(self, kern, args, kwargs, out):
        ins = _tensors((args, kwargs))
        b = _nbytes(ins) + _nbytes(_tensors(out))
        flops = float(kern.flops(*args, **kwargs))
        self.flops += flops
        self.bytes += b
        self.bytes_raw += b
        key = ("kernel", kern.name, tuple(tuple(t.shape) for t in ins[:3]))
        r = self.rows.setdefault(key, [0, 0.0, 0.0, 0.0])
        r[0] += 1
        r[1] += b
        r[2] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _Propagation.depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_b, out_b = _nbytes(ins), _nbytes(outs)
        flops, wire, kind = 0.0, 0.0, "op"
        if ns in _COLLECTIVE_NS and name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            n, ranks = _group(func, args)
            wire = _wire_bytes(op, float(in_b), n)
            c = self.coll[op]
            c["count"] += 1
            c["operand_bytes"] += in_b
            c["wire_bytes"] += wire
            intra = len({r // GPUS_PER_NODE for r in ranks}) == 1
            c["intra_node_wire_bytes"] += wire if intra else 0.0
            self.bytes += in_b + out_b
            self.bytes_raw += in_b + out_b
            kind, name = op, f"{op}/{n}"
        elif func.is_view or name in _FREE or ns not in ("aten", "prims"):
            kind = "view"
        else:
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
                kind = "dot"
            elif name in _REDUCTIONS:
                flops = float(sum(t.numel() for t in ins))
                kind = "reduce"
            elif torch.Tag.pointwise in func.tags:
                flops = float(sum(t.numel() for t in outs))
                kind = "pointwise"
            self.flops += flops
            self.bytes_raw += in_b + out_b
            if kind in ("dot", "reduce") or name in _MATERIALIZE:
                self.bytes += in_b + out_b
                if kind == "op":
                    kind = "copy" if name in ("copy_", "clone", "_to_copy") \
                        else "gather"
        if not func.is_view and not func._schema.is_mutable:
            for t in outs:
                nb = t.numel() * t.element_size()
                if nb:
                    self.live += nb
                    weakref.finalize(t, self._free, nb)
            self.peak = max(self.peak, self.live)
        if kind != "view":
            key = (kind, name, tuple(tuple(t.shape) for t in ins[:3]))
            r = self.rows.setdefault(key, [0, 0.0, 0.0, 0.0])
            r[0] += 1
            r[1] += in_b + out_b
            r[2] += flops
            r[3] += wire

    def result(self) -> dict:
        coll = {k: dict(v) for k, v in self.coll.items()}
        rows = [{"kind": k[0], "op": k[1], "shapes": k[2], "count": r[0],
                 "bytes": r[1], "flops": r[2], "wire_bytes": r[3]}
                for k, r in self.rows.items()]
        return {"flops": self.flops, "hbm_bytes": self.bytes,
                "hbm_bytes_raw": self.bytes_raw, "collectives": coll,
                "total_wire_bytes": sum(v.get("wire_bytes", 0.0)
                                        for v in coll.values()),
                "peak_live_bytes": self.peak, "rows": rows}


def analyze_step(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepCounter`.
    Returns (fn's result, the counts: the reference's keys ``flops``,
    ``hbm_bytes``, ``hbm_bytes_raw``, ``collectives`` ({op: {"count",
    "operand_bytes", "wire_bytes", "intra_node_wire_bytes"}}) and
    ``total_wire_bytes``, plus
    ``peak_live_bytes`` and the per-op ``rows``)."""
    from repro_torch.kernels._build import CudaKernel
    counter = StepCounter()
    CudaKernel.observers.append(counter._kernel)
    try:
        with _skip_propagation(), counter:
            out = fn(*args, **kwargs)
    finally:
        CudaKernel.observers.remove(counter._kernel)
    return out, counter.result()


def collective_stats(result: dict) -> dict:
    """The reference's shim over its analysis: the collectives and their
    total wire bytes."""
    out = dict(result["collectives"])
    out["total_wire_bytes"] = result["total_wire_bytes"]
    return out
