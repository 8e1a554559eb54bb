"""Parameter / optimizer-state / batch / cache sharding specs, port of
``repro.models.sharding``, and their DTensor placements.

Scheme (the reference's DESIGN §6): tensor parallelism over the ``model``
mesh axis for heads / ffn / vocab / experts, ZeRO-3-style FSDP over the
batch axes (``data``, plus ``pod`` multi-pod) on the complementary dim.
Rules are name + rank based, so the one function covers all five families.

A spec is a tuple of per-dim entries, the reference's ``PartitionSpec``:
``None`` (replicated), a mesh axis name, or a tuple of axis names (the
dim is split over those axes, the first one major).  :func:`to_placements`
turns it into DTensor placements, one per mesh dim.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names; the rules read only its ``mesh_dim_names`` and
``shape``, so any object with those two attributes (a logical mesh with no
process group) gives the same specs.

The port's parameters are unstacked (``layers.3.attn.wq``): each one's rule
is the reference's rule for its flat name (``layers/attn/wq``, through
``transformer.reference_key``), and the reference's leading ``None`` for the
layer-stack dims has no counterpart.  The port's caches are stacked, as the
reference's are, so :func:`cache_specs` keeps those ``None``s.

Optimizer moments take the FSDP rules whatever ``fsdp_params`` says (ZeRO-2
keeps the weights TP-only and the moments sharded), as in the reference's
dry run.
"""
from __future__ import annotations


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axes(mesh) -> tuple:
    """Batch-like axes = every axis that isn't the model axis."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _fsdp_entry(mesh):
    fsdp_t = fsdp_axes(mesh)
    return fsdp_t if len(fsdp_t) > 1 else fsdp_t[0]


def _leaf_spec(flat_name: str, ndim: int, fsdp, model="model") -> tuple:
    """Spec for an UNSTACKED leaf (rank without the layer-stack dims); the
    reference's rules in the reference's order."""
    n = flat_name
    last = n.rsplit("/", 1)[-1]  # exact leaf name ("u" must not match "mu")
    # --- embeddings / head ---
    if n.endswith("embed/table"):
        return (model, fsdp)
    if n.endswith("lm_head"):
        return (fsdp, model)
    if "frontend" in n:
        return (None, fsdp)
    # --- norms / small vectors / scalars ---
    if ndim <= 1:
        return (None,) * ndim
    # --- attention ---
    if n.endswith(("attn/wq", "attn/wk", "attn/wv", "xattn/wq", "xattn/wk",
                   "xattn/wv")):
        return (fsdp, model)
    if n.endswith(("attn/wo", "xattn/wo")):
        return (model, fsdp)
    # --- moe experts: EP over model, FSDP over the expert-internal in-dim ---
    if n.endswith(("we_g", "we_i")):
        return (model, fsdp, None)
    if n.endswith("we_o"):
        return (model, None, fsdp)
    if n.endswith("router"):
        return (fsdp, None)
    # --- mlp / rwkv cmix / rglru projections: in->hidden cols on model ---
    if n.endswith(("mlp/wi", "mlp/wg", "shared/wi", "shared/wg", "cmix/wk",
                   "w_x", "w_y", "tmix/wr", "tmix/wk", "tmix/wv", "tmix/wg",
                   "cmix/wr")):
        return (fsdp, model)
    if n.endswith(("mlp/wo", "shared/wo", "cmix/wv", "w_out", "tmix/wo")):
        return (model, fsdp)
    if n.endswith(("tmix/wa",)):
        return (fsdp, None)
    if n.endswith(("tmix/wb",)):
        return (None, fsdp)
    if last == "conv":
        return (None, model)
    if last in ("w0", "u"):      # (H, hd)
        return (model, None)
    if last == "mu":             # (5, D)
        return (None, None)
    # fallback: FSDP on dim 0
    return (fsdp,) + (None,) * (ndim - 1)


def fix_divisibility(spec: tuple, shape, mesh) -> tuple:
    """Drop mesh axes from any spec entry whose dim they don't divide (e.g.
    vocab=256206 on a 16-way axis, or batch=1 decode): no tensor is sharded
    unevenly, as in the reference."""
    sizes = axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None or d >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        prod = 1
        for a in axes:
            if shape[d] % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return tuple(out)


def _strip_axes(spec: tuple, axes: set) -> tuple:
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        es = entry if isinstance(entry, tuple) else (entry,)
        keep = tuple(a for a in es if a not in axes)
        out.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def param_spec(name: str, shape, mesh, *, fsdp_params: bool = True) -> tuple:
    """The spec of one port parameter (``layers.3.attn.wq``)."""
    from repro_torch.models.transformer import reference_key
    s = _leaf_spec("/".join(reference_key(name)[0]), len(shape),
                   _fsdp_entry(mesh))
    if not fsdp_params:
        s = _strip_axes(s, set(fsdp_axes(mesh)))
    return fix_divisibility(s, shape, mesh)


def param_specs(params, mesh, *, fsdp_params: bool = True) -> dict:
    """{parameter name: spec} for a model (or a name -> tensor mapping).

    fsdp_params=False is ZeRO-2: weights stay TP-sharded only (resident, no
    per-layer all-gather); optimizer moments keep the full FSDP sharding
    through a separate ``param_specs(..., fsdp_params=True)``."""
    named = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {n: param_spec(n, tuple(p.shape), mesh, fsdp_params=fsdp_params)
            for n, p in named}


def batch_specs(batch: dict, mesh) -> dict:
    """Input batch: leading dim over all batch axes."""
    bd = fsdp_axes(mesh)
    out = {}
    for k, t in batch.items():
        if len(t.shape) == 0:
            out[k] = ()
            continue
        full = (bd,) + (None,) * (len(t.shape) - 1)
        out[k] = fix_divisibility(full, tuple(t.shape), mesh)
    return out


def cache_specs(cache: dict, mesh, cfg=None) -> dict:
    """KV caches: batch dim over batch axes, head/width dims over model
    where profitable.  Layer-stacked leading dims stay unsharded."""
    bd = fsdp_axes(mesh)

    def spec(nm, shape):
        if nm in ("kpos", "pos") or len(shape) <= 1:
            return ()
        if nm in ("k", "v", "ck", "cv"):
            # (L[, sub], B, W, Hkv, hd): shard B over batch axes; shard W
            # (the long dim) over model — decode attention reduces over W.
            lead = len(shape) - 4
            return (None,) * lead + (bd, "model", None, None)
        if nm == "s":                        # rwkv state (L,B,H,K,V)
            return (None, bd, "model", None, None)
        if nm in ("ts_t", "ts_c"):           # (L, B, D)
            return (None, bd, None)
        if nm == "h":                        # (G, rpa, B, W)
            return (None, None, bd, "model")
        if nm == "tail_h":                   # (tail, B, W)
            return (None, bd, "model")
        if nm == "conv":                     # (G, rpa, B, 3, W)
            return (None, None, bd, None, "model")
        if nm == "tail_conv":                # (tail, B, 3, W)
            return (None, bd, None, "model")
        return (None,) * len(shape)

    return {nm: fix_divisibility(spec(nm, tuple(t.shape)), tuple(t.shape),
                                 mesh)
            for nm, t in cache.items()}


# ------------------------------------------------------------ DTensor
def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the dim's axis name appears in entry d, else
    ``Replicate()``.  A dim split over several axes is split in mesh-dim
    order, which is the reference's major-to-minor order for the specs
    above (``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in where:
                raise ValueError(f"axis {a!r} appears twice in {spec}")
            where[a] = d
    names = list(mesh.mesh_dim_names)
    for entry in spec:
        if isinstance(entry, tuple):
            idx = [names.index(a) for a in entry]
            if idx != sorted(idx):
                raise ValueError(f"{entry} is not in the mesh's order {names}")
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not in the mesh {names}")
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def distribute(t, mesh, spec: tuple):
    """``t`` (a whole tensor, the same on every rank) as a DTensor laid out
    by ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, to_placements(spec, mesh))


def _set_param(model, name: str, t) -> None:
    """The parameter ``name`` of ``model`` replaced by ``t`` (keeping its
    ``requires_grad``)."""
    import torch
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    p = getattr(mod, leaf)
    mod.register_parameter(leaf, torch.nn.Parameter(
        t, requires_grad=p.requires_grad))


def shard_model_(model, mesh, *, fsdp_params: bool = True):
    """Replace every parameter of ``model`` by a DTensor parameter laid out
    by :func:`param_specs`, in place; returns the model.  Each rank must
    hold the same whole weights (the same seed)."""
    specs = param_specs(model, mesh, fsdp_params=fsdp_params)
    for name, spec in specs.items():
        _set_param(model, name, distribute(
            model.get_parameter(name).detach(), mesh, spec))
    return model


def init_sharded_params(cfg, seed: int, mesh, *, fsdp_params: bool = True,
                        device="cuda"):
    """``transformer.init_params(cfg, seed)`` laid out on ``mesh`` as
    :func:`shard_model_` lays it out (the same draws in the same order, so
    the same numbers), built one unit at a time: the model is built on
    ``meta``, and each of ``init_units``' units (the embedding, the head,
    one layer) is drawn whole on ``device`` and cut into this rank's shards
    before the next is drawn.  A rank never holds more than its shards and
    one unit whole, where ``init_params`` + ``shard_model_`` would hold the
    whole model."""
    import torch
    from repro_torch import resolve_device
    from repro_torch.models.layers import RMSNorm, rmsnorm_init
    from repro_torch.models.transformer import build_model, init_units
    dev = resolve_device(device)
    model = build_model(cfg, "meta")
    specs = param_specs(model, mesh, fsdp_params=fsdp_params)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def whole(names):
        for n in names:
            p = model.get_parameter(n)
            owner = model.get_submodule(n.rpartition(".")[0])
            _set_param(model, n, rmsnorm_init(p.shape[0], dev)
                       if isinstance(owner, RMSNorm)
                       else torch.empty_like(p, device=dev))

    def cut(names):
        for n in names:
            _set_param(model, n, distribute(
                model.get_parameter(n).detach(), mesh, specs[n]))

    for unit, fill in init_units(model, cfg):
        names = [n for n in specs if n == unit or n.startswith(unit + ".")]
        whole(names)
        fill(gen)
        cut(names)
    rest = [n for n, p in model.named_parameters() if p.is_meta]
    odd = [n for n in rest if not isinstance(
        model.get_submodule(n.rpartition(".")[0]), RMSNorm)]
    if odd:
        raise ValueError(f"init_sharded_params: no draw fills {odd}")
    whole(rest)
    cut(rest)
    return model


def load_sharded(tree: dict, specs: dict, mesh, device) -> dict:
    """{port name: DTensor} for each name of ``specs``: its slice of
    ``tree`` (the reference's layout on the host, layer leaves stacked)
    moved to ``device`` and cut into this rank's shards by its spec, one
    leaf at a time."""
    from repro_torch.models.transformer import (_leaves, reference_key,
                                                tensor_from_numpy)
    leaves = dict(_leaves(tree))
    out = {}
    for name, spec in specs.items():
        key, index = reference_key(name)
        t = tensor_from_numpy(leaves[key])[index]
        out[name] = distribute(t.to(device), mesh, spec)
    return out


def load_sharded_params(cfg, tree: dict, mesh, *, fsdp_params: bool = True,
                        device="cuda"):
    """``transformer.params_from_numpy(tree, cfg)`` laid out on ``mesh`` as
    :func:`shard_model_` lays it out, one leaf at a time
    (:func:`load_sharded`)."""
    from repro_torch import resolve_device
    from repro_torch.models.transformer import build_model
    model = build_model(cfg, "meta")
    specs = param_specs(model, mesh, fsdp_params=fsdp_params)
    for name, t in load_sharded(tree, specs, mesh,
                                resolve_device(device)).items():
        _set_param(model, name, t)
    return model


def init_opt_state(model, c, mesh):
    """``adamw.init(model, c)``'s zero moments laid out as
    :func:`shard_opt_state_` lays them out, each rank allocating only its
    shards."""
    import torch
    from torch.distributed.tensor import zeros

    from repro_torch.models.rwkv6 import torch_dtype
    from repro_torch.optim.adamw import AdamWState
    dt = torch_dtype(c.state_dtype)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def z(name, p):
        spec = param_spec(name, tuple(p.shape), mesh)
        return zeros(p.shape, dtype=dt, device_mesh=mesh,
                     placements=to_placements(spec, mesh))
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m={n: z(n, p) for n, p in params.items()},
                      v={n: z(n, p) for n, p in params.items()})


def shard_opt_state_(state, mesh):
    """AdamW's moments laid out by the FSDP rules (``fsdp_params=True``,
    whatever the weights' stage), in place in ``state.m`` / ``state.v``;
    returns the state.  A whole moment is cut into its shards and a DTensor
    moment redistributed (from the weights' TP-only layout under ZeRO-2: a
    local slice, no communication).  The step stays a plain tensor, the
    same on every rank."""
    for tree in (state.m, state.v):
        for name, t in list(tree.items()):
            spec = param_spec(name, tuple(t.shape), mesh)
            if is_dtensor(t):
                tree[name] = t.redistribute(mesh, to_placements(spec, mesh))
            else:
                tree[name] = distribute(t, mesh, spec)
    return state
