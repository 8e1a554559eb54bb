"""Production meshes, port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group.

Single pod:  (data=16, model=16)        = 256 ranks
Multi-pod:   (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis is
the slow axis: only data parallelism (the gradient reduction) crosses it.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which must already hold exactly the mesh's ranks (``torchrun``
on the cluster, a ``fake`` group of that size for the dry run).
"""
from __future__ import annotations

import math


def mesh_shape(*, multi_pod: bool = False, dp_tp: tuple | None = None):
    """(shape, axis names) of the production mesh.  ``dp_tp``: an optional
    (data, model) logical reshape of the same ranks (e.g. (64, 4) trades TP
    degree for DP width on the same 256 ranks)."""
    if dp_tp is not None:
        d, m = dp_tp
        shape = (2, d, m) if multi_pod else (d, m)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False,
                         dp_tp: tuple | None = None, device_type="cuda"):
    """The production ``DeviceMesh``.  Raises ``ValueError`` naming both
    counts when the default group's world size is not the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = mesh_shape(multi_pod=multi_pod, dp_tp=dp_tp)
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != size:
        raise ValueError(f"the mesh {dict(zip(axes, shape))} needs {size} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_site_mesh(n_sites: int | None = None):
    """The group of the paper's distributed clustering job (Algorithm 3):
    one site per rank.  Delegates to ``repro_torch.core.collective``, as the
    reference delegates to ``sites_mesh``: the default group when it holds
    ``n_sites`` ranks (None: however many it holds), else None."""
    import torch.distributed as dist

    from repro_torch.core.collective import sites_group
    if n_sites is None:
        n_sites = dist.get_world_size() if dist.is_initialized() else 1
    return sites_group(n_sites)
