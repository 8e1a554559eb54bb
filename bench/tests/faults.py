"""Faults planted in the program's timed path, for the test that sees
``correct`` come out false.  ``plant(name, set_attr)`` replaces one of
the program's functions in this process (``set_attr`` is
``monkeypatch.setattr`` in a test, ``setattr`` in a rank process)."""
import torch

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "answer_altered")


def _unchanged_accumulate(x, w, amin, k):
    """k-means--'s Lloyd step returns its state unchanged: no center
    gathers any weight, so every center keeps its seed."""
    z = torch.zeros((k,), dtype=torch.float32, device=x.device)
    return torch.zeros((k, x.shape[1]), device=x.device), z


def _half_batch(real):
    """Algorithm 2's reassignment reads every other row and gives each row
    left out its neighbour's center, so the kept half stands for all."""
    def min_argmin(x, c, **kw):
        d, i = real(x[::2], c, **kw)
        n = x.shape[0]
        return (d.repeat_interleave(2)[:n], i.repeat_interleave(2)[:n])
    return min_argmin


def _altered(real):
    """Algorithm 2's reassignment hands one row in fifty the first
    center."""
    def min_argmin(x, c, **kw):
        d, i = real(x, c, **kw)
        i = i.clone()
        i[::50] = 0
        return d, i
    return min_argmin


def _no_exchange(real):
    """The gather of the site summaries leaves out every site but this
    one: each rank sees its own payload s times."""
    def gather_sites(tree, group=None):
        import torch.distributed as dist
        s = dist.get_world_size(group)
        return real(tree, group) if s == 1 else type(tree)(
            torch.cat([a] * s) for a in tree)
    return gather_sites


def _coordinator_sees_site0(real):
    """The one-process form of the missing exchange: the coordinator is
    handed site 0's summary alone."""
    def coordinator_fit(points, weights, gids, cands, rounds, *a, **kw):
        return real(points[:1], weights[:1], gids[:1], cands[:1],
                    rounds[:1], *a, **kw)
    return coordinator_fit


def plant(name: str, set_attr=setattr) -> None:
    from repro_torch.core import augmented, distributed, kmeans_mm
    if name == "state_unchanged":
        set_attr(kmeans_mm, "accumulate_by_assignment",
                 _unchanged_accumulate)
    elif name == "half_batch":
        set_attr(augmented, "min_argmin", _half_batch(augmented.min_argmin))
    elif name == "answer_altered":
        set_attr(augmented, "min_argmin", _altered(augmented.min_argmin))
    elif name == "no_exchange":
        set_attr(distributed, "gather_sites",
                 _no_exchange(distributed.gather_sites))
        set_attr(distributed, "coordinator_fit",
                 _coordinator_sees_site0(distributed.coordinator_fit))
    else:
        raise KeyError(name)


def diverge_on_rank(rank: int) -> None:
    """On rank ``rank`` of the group, ``distributed_cluster`` returns its
    cost a part in ten thousand off: that rank no longer returns what the
    others do, and rank 0's own answer stays sound."""
    import torch.distributed as dist
    from repro_torch import core
    real = core.distributed_cluster

    def distributed_cluster(*a, **kw):
        res = real(*a, **kw)
        if dist.get_rank() != rank:
            return res
        return res._replace(cost=res.cost * (1 + 1e-4))
    core.distributed_cluster = distributed_cluster


def hold_a_jax_module() -> None:
    """The process holds a module named ``jax`` (an empty stand-in)."""
    import sys
    import types
    sys.modules["jax"] = types.ModuleType("jax")
