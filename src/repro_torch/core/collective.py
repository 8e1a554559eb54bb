"""The one round of communication on ``torch.distributed``.

Port of ``repro.core.collective``.  Every "one round of communication"
program has the same shape: each site does local work, the sites exchange
fixed-shape payloads with a single all_gather, and a replicated coordinator
step finishes with a result that is identical on every site.  The one-shot
path (``repro_torch.core.distributed``) and the sharded streaming path
(``repro_torch.stream.sharded``) both follow it.

In the reference a site is a device of a 1-D ``sites`` mesh and the program
is one ``shard_map``.  ``shard_map`` has no counterpart here: a site is a
process (a rank) of a ``torch.distributed`` group, every rank runs the same
Python, and the group over the ``sites`` ranks takes the place of
``sites_mesh``:

* ``choose_backend``     — the explicit backend rule: ``nccl`` only when
                           every rank sits on its own CUDA device, else
                           ``gloo`` (ranks that share a card, or the CPU);
* ``init_sites``         — join the group of ``len(devices)`` site ranks,
                           with a timeout, so a rank that never arrives
                           fails the run instead of hanging it;
* ``sites_group``        — the initialized group if it has exactly
                           ``n_sites`` ranks, else None;
* ``gather_sites``       — all_gather every leaf in rank order and collapse
                           the site dim: "send every site's summary to the
                           coordinator" as one collective per leaf;
* ``sum_sites``          — all_reduce (sum) every leaf over the group: the
                           reference's ``psum`` over the sites axis;
* ``replicated_coordinator`` — hands each rank its own block of the sharded
                           arguments (leading site dim kept, length 1) and
                           returns the replicated result;
* ``payload_bytes`` / ``gathered_bytes`` — communication accounting: the
  bytes one site contributes to an all_gather, and the total a refresh puts
  on the wire (the reference's numbers for the same shapes and dtypes).
"""
from __future__ import annotations

import math
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

# group setup and every collective fail after this long rather than hang
DEFAULT_TIMEOUT = timedelta(seconds=60)


def choose_backend(devices: Sequence) -> str:
    """The group's backend for ranks on ``devices`` (one entry per rank).

    ``nccl`` only when every rank sits on its own CUDA device: NCCL refuses
    two ranks on one device.  Otherwise ``gloo``, whose collectives run in
    host memory (``gather_sites`` stages CUDA payloads through it).  A CUDA
    device without an index counts as ``cuda:0``.
    """
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("choose_backend needs one device per rank")
    cuda = [d.index or 0 for d in devs if d.type == "cuda"]
    if len(cuda) == len(devs) and len(set(cuda)) == len(cuda):
        return "nccl"
    return "gloo"


def init_sites(rank: int, devices: Sequence, *, init_method: str,
               timeout: timedelta = DEFAULT_TIMEOUT):
    """Join the default group of ``len(devices)`` site ranks as ``rank``.

    ``devices[r]`` is rank r's device; every rank passes the same list, so
    every rank picks the same backend (:func:`choose_backend`).
    ``init_method`` is a rendezvous URL (``tcp://localhost:<port>``,
    ``file://<path>``).  Setup and every later collective of the group
    raise after ``timeout``.  Returns the group (the default one).
    """
    backend = choose_backend(devices)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=len(devices), timeout=timeout)
    return dist.group.WORLD


def sites_group(n_sites: int):
    """The default group when it is initialized with exactly ``n_sites``
    ranks (the collective paths' precondition), else None."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == n_sites:
        return dist.group.WORLD
    return None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def gather_sites(tree, group=None):
    """All_gather every tensor leaf of ``tree`` over ``group`` (None: the
    default group) and collapse the gathered site dim, so a per-site
    ``(cap, ...)`` leaf becomes the coordinator's ``(s * cap, ...)`` union
    in rank order.  THE one round of communication: one collective per
    leaf.  Every rank must pass leaves of the same shapes and dtypes; the
    result is identical on every rank and lies on each leaf's device."""
    gloo = dist.get_backend(group) == "gloo"
    n = dist.get_world_size(group)

    def g(a: torch.Tensor) -> torch.Tensor:
        # gloo's collectives work in host memory: a CUDA payload is staged
        # through the host explicitly (.cpu() here, .to(device) after)
        send = (a.cpu() if gloo else a).contiguous()
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=group)
        out = torch.cat([p.reshape((-1,) + tuple(a.shape[1:]))
                         for p in parts])
        return out.to(a.device)

    return _tree_map(g, tree)


def sum_sites(tree, group=None):
    """The sum over ``group``'s ranks of every tensor leaf of ``tree`` (an
    all_reduce per leaf, the reference's ``psum``).  Every rank must pass
    leaves of the same shapes and dtypes; the result is identical on every
    rank, lies on each leaf's device, and the caller's leaves are left as
    they were.  gloo stages a CUDA payload through the host, as
    :func:`gather_sites` does."""
    gloo = dist.get_backend(group) == "gloo"

    def s(a: torch.Tensor) -> torch.Tensor:
        buf = (a.to("cpu", copy=True) if gloo else a.clone()).contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(a.device)

    return _tree_map(s, tree)


def replicated_coordinator(per_site, group=None, *, n_sharded: int = 1):
    """``per_site`` run on this rank's block, its replicated result returned.

    The first ``n_sharded`` arguments are pytrees whose leaves hold every
    site's block on their leading dim (arrays, memmaps or tensors of leading
    size ``s``); each rank passes ``per_site`` only its own block, the
    leading site dim kept at length 1 (a view: a memmapped leaf is read only
    where ``per_site`` reads it).  The remaining arguments pass through.
    ``per_site`` must return what is *identical on every rank* (the
    coordinator result after a ``gather_sites``); every rank returns it, so
    callers get the coordinator view directly.
    """

    def call(*args):
        if len(args) < n_sharded:
            raise ValueError(f"{len(args)} args but n_sharded={n_sharded}")
        r, s = dist.get_rank(group), dist.get_world_size(group)

        def block(a):
            if a.shape[0] != s:
                raise ValueError(f"a sharded argument's leading dim is "
                                 f"{a.shape[0]}, the group has {s} sites")
            return a[r:r + 1]

        local = [_tree_map(block, a) if i < n_sharded else a
                 for i, a in enumerate(args)]
        return per_site(*local)

    return call


def payload_bytes(tree) -> int:
    """Bytes one site contributes to an all_gather of ``tree`` (its padded
    per-site payload — what actually crosses the interconnect, as opposed to
    the paper's valid-record count).  Leaves are tensors or arrays."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            a = np.asarray(leaf)
            total += int(math.prod(a.shape)) * a.dtype.itemsize
    return total


def gathered_bytes(tree, n_sites: int) -> int:
    """Total bytes one all_gather of per-site ``tree`` moves: every one of
    the ``n_sites`` participants contributes its payload once."""
    return payload_bytes(tree) * n_sites

