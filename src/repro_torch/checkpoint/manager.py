"""Async, atomic checkpointing in the reference's on-disk layout.

Port of ``repro.checkpoint.manager``.  Layout (one directory per step):
    <root>/step_000123.tmp/...        while writing
    <root>/step_000123/               after atomic rename (publish)
        manifest.json                 leaf shapes, dtypes, crcs, meta
        arr_00000.npy ...             one file per leaf (full array)

The layout, the leaf order and the manifest's keys are the reference's, so
a checkpoint written by either package restores in the other:

  * atomic publish — a crashed writer never leaves a readable-but-corrupt
    checkpoint (readers only ever see fully-renamed directories);
  * async — save() copies the leaves to the host on the caller's thread and
    returns; the writer thread does the IO; wait() joins, and a
    writer-thread exception is captured and re-raised on the next
    wait()/save()/restore() instead of dying silently with the daemon;
  * integrity — crc32 per leaf, verified on restore;
  * retention — keep_last prunes old steps after each successful publish.

A tree is any nest of dicts, lists, tuples and NamedTuples over array
leaves (numpy arrays, numpy or Python scalars, or torch tensors on any
device); ``None`` holds no leaf.  :func:`flatten` orders the leaves as
``jax.tree_util.tree_flatten`` does: dict keys sorted, sequences in order.
``restore`` returns numpy leaves, or tensors on the ``device=`` the caller
names.  The reference's ``shardings=`` argument (cross-mesh placement with
``jax.device_put``) has no meaning in the port and is left out.
Telemetry is the reference's: the ``checkpoint.save`` / ``.restore`` spans
and the ``checkpoint.saves`` / ``.restores`` / ``.bytes_written`` /
``.bytes_read`` counters.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> list:
    """Leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in flatten(child)]
    return [tree]


def unflatten(like, leaves) -> object:
    """``like``'s structure with ``leaves`` (in :func:`flatten`'s order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


# bf16 leaves go to disk as the reference writes them (ml_dtypes' bfloat16
# saves as raw two-byte words, '<V2', with "bfloat16" in the manifest), and
# come back as bf16 tensors: numpy has no bf16 of its own.
_BF16_WORDS = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy even when the tensor already lies on the CPU (``.cpu()``
        # would return it, and ``.numpy()`` share its memory): save()'s
        # caller may update its tensors in place once it returns
        leaf = leaf.detach().to("cpu", copy=True)
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(_BF16_WORDS)
        return leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _is_bf16(leaf) -> bool:
    return (leaf.dtype == torch.bfloat16 if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf).dtype.name == "bfloat16")


def _numpy_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


class CheckpointManager:
    def __init__(self, root: str | Path, keep_last: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree, *, blocking: bool = False, meta=None):
        """Snapshot `tree` (any tree of arrays or tensors) at `step`.

        `meta`: optional JSON-serializable dict recorded in the manifest —
        writer-side facts a restorer must agree on before interpreting the
        leaves (the stream service records its format).  Read it back with
        `read_meta`."""
        try:
            # validate on the caller's thread (a bad meta on a non-blocking
            # save would otherwise die silently on the writer thread) and
            # normalize to the JSON image, so read_meta returns exactly what
            # a restorer will see (tuples become lists here, not at read).
            meta = json.loads(json.dumps(meta or {}))
        except (TypeError, ValueError) as e:
            raise TypeError(f"checkpoint meta is not JSON-serializable: {e}")
        # device -> host copy happens here, on the caller's thread, so the
        # caller may overwrite its tensors right after save() returns
        host_leaves = [_host(x) for x in flatten(tree)]
        # the structure with "*" for each leaf, for a reader (not read back)
        treedef = repr(unflatten(tree, ["*"] * len(host_leaves)))
        self.wait()

        def _write():
            # runs on the writer thread for async saves — the registry is
            # mutation-thread-safe, so recording from here is fine
            with obs.trace("checkpoint.save"):
                self._do_write(step, treedef, meta, host_leaves)
            obs.counter("checkpoint.saves").inc()
            obs.counter("checkpoint.bytes_written").inc(
                sum(arr.nbytes for arr in host_leaves))

        def _write_guarded():
            # an exception on the daemon writer thread would otherwise die
            # silently; park it for the next wait()/save()/restore() to
            # re-raise on a caller thread
            try:
                _write()
            except BaseException as e:
                self._error = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_guarded, daemon=True)
            self._thread.start()

    def _do_write(self, step, treedef, meta, host_leaves):
        tmp = self.root / f"step_{step:09d}.tmp"
        final = self.root / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": treedef,
                    "meta": meta or {}, "leaves": []}
        for i, arr in enumerate(host_leaves):
            name = f"arr_{i:05d}.npy"
            np.save(tmp / name, arr)
            manifest["leaves"].append({
                "file": name,
                "shape": list(arr.shape),
                "dtype": _dtype_name(arr),
                "crc32": zlib.crc32(
                    np.ascontiguousarray(arr).tobytes()),
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._prune()

    def wait(self):
        """Join any in-flight async save.  Re-raises an exception the writer
        thread hit (here, on the caller's thread) — the failed step was never
        published, so the caller sees both the error and a consistent
        directory.  save()/restore()/read_meta() all wait first, so a lost
        write cannot be silently followed by dependent work."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------ restore
    def all_steps(self):
        out = []
        for p in self.root.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int | None = None) -> dict:
        """The `meta` dict `save` recorded at `step` (default: latest).
        Checkpoints written before meta existed read back as {}."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        manifest = json.loads(
            (self.root / f"step_{step:09d}" / "manifest.json").read_text())
        return manifest.get("meta", {})

    def restore(self, tree_like, step: int | None = None, *,
                verify: bool = True, device=None):
        """Restore into the structure of `tree_like` (shapes must match;
        each leaf is cast to its `tree_like` leaf's dtype).  Leaves come back
        as numpy arrays, or as tensors on `device` when one is named; a bf16
        leaf (a bf16 tensor or an ml_dtypes array in `tree_like`) comes
        back as a bf16 tensor, on the CPU when no device is named.
        Returns (tree, step)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:09d}"
        with obs.trace("checkpoint.restore"):
            manifest = json.loads((d / "manifest.json").read_text())
            leaves_like = flatten(tree_like)
            if len(manifest["leaves"]) != len(leaves_like):
                raise ValueError(
                    f"checkpoint has {len(manifest['leaves'])} leaves, "
                    f"expected {len(leaves_like)}")
            out = []
            read = 0
            for meta, like in zip(manifest["leaves"], leaves_like):
                arr = np.load(d / meta["file"])
                read += arr.nbytes
                if verify and zlib.crc32(
                        np.ascontiguousarray(arr).tobytes()) != meta["crc32"]:
                    raise IOError(
                        f"crc mismatch in {meta['file']} (step {step})")
                if tuple(arr.shape) != _shape(like):
                    raise ValueError(
                        f"shape mismatch {arr.shape} vs {_shape(like)}")
                if _is_bf16(like):
                    t = torch.from_numpy(
                        np.ascontiguousarray(arr).view(np.int16)).view(
                            torch.bfloat16)
                    out.append(t if device is None else t.to(device))
                    continue
                arr = arr.astype(_numpy_dtype(like))
                out.append(arr if device is None
                           else torch.as_tensor(arr, device=device))
        obs.counter("checkpoint.restores").inc()
        obs.counter("checkpoint.bytes_read").inc(read)
        return unflatten(tree_like, out), step
