"""The port's ``CheckpointManager`` and the stream service's save/restore,
on the CPU, against the reference.

The manager writes the reference's layout (``step_%09d/``, one
``arr_%05d.npy`` per leaf in ``jax.tree_util``'s order, crc32 per leaf,
``manifest.json`` with ``meta``), so a checkpoint written by either
package restores in the other.  The manager's own tests mirror the
reference's ``tests/test_checkpoint_runtime.py`` (round trip, async with
latest and prune, crc corruption, an interrupted write, a writer error
re-raised).  A stream service's checkpoint crosses both ways under
``JaxReplaySampler``: the restored service's packed root, model and
scores equal the writer's, and it goes on ingesting as the writer does.
The service tests run under l1 on an integer grid, where every score is
bit for bit the reference's (``tests/test_torch_stream.py`` says why).
They mirror ``tests/test_stream.py``'s restore tests, and a service keyed
by ``TorchSampler`` continues after a restore bit for bit as the
uninterrupted one does.
"""
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.stream as J
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.checkpoint.manager import (CheckpointManager, flatten,
                                            unflatten)
from repro_torch.stream import ServiceConfig, StreamService
from test_torch_replay import JaxReplaySampler
from test_torch_stream import assert_models_equal, assert_results_equal, grid

torch.set_num_threads(1)


# ------------------------------------------------------------ the manager
class Pair(NamedTuple):
    a: object
    b: object


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "a": np.full((3,), seed, np.int64)},
            "pair": Pair(np.float32(seed), [torch.ones(2), None]),
            "step_scale": np.float32(3.5)}


def _zeros_like(tree):
    return unflatten(tree, [np.zeros_like(np.asarray(x)) if
                            not isinstance(x, torch.Tensor)
                            else torch.zeros_like(x) for x in flatten(tree)])


def _assert_trees_equal(got, want):
    g, w = flatten(got), flatten(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


def test_flatten_order_is_jax_tree_flatten_order():
    tree = _tree(1)
    jax_tree = {"w": 1, "nested": {"b": 2, "a": 3},
                "pair": (4, [5, None]), "step_scale": 6}
    order = [int(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    want = [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (tree["nested"]["a"], tree["nested"]["b"],
                      tree["pair"].a, tree["pair"].b[0], tree["step_scale"],
                      tree["w"])]
    assert order == [3, 2, 4, 5, 6, 1]
    got = flatten(tree)
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, b)
    back = unflatten(tree, got)
    assert list(back) == list(tree) and isinstance(back["pair"], Pair)
    assert back["pair"].b[1] is None


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path)
    t = _tree(1)
    cm.save(5, t, blocking=True)
    restored, step = cm.restore(_zeros_like(t))
    assert step == 5
    _assert_trees_equal(restored, t)
    on_dev, _ = cm.restore(_zeros_like(t), device="cpu")
    assert isinstance(on_dev["w"], torch.Tensor)
    assert torch.equal(on_dev["w"], t["w"])
    assert on_dev["nested"]["b"].dtype == torch.int32


def test_checkpoint_async_latest_and_prune(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    cm.wait()
    assert cm.latest_step() == 4
    assert cm.all_steps() == [3, 4]
    restored, _ = cm.restore(_zeros_like(_tree(0)), 3)
    _assert_trees_equal(restored, _tree(3))


def test_checkpoint_crc_detects_corruption(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree(2), blocking=True)
    d = cm.root / "step_000000001"
    f = sorted(d.glob("arr_*.npy"))[0]
    arr = np.load(f)
    shape = arr.shape
    arr = arr.reshape(-1)
    arr[0] += 1
    np.save(f, arr.reshape(shape))
    with pytest.raises(IOError):
        cm.restore(_zeros_like(_tree(2)))


def test_checkpoint_shape_and_leaf_count_checked(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"a": np.zeros((3, 2), np.float32)}, blocking=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        cm.restore({"a": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"a": np.zeros((3, 2)), "b": np.zeros(1)})


def test_checkpoint_interrupted_write_invisible(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree(0), blocking=True)
    # simulate a crashed writer: stale tmp dir must be ignored
    (cm.root / "step_000000009.tmp").mkdir()
    assert cm.latest_step() == 1


def test_checkpoint_async_write_error_reraised(tmp_path, monkeypatch):
    """A failed async write does not die silently with the daemon thread:
    wait() re-raises it on the caller, and so does the next save()."""
    cm = CheckpointManager(tmp_path)
    orig = np.save

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", boom)
    cm.save(1, _tree(0))             # async: enqueues, returns immediately
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.all_steps() == []      # the failed step was never published
    cm.save(2, _tree(0))
    with pytest.raises(OSError, match="disk full"):
        cm.save(3, _tree(0), blocking=True)
    assert cm.all_steps() == []
    monkeypatch.setattr(np, "save", orig)
    cm.save(4, _tree(0), blocking=True)
    assert cm.latest_step() == 4


def _hold_writer(cm, monkeypatch):
    """Keep ``cm``'s writer thread from writing until the returned event
    is set."""
    gate, write = threading.Event(), cm._do_write

    def held(*a, **k):
        assert gate.wait(30)
        return write(*a, **k)

    monkeypatch.setattr(cm, "_do_write", held)
    return gate


def test_async_save_holds_cpu_tensors_at_save_time(tmp_path, monkeypatch):
    """save() copies CPU tensors before it returns: tensors updated in
    place while the writer thread has not yet written them come back with
    their values at save time (and pass the checksum)."""
    cm = CheckpointManager(tmp_path)
    t = _tree(5)
    want = _tree(5)
    gate = _hold_writer(cm, monkeypatch)
    cm.save(1, t)
    t["w"].mul_(-3.0).add_(1.0)
    t["nested"]["b"].add_(9)
    t["pair"][1][0].zero_()
    gate.set()
    cm.wait()
    restored, _ = cm.restore(_zeros_like(want))
    _assert_trees_equal(restored, want)


def test_meta_roundtrip_and_rejects_non_json(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree(0), blocking=True, meta={"format": "x", "t": (1, 2)})
    assert cm.read_meta() == {"format": "x", "t": [1, 2]}
    with pytest.raises(TypeError, match="JSON"):
        cm.save(2, _tree(0), meta={"bad": object()})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_generic_checkpoint_crosses_packages(tmp_path, writer):
    tree = {"z": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": {"k": np.asarray([7, 9], np.uint32), "n": np.int64(4)},
            "m": (np.float32(1.5), np.zeros((0, 5), np.float32))}
    like = {"z": np.zeros((2, 3), np.float32),
            "a": {"k": np.zeros(2, np.uint32), "n": np.int64(0)},
            "m": (np.float32(0), np.zeros((0, 5), np.float32))}
    if writer == "jax":
        JaxManager(tmp_path).save(3, tree, blocking=True, meta={"f": 1})
        got, step = CheckpointManager(tmp_path).restore(like)
        assert CheckpointManager(tmp_path).read_meta() == {"f": 1}
    else:
        CheckpointManager(tmp_path).save(3, tree, blocking=True,
                                         meta={"f": 1})
        got, step = JaxManager(tmp_path).restore(
            jax.tree.map(jnp.asarray, like))
        assert JaxManager(tmp_path).read_meta() == {"f": 1}
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ the service
SVC = dict(dim=4, k=4, t=12, leaf_size=256, refresh_every=1500,
           micro_batch=64, window=3000, seed=5, metric="l1")


def _assert_same_service(got, want):
    """``got`` (port) holds ``want``'s (reference) state, model and scores."""
    for a, b in zip(got.tree.packed_root(), want.tree.packed_root()):
        np.testing.assert_array_equal(a, b)
    assert_models_equal(got.model, want.model)
    q = grid(150, seed=21)
    assert_results_equal(got.score(q), want.score(q))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_service_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by one package's service restores in the
    other's; both then ingest the same rows and stay equal."""
    key = jax.random.key(5)
    x = grid(6000, seed=20)
    cfg_j, cfg_p = J.ServiceConfig(**SVC), ServiceConfig(**SVC)
    if writer == "jax":
        want = J.StreamService(cfg_j, key)
        want.ingest(x[:3500])
        want.save(JaxManager(tmp_path), step=2)
        got = StreamService.restore(
            cfg_p, CheckpointManager(tmp_path),
            sampler_from_key_data=JaxReplaySampler.from_key_data,
            device="cpu")
    else:
        writer_svc = StreamService(cfg_p, JaxReplaySampler(key),
                                   device="cpu")
        writer_svc.ingest(x[:3500])
        writer_svc.save(CheckpointManager(tmp_path), step=2)
        want = J.StreamService.restore(cfg_j, JaxManager(tmp_path))
        got = writer_svc
    assert int(got.model.version) == int(want.model.version) >= 2
    assert got._next_id == want._next_id
    assert got._since_refresh == want._since_refresh
    _assert_same_service(got, want)
    # on from the checkpoint: the next cadence refresh and its model too
    got.ingest(x[3500:])
    want.ingest(x[3500:])
    assert int(got.model.version) == int(want.model.version)
    _assert_same_service(got, want)


def test_service_restore_rejects_other_format(tmp_path):
    CheckpointManager(tmp_path).save(1, {"a": np.zeros(1)}, blocking=True,
                                     meta={"format": "sharded-stream-v1"})
    with pytest.raises(ValueError, match="not a single-host"):
        StreamService.restore(ServiceConfig(**SVC),
                              CheckpointManager(tmp_path), device="cpu")


def test_service_ingest_after_restore_with_smaller_cadence(tmp_path):
    """A checkpoint may carry since_refresh >= the restoring config's
    refresh_every; ingest must refresh instead of slicing backwards."""
    x = grid(1600, d=3, seed=12)
    base = dict(dim=3, k=4, t=8, leaf_size=256)
    svc = StreamService(ServiceConfig(**base, refresh_every=4096),
                        device="cpu")
    svc.ingest(x)   # since_refresh = 1600, no refresh yet
    svc.save(CheckpointManager(tmp_path), step=1)
    small = ServiceConfig(**base, refresh_every=1024)
    restored = StreamService.restore(small, CheckpointManager(tmp_path),
                                     device="cpu")
    restored.ingest(x[:512])
    assert restored.tree.total_ingested == 1600 + 512
    np.testing.assert_allclose(restored.tree.total_weight, 2112, rtol=1e-6)
    assert int(restored.model.version) >= 1


def test_service_checkpoint_restore_identical_scores(tmp_path):
    cfg = ServiceConfig(**{**SVC, "metric": "l2sq"})
    svc = StreamService(cfg, device="cpu")
    x = grid(4000, seed=22)
    svc.ingest(x)
    q = x[64:128]
    before = svc.score(q)
    svc.save(CheckpointManager(tmp_path), step=1)
    restored = StreamService.restore(cfg, CheckpointManager(tmp_path),
                                     device="cpu")
    assert int(restored.model.version) == int(svc.model.version)
    assert_results_equal(restored.score(q), before, same_ids=False)
    restored.ingest(x[:512])
    assert restored.tree.total_ingested == svc.tree.total_ingested + 512


def test_restored_torch_sampler_service_continues_bit_for_bit(tmp_path):
    """The bounded sampler state: a service restored from a checkpoint
    draws on, through leaf flushes, merges and refreshes, exactly what the
    uninterrupted service draws."""
    cfg = ServiceConfig(**{**SVC, "metric": "l2sq", "window": None})
    x = grid(9000, seed=23)
    whole = StreamService(cfg, device="cpu")
    part = StreamService(cfg, device="cpu")
    for svc in (whole, part):
        svc.ingest(x[:4100])
    writer = CheckpointManager(tmp_path)
    part.save(writer, step=7, blocking=False)
    writer.wait()
    restored = StreamService.restore(cfg, CheckpointManager(tmp_path),
                                     device="cpu")
    for svc in (whole, restored):
        svc.ingest(x[4100:])
    assert int(restored.model.version) == int(whole.model.version) >= 5
    np.testing.assert_array_equal(restored.tree.sampler.key_data(),
                                  whole.tree.sampler.key_data())
    for a, b in zip(restored.tree.packed_root(), whole.tree.packed_root()):
        np.testing.assert_array_equal(a, b)
    for name in ("centers", "threshold", "cost"):
        assert torch.equal(getattr(restored.model, name),
                           getattr(whole.model, name)), name
    q = grid(100, seed=24)
    assert_results_equal(restored.score(q), whole.score(q))


def test_bf16_leaves_round_trip_and_read_the_reference(tmp_path):
    """bf16 leaves (a training checkpoint's parameters) are written as the
    reference writes ml_dtypes' bfloat16 (raw two-byte words, "bfloat16"
    in the manifest) and come back as bf16 tensors bit for bit, from the
    port's checkpoint and from the reference's.  The reference's own
    restore cannot read such a leaf back (numpy has no cast from the raw
    words to ml_dtypes' bfloat16; ROADMAP.md queue 3)."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn((5, 7), generator=g).to(torch.bfloat16)
    tree = {"w": w, "m": torch.randn((5, 7), generator=g)}
    like = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
            "m": torch.zeros((5, 7))}
    cm = CheckpointManager(tmp_path / "port")
    cm.save(1, tree, blocking=True)
    meta = tmp_path / "port" / "step_000000001" / "manifest.json"
    assert '"dtype": "bfloat16"' in meta.read_text()
    got, _ = cm.restore(like)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    # the reference writes the same words for the same bf16 values
    jtree = {"w": jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
             "m": jnp.asarray(tree["m"].numpy())}
    JaxManager(tmp_path / "ref").save(2, jtree, blocking=True)
    name = "arr_00001.npy"                   # leaf order: m, w
    a = np.load(tmp_path / "ref" / "step_000000002" / name)
    b = np.load(tmp_path / "port" / "step_000000001" / name)
    assert a.dtype.itemsize == b.dtype.itemsize == 2
    assert a.tobytes() == b.tobytes()
    back, _ = CheckpointManager(tmp_path / "ref").restore(like,
                                                          device="cpu")
    assert torch.equal(back["w"], w) and torch.equal(back["m"], tree["m"])
    with pytest.raises(ValueError):
        JaxManager(tmp_path / "ref").restore(
            {"w": jnp.zeros((5, 7), jnp.bfloat16), "m": jnp.zeros((5, 7))})
