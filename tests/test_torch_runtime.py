"""The port's training runtime against the reference's: the token
pipeline, the straggler monitor, the data curator and the launcher
(``python -m repro_torch.launch.train``), with the reference's own tests
for them mirrored.

Under ``JaxReplaySampler`` the port draws what the reference draws, so the
curator's flagged ids, its records and the monitor's masks are held equal.
Their inputs sit on an integer grid (durations on a dyadic one), where
every distance and mean is exact in f32 and the two frameworks' summation
orders cannot part (``ROADMAP.md`` queue 3, item 1).  A launcher's
checkpoint crosses between the packages in the reference's layout; the
next step's loss is held to rtol 1e-5 (f32, sums in other orders).
"""
import contextlib
import io
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.core.curation import CuratorConfig as JaxCuratorConfig
from repro.core.curation import DataCurator as JaxDataCurator
from repro.data.tokens import PipelineConfig as JaxPipelineConfig
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.runtime.straggler import StragglerMonitor as JaxStragglerMonitor
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.configs import get_config
from repro_torch.core.curation import CuratorConfig, DataCurator
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import RWKV6Model, init_params
from repro_torch.optim import adamw
from repro_torch.runtime import StragglerMonitor

from test_torch_checkpoint import _hold_writer
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)


# ------------------------------------------------------------ data pipeline
@pytest.mark.parametrize("step,shard", [(0, 0), (3, 1), (10, 2), (977, 3)])
def test_token_pipeline_matches_reference(step, shard):
    """Bit for bit the reference's batches, per shard and globally."""
    kw = dict(vocab=512, seq_len=48, global_batch=8, n_shards=4, seed=7)
    mine, ref = TokenPipeline(PipelineConfig(**kw)), \
        JaxTokenPipeline(JaxPipelineConfig(**kw))
    a, b = mine.batch(step, shard)["tokens"], ref.batch(step, shard)["tokens"]
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.global_batch(step)["tokens"],
                                  ref.global_batch(step)["tokens"])


def test_pipeline_deterministic_and_shard_disjoint():
    cfg = PipelineConfig(vocab=64, seq_len=32, global_batch=8, n_shards=4,
                         seed=7)
    p = TokenPipeline(cfg)
    b1 = p.batch(10, 2)["tokens"]
    b2 = p.batch(10, 2)["tokens"]
    np.testing.assert_array_equal(b1, b2)           # resumable
    b3 = p.batch(10, 3)["tokens"]
    assert not np.array_equal(b1, b3)               # shards differ
    b4 = p.batch(11, 2)["tokens"]
    assert not np.array_equal(b1, b4)               # steps differ
    g = p.global_batch(10)["tokens"]
    assert g.shape == (8, 32)


# ------------------------------------------------------------ straggler
def test_straggler_monitor_flags_slow_site():
    mon = StragglerMonitor(n_sites=8, budget_frac=0.2, device="cpu")
    rng = np.random.default_rng(0)
    mask = None
    for _ in range(10):
        d = rng.normal(1.0, 0.02, size=8).astype(np.float32)
        d[3] = 4.0  # persistent straggler
        mask = mon.observe(d)
    assert mask[3]
    assert mask.sum() <= 2
    assert 3 in mon.policy(mask)


def test_straggler_monitor_quiet_when_healthy():
    mon = StragglerMonitor(n_sites=8, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(10):
        mask = mon.observe(rng.normal(1.0, 0.02, size=8).astype(np.float32))
    assert mask.sum() == 0


@pytest.mark.parametrize("slow", [None, 5])
def test_straggler_monitor_matches_reference_under_replay(slow):
    """The same durations (multiples of 1/64 s) into both monitors, the
    port's seeding under ``jax.random.key(0)`` as the reference's: equal
    masks at every step, the EWMA ones and the clustered ones, and equal
    policies."""
    mine = StragglerMonitor(n_sites=8, budget_frac=0.25, device="cpu",
                            sampler=JaxReplaySampler(jax.random.key(0)))
    ref = JaxStragglerMonitor(n_sites=8, budget_frac=0.25)
    rng = np.random.default_rng(2)
    flagged = 0
    for _ in range(12):
        d = (64 + rng.integers(-2, 3, size=8)) / 64.0
        if slow is not None:
            d[slow] = 3.0 + rng.integers(0, 4) / 64.0
        d = d.astype(np.float32)
        a, b = mine.observe(d), ref.observe(d)
        np.testing.assert_array_equal(a, b)
        assert mine.policy(a) == ref.policy(b)
        flagged += int(a.sum())
    assert (flagged > 0) == (slow is not None)


# ------------------------------------------------------------ curation
def test_curator_flags_planted_outlier_sequences():
    cur = DataCurator(n_sites=4, cfg=CuratorConfig(k=8, outlier_frac=0.02,
                                                   min_points=200),
                      device="cpu")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16)) * 3
    planted = []
    sid = 0
    for site in range(4):
        embs, ids = [], []
        for _ in range(400):
            c = rng.integers(0, 8)
            e = centers[c] + rng.normal(scale=0.05, size=16)
            if rng.random() < 0.02:
                e = e + rng.uniform(-30, 30, size=16)
                planted.append(sid)
            embs.append(e), ids.append(sid)
            sid += 1
        cur.observe(site, np.stack(embs), np.array(ids))
    flagged, comm = cur.detect()
    assert flagged is not None and comm > 0
    rec = len(set(flagged.tolist()) & set(planted)) / max(len(planted), 1)
    assert rec >= 0.7
    w = cur.sample_weights(np.array(planted), flagged)
    assert w.mean() <= 0.3


def _grid_embeddings(seed, n_sites, per_site, d=16, k=8, frac=0.03):
    """Integer-grid sequence embeddings: k centers, small integer jitter,
    a few planted rows far off."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-40, 41, size=(k, d)) * 4
    out, planted, sid = [], [], 0
    for _ in range(n_sites):
        c = centers[rng.integers(0, k, per_site)]
        e = c + rng.integers(-2, 3, size=(per_site, d))
        far = rng.random(per_site) < frac
        e[far] += rng.integers(-300, 301, size=(int(far.sum()), d))
        ids = sid + np.arange(per_site)
        planted += ids[far].tolist()
        out.append((e.astype(np.float32), ids))
        sid += per_site
    return out, planted


@pytest.mark.parametrize("reservoir", [4096, 150])
def test_curator_detect_matches_reference_under_replay(reservoir):
    """Both curators fed the same embeddings (with 150 the reservoirs
    overflow and replace rows by the numpy draw both keep), the port's
    draws under ``jax.random.key(cfg.seed)``: the same reservoirs, flagged
    ids, records and weights."""
    kw = dict(k=8, outlier_frac=0.03, min_points=200, reservoir=reservoir,
              seed=4)
    mine = DataCurator(n_sites=4, cfg=CuratorConfig(**kw), device="cpu",
                       sampler=JaxReplaySampler(jax.random.key(4)))
    ref = JaxDataCurator(n_sites=4, cfg=JaxCuratorConfig(**kw))
    assert mine.detect() == ref.detect() == (None, 0.0)
    parts, planted = _grid_embeddings(11, 4, 240)
    for site, (e, ids) in enumerate(parts):
        for lo in range(0, len(ids), 80):
            mine.observe(site, e[lo:lo + 80], ids[lo:lo + 80])
            ref.observe(site, e[lo:lo + 80], ids[lo:lo + 80])
    assert mine.n_points == ref.n_points
    for a, b in zip(mine._ids, ref._ids):
        np.testing.assert_array_equal(a, b)
    fa, ca = mine.detect()
    fb, cb = ref.detect()
    np.testing.assert_array_equal(fa, fb)
    assert ca == cb > 0
    np.testing.assert_array_equal(mine.sample_weights(np.arange(960), fa),
                                  ref.sample_weights(np.arange(960), fb))
    assert len(set(fa.tolist()) & set(planted)) > 0


# ------------------------------------------------------------ launcher
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _jax_main(argv):
    saved = sys.argv
    sys.argv = ["repro.launch.train"] + argv
    try:
        jtrain.main()
    finally:
        sys.argv = saved


SMOKE_ARGS = ["--arch", "rwkv6-7b", "--smoke", "--batch", "2", "--seq",
              "32"]


def test_launch_train_main_cpu_and_resume(tmp_path):
    """SMOKE for 3 steps with a checkpoint every 2, then to 5 steps: it
    resumes from step 1 and prints the reference's lines."""
    argv = SMOKE_ARGS + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--device", "cpu"]
    first = _run(train.main, argv + ["--steps", "3"])
    assert first[0] == "arch=rwkv6-7b devices=1 mesh=None"
    assert first[1].startswith("step     0 loss=")
    assert first[-1] == "done; checkpoints at [1]"
    second = _run(train.main, argv + ["--steps", "5"])
    assert second[1] == "resumed from step 1"
    assert second[-1] == "done; checkpoints at [1, 3]"
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(argv + ["--mesh", "single"])
    # the rglru_hybrid family trains and resumes; the encdec arch, whose
    # audio frontend the token pipeline cannot feed, is refused as the
    # reference's launcher fails on it (queue 3, item 8)
    rg = ["--arch", "recurrentgemma-9b", "--smoke", "--batch", "2", "--seq",
          "24", "--ckpt-every", "2", "--device", "cpu",
          "--ckpt-dir", str(tmp_path / "rg")]
    first = _run(train.main, rg + ["--steps", "3"])
    assert first[0] == "arch=recurrentgemma-9b devices=1 mesh=None"
    assert first[1].startswith("step     0 loss=")
    assert first[-1] == "done; checkpoints at [1]"
    second = _run(train.main, rg + ["--steps", "4"])
    assert second[1] == "resumed from step 1"
    assert second[-1] == "done; checkpoints at [1, 3]"
    with pytest.raises(ValueError, match="queue 3, item 8"):
        train.main(["--arch", "seamless-m4t-medium", "--smoke", "--device",
                    "cpu", "--ckpt-dir", str(tmp_path / "q")])


def test_async_train_checkpoint_holds_the_state_at_save_time(tmp_path,
                                                             monkeypatch):
    """The launcher saves (params, opt_state) asynchronously and steps on;
    AdamW updates the parameters and moments in place.  A checkpoint
    written after the next step has run holds the state at save time, bit
    for bit, and restores it."""
    cfg = get_config("rwkv6-7b", smoke=True)
    model = init_params(cfg, 0, device="cpu")
    step, optc = make_train_step(cfg, device="cpu")
    opt = adamw.init(model, optc)
    model, opt, _ = step(model, opt, {"tokens": _batch(0)})
    want = [x.clone() if isinstance(x, torch.Tensor) else np.copy(x)
            for x in flatten(train.train_state_tree(model, opt))]
    cm = CheckpointManager(tmp_path)
    gate = _hold_writer(cm, monkeypatch)
    cm.save(0, train.train_state_tree(model, opt))
    model, opt, _ = step(model, opt, {"tokens": _batch(1)})
    gate.set()
    cm.wait()
    fresh, got_opt, saved = train.restore_train_state(
        cm, init_params(cfg, 1, device="cpu"), cfg, optc, "cpu")
    assert saved == 0 and int(got_opt.step) == 1
    got = flatten(train.train_state_tree(fresh, got_opt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    changed = flatten(train.train_state_tree(model, opt))
    assert any(not torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(changed, want))


def _batch(step):
    pipe = TokenPipeline(PipelineConfig(vocab=512, seq_len=32,
                                        global_batch=2, seed=0))
    return pipe.global_batch(step)["tokens"]


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's launcher writes (params, opt_state) at step 2 (three
    optimizer steps taken); the port restores it and takes step 3, as the
    reference does from the same checkpoint: the same loss, grad norm and
    learning rate, and the optimizer's fourth step."""
    _jax_main(SMOKE_ARGS + ["--steps", "3", "--ckpt-every", "3",
                            "--ckpt-dir", str(tmp_path)])
    cfg = get_config("rwkv6-7b", smoke=True)
    jstep, joptc = jax_make_train_step(cfg, None)
    like = jtf.init_params(cfg, jax.random.key(0))
    (jp, jo), step = JaxCheckpointManager(tmp_path).restore(
        (like, jadamw.init(like, joptc)))
    assert step == 2
    _, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(_batch(3))})

    model = init_params(cfg, 1, device="cpu")
    tstep, optc = make_train_step(cfg, device="cpu")
    model, opt, got = train.restore_train_state(
        CheckpointManager(tmp_path), model, cfg, optc, "cpu")
    assert got == 2 and int(opt.step) == 3
    _, opt, m = tstep(model, opt, {"tokens": _batch(3)})
    assert int(opt.step) == int(jo.step) == 4
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The other way: the port's launcher writes, the reference's manager
    restores into its own (params, opt_state) layout, leaf for leaf the
    port's state."""
    argv = SMOKE_ARGS + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--device", "cpu", "--steps", "2"]
    _run(train.main, argv)
    cfg = get_config("rwkv6-7b", smoke=True)
    like = jtf.init_params(cfg, jax.random.key(0))
    (jp, jo), step = JaxCheckpointManager(tmp_path).restore(
        (like, jadamw.init(like, jadamw.AdamWConfig())))
    model = RWKV6Model(cfg, "cpu")
    model, opt, _ = train.restore_train_state(
        CheckpointManager(tmp_path), model, cfg, adamw.AdamWConfig(), "cpu")
    assert step == 1 and int(jo.step) == int(opt.step) == 2
    mine = train.train_state_tree(model, opt)
    ref_leaves = jax.tree.leaves((jp, jo))
    assert len(flatten(mine)) == len(ref_leaves)
    for a, b in zip(flatten(mine), ref_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
