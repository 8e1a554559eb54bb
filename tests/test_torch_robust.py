"""The port's gradient compression (``optim/compression.py``), robust
aggregation (``runtime/robust_agg.py``) and elastic runner
(``runtime/elastic.py``) against the reference, on the CPU.

Tolerances:
* compression: the int8 codes are equal; the scale and the residual, one
  f32 division and product each on both sides, within 1 ulp.  The bf16
  codes are equal, and their residuals within 1 ulp.
* ``sketch``: under ``JaxReplaySampler`` the Rademacher signs are the
  reference's bit for bit; the projection is a dot of 4,096 products
  summed in another order, so the unit-norm sketch is held within 1e-6.
* ``robust_mean_grads`` on 8 gloo ranks against the reference's under
  ``jax.vmap`` with its axis name (the same ``all_gather`` / ``psum`` /
  ``axis_index`` semantics on one CPU device): the same flags and honest
  count; the mean, a sum over ranks in another order, within 1e-5.
* ``ElasticRunner``: the reference test's scenario
  (``tests/test_checkpoint_runtime.py``), its assertions, and the exact
  restart steps.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import compression as JC
from repro.runtime import robust_agg as JR
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim import compression as TC
from repro_torch.runtime import robust_agg as TR
from repro_torch.runtime.elastic import (DeviceFailure, ElasticConfig,
                                         ElasticRunner)
from test_torch_collective import spawn_ranks
from test_torch_replay import JaxReplaySampler

torch.set_num_threads(1)

SKETCH_TOL = 1e-6
MEAN_TOL = 1e-5


def replay(seed):
    """The reference's ``jax.random.key(seed)`` behind the port's seam."""
    return JaxReplaySampler(jax.random.key(seed))


def grad_tree(seed):
    """A nested tree with a leaf longer than the sketch's 4,096 entries, a
    matrix, a tiny leaf and one of zeros."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(70, 90)).astype(np.float32) * 3,
            "b": {"bias": rng.normal(size=(5,)).astype(np.float32) * 1e-3,
                  "zero": np.zeros((4, 3), np.float32)},
            "long": rng.normal(size=(5000,)).astype(np.float32)}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def flat(tree, prefix=""):
    """{path: leaf} of a dict tree (pairs kept whole)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in flat(tree[k],
                                                    f"{prefix}/{k}").items()}
    return {prefix: tree}


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_compression_matches_reference_leaf_for_leaf(scheme):
    """Five steps of encode with error feedback on a changing gradient,
    then decode, on both sides."""
    jenc, jdec = getattr(JC, f"encode_{scheme}"), getattr(JC, f"decode_{scheme}")
    tenc, tdec = getattr(TC, f"encode_{scheme}"), getattr(TC, f"decode_{scheme}")
    jef, tef = JC.init_ef(to_jax(grad_tree(0))), TC.init_ef(
        to_torch(grad_tree(0)))
    for name, r in flat(tef.residual).items():
        assert r.dtype == torch.float32 and not r.any(), name
    for step in range(5):
        g = grad_tree(step)
        jq, jef = jenc(to_jax(g), jef)
        tq, tef = tenc(to_torch(g), tef)
        jqs, tqs = flat(jq), flat(tq)
        assert set(jqs) == set(tqs)
        for name, want in jqs.items():
            got = tqs[name]
            if scheme == "int8":
                assert got[0].dtype == torch.int8
                np.testing.assert_array_equal(got[0].numpy(),
                                              np.asarray(want[0]))
                np.testing.assert_array_max_ulp(
                    got[1].numpy(), np.asarray(want[1], np.float32), 1)
            else:
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got.float().numpy(), np.asarray(want, np.float32))
        for name, want in flat(jef.residual).items():
            np.testing.assert_array_max_ulp(
                flat(tef.residual)[name].numpy(), np.asarray(want), 1)
        for name, want in flat(jdec(jq)).items():
            got = flat(tdec(tq))[name]
            assert got.dtype == torch.float32
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), 1)


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_compression_error_feedback_converges(scheme):
    """``tests/test_hlo_optim.py``'s check on the port: the time-average of
    50 decoded steps approaches the true gradient; and the int8 residual
    stays within half a quantization step."""
    enc, dec = getattr(TC, f"encode_{scheme}"), getattr(TC, f"decode_{scheme}")
    rng = np.random.default_rng(2)
    g_true = {"w": torch.as_tensor(rng.normal(size=(256,)), dtype=torch.float32)}
    ef = TC.init_ef(g_true)
    acc = torch.zeros((256,))
    n = 50
    for _ in range(n):
        q, ef = enc(g_true, ef)
        acc = acc + dec(q)["w"]
        if scheme == "int8":
            scale = float(q["w"][1])
            assert float(ef.residual["w"].abs().max()) <= \
                scale * (0.5 + 2 ** -16)
    assert float((acc / n - g_true["w"]).abs().max()) < 0.02


# ------------------------------------------------------------ sketch
@pytest.mark.parametrize("m", [1, 37, 4096])
def test_rademacher_signs_are_the_references(m):
    key = jax.random.split(jax.random.key(11), 3)[2]
    got = TR.rademacher(JaxReplaySampler(key), (TR.PROJ, m))
    want = jax.random.rademacher(key, (TR.PROJ, m), jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7])
def test_sketch_matches_reference(seed):
    g = grad_tree(seed + 1)
    want = np.asarray(JR.sketch(to_jax(g), seed))
    got = TR.sketch(to_torch(g), seed, sampler_from_seed=replay)
    assert got.shape == (TR.PROJ,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SKETCH_TOL,
                               atol=SKETCH_TOL)
    # the production sampler draws other signs: another sketch, unit norm
    other = TR.sketch(to_torch(g), seed)
    assert abs(float(torch.linalg.vector_norm(other)) - 1) < 1e-6
    assert not np.allclose(other.numpy(), want, atol=1e-3)


# ------------------------------------------------------------ robust mean
def byzantine_grads(n=8, D=32, bad=5):
    """The reference test's input: a shared base plus 1% noise per replica,
    replica ``bad`` set to 1000."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=D).astype(np.float32)
    grads = np.stack([base + rng.normal(scale=0.01, size=D).astype(
        np.float32) for _ in range(n)])
    grads[bad] = 1000.0
    return base, grads


def _robust_rank(rank, n, workdir, grads, budget):
    mean, (n_honest, flagged) = TR.robust_mean_grads(
        {"w": torch.as_tensor(grads[rank])}, byzantine_budget=budget,
        sampler_from_seed=replay)
    return {"mean": mean["w"].numpy(), "n_honest": int(n_honest),
            "flagged": bool(flagged), "dtype": str(mean["w"].dtype)}


def test_robust_mean_matches_reference_on_8_ranks(tmp_path):
    base, grads = byzantine_grads()
    budget = 2

    def per(g):
        mean, (nh, fl) = JR.robust_mean_grads({"w": g}, "data",
                                              byzantine_budget=budget)
        return mean["w"], nh, fl

    jmean, jnh, jfl = jax.vmap(per, axis_name="data")(jnp.asarray(grads))
    ranks = spawn_ranks(_robust_rank, 8, tmp_path, grads, budget)
    assert [r["flagged"] for r in ranks] == [bool(f) for f in np.asarray(jfl)]
    assert [r["n_honest"] for r in ranks] == [int(h) for h in np.asarray(jnh)]
    for r in ranks:
        assert r["dtype"] == "torch.float32"
        np.testing.assert_array_equal(r["mean"], ranks[0]["mean"])
        np.testing.assert_allclose(r["mean"], np.asarray(jmean)[0],
                                   rtol=0, atol=MEAN_TOL)
    # the reference test's own assertions
    assert ranks[5]["flagged"] and ranks[0]["n_honest"] >= 6
    assert float(np.abs(ranks[0]["mean"] - base).max()) < 0.05
    assert float(np.abs(grads.mean(0) - base).max()) > 10.0


# ------------------------------------------------------------ elastic
D_EL = 16


def elastic_scenario(device, tmp):
    """The reference test's scenario on ``device`` (8 logical replicas of
    it): a linear regression, the global batch of 8 rows split evenly over
    the mesh's replicas and their gradients averaged."""
    def make_step(mesh):
        dev = mesh[0]

        def run(state, batch):
            w, opt_step = state
            x = torch.as_tensor(batch["x"], device=dev)
            y = torch.as_tensor(batch["y"], device=dev)
            w = w.detach().requires_grad_(True)
            losses = [((xs @ w - ys) ** 2).mean()
                      for xs, ys in zip(x.chunk(len(mesh)), y.chunk(len(mesh)))]
            loss = sum(losses) / len(losses)
            (g,) = torch.autograd.grad(loss, [w])
            return ((w - 0.1 * g).detach(), opt_step + 1), \
                {"loss": loss.detach()}
        return run

    def init_state(mesh):
        return (torch.zeros(D_EL, device=mesh[0]),
                torch.zeros((), dtype=torch.int32, device=mesh[0]))

    w_true = np.random.default_rng(0).normal(size=D_EL)

    def data_fn(step):
        r = np.random.default_rng(step)
        x = r.normal(size=(8, D_EL)).astype(np.float32)
        return {"x": x, "y": (x @ w_true).astype(np.float32)}

    return ElasticRunner(make_step=make_step, init_state=init_state,
                         state_shardings=lambda mesh, state: mesh[0],
                         data_fn=data_fn, ckpt=CheckpointManager(tmp),
                         cfg=ElasticConfig(ckpt_every=5))


def test_elastic_runner_survives_failures(tmp_path):
    runner = elastic_scenario(torch.device("cpu"), tmp_path)
    state, log = runner.run(60, devices=[torch.device("cpu")] * 8,
                            fail_at={23: 4, 41: 2})
    assert log["remesh_steps"] == [21, 41]     # the last checkpoints + 1
    assert sorted(set(log["device_counts"]), reverse=True) == [8, 4, 2]
    assert log["device_counts"] == [8] * 23 + [4] * 20 + [2] * 19
    assert log["losses"][-1] < 1e-2
    assert int(state[1]) == 60
    # a fresh runner on the same directory resumes after the last checkpoint
    again = elastic_scenario(torch.device("cpu"), tmp_path)
    _, log2 = again.run(62, devices=[torch.device("cpu")] * 3)
    assert log2["device_counts"] == [2] * 6    # steps 56..61 on 2 of 3


def test_elastic_runner_limits(tmp_path):
    runner = elastic_scenario(torch.device("cpu"), tmp_path)
    runner.cfg = ElasticConfig(ckpt_every=5, max_failures=1)
    with pytest.raises(RuntimeError, match="too many failures") as e:
        runner.run(30, devices=[torch.device("cpu")] * 8,
                   fail_at={3: 1, 4: 1})
    assert isinstance(e.value.__cause__, DeviceFailure)
    assert runner.make_mesh([torch.device("cpu")] * 7) == \
        [torch.device("cpu")] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            elastic_scenario(torch.device("cpu"), tmp_path / "x").run(3)


def test_a_scaled_gradient_has_the_honest_sketch():
    """The sketch is normalized, so a replica that sends its gradient x
    1,000 (a scaled copy of the honest direction) has the honest sketch in
    both packages: k-means-- cannot flag it."""
    g = grad_tree(3)
    scaled = {k: (v * 1000 if not isinstance(v, dict) else
                  {kk: vv * 1000 for kk, vv in v.items()})
              for k, v in g.items()}
    want = np.asarray(JR.sketch(to_jax(g), 0))
    np.testing.assert_allclose(np.asarray(JR.sketch(to_jax(scaled), 0)),
                               want, rtol=0, atol=SKETCH_TOL)
    got = TR.sketch(to_torch(scaled), 0, sampler_from_seed=replay)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SKETCH_TOL)


def _narrow_rglru():
    from repro_torch.configs import get_config
    return get_config("recurrentgemma-9b", smoke=True).replace(
        n_layers=4, attn_q_chunk=8)


def _train_runner(tmp):
    """An ElasticRunner over ``make_train_step`` of recurrentgemma at SMOKE
    width: the state is (params, opt_state) in the checkpoint's layout."""
    from repro_torch.data.tokens import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_state_tree
    from repro_torch.models.transformer import (build_model, init_params,
                                                load_params_)
    from repro_torch.optim import adamw
    cfg = _narrow_rglru()
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=24,
                                        global_batch=2, seed=3))

    def make_step(mesh):
        step, _ = make_train_step(cfg, device=mesh[0])
        holder = build_model(cfg, mesh[0])

        def run(state, batch):
            params, opt_tree = state
            load_params_(holder, params)
            opt = adamw.opt_state_from_numpy(opt_tree, cfg, mesh[0])
            model, opt, m = step(holder, opt, batch)
            return train_state_tree(model, opt), m
        return run

    def init_state(mesh):
        model = init_params(cfg, 5, device=mesh[0])
        _, optc = make_train_step(cfg, device=mesh[0])
        return train_state_tree(model, adamw.init(model, optc))

    return ElasticRunner(
        make_step=make_step, init_state=init_state,
        state_shardings=lambda mesh, state: mesh[0],
        data_fn=lambda step: {"tokens": pipe.global_batch(step)["tokens"]},
        ckpt=CheckpointManager(tmp), cfg=ElasticConfig(ckpt_every=3))


def test_elastic_restart_of_a_train_step_is_bit_for_bit(tmp_path):
    """A failure after the step-3 checkpoint: the run restarts at step 4 on
    the shrunk mesh and its losses from there are the uninterrupted run's,
    bit for bit (the data cursor is the step)."""
    cpu = [torch.device("cpu")] * 8
    _, plain = _train_runner(tmp_path / "plain").run(8, devices=cpu)
    state, failed = _train_runner(tmp_path / "fail").run(8, devices=cpu,
                                                         fail_at={5: 4})
    assert failed["remesh_steps"] == [4]
    assert failed["device_counts"] == [8] * 5 + [4] * 4
    assert failed["losses"] == plain["losses"][:5] + plain["losses"][4:]
    assert int(state[1].step) == 8
