"""The curation configuration enters as new files: ``curate.fit`` resolves
by name to its configuration, dataset, entry, limits, work counts and
metric readers, and its dataset, ``embed_like``, is seeded, has unit rows
and exactly t planted outliers."""
import pytest
import torch

from bench.harness import program
from bench.harness.data import make_data
from bench.harness.spec import BENCH, load_cell, load_metric, load_named
from bench.harness.work import op_work
from bench.reference import judge


def _small(**over):
    cfg = dict(load_cell("curate.fit").config, n=4_096)
    cfg["dataset_args"] = dict(cfg["dataset_args"], t=41, **over)
    return cfg


def test_curate_fit_resolves_to_its_files():
    cell = load_cell("curate.fit")
    cfg = cell.config
    assert (cell.config_name, cell.chips) == ("curate-d768", 1)
    assert (cfg["n"], cfg["d"], cfg["sites"], cfg["k"], cfg["t"]) == (
        2_000_000, 768, 32, 100, 20_000)
    assert cfg["reduced"] == ["n"] and cfg["dataset"] == "embed_like"
    assert cell.traffic["name"] == "fits"
    assert program.entry(cfg) is load_named("entries", "simulate_coordinator")
    assert set(judge.load_limits("curate-d768")) == set(judge.NUMBERS)
    assert (BENCH / "datasets" / "embed_like.py").exists()
    flops, _ = op_work("min_argmin", [(62_500, 768), (10_801, 768)], 4)
    assert flops == 2.0 * 62_500 * 10_801 * 768
    flops, _ = op_work("lloyd_step", [(366_000, 768), (366_000,),
                                      (100, 768)], 4)
    assert flops == 2.0 * 366_000 * 100 * 768 + 2.0 * 366_000 * 768
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"fit_s", "records_per_fit", "setup_s",
            "pairs_per_fit.curate", "min_argmin_roofline.curate"} <= names
    assert all(m["moves"] == "fit_s" for m in cell.per_layer)
    for name in names:
        assert callable(load_metric(name).read)


def test_embed_like_is_seeded_unit_rows_with_t_outliers():
    cfg = _small()
    x, truth = make_data(cfg, 2**31 + 7, "cpu")
    again, truth2 = make_data(cfg, 2**31 + 7, "cpu")
    other, _ = make_data(cfg, 2**31 + 8, "cpu")
    assert x.shape == (4_096, 768) and x.dtype == torch.float32
    assert torch.equal(x, again) and torch.equal(truth, truth2)
    assert not torch.equal(x, other)
    assert torch.allclose(x.norm(dim=1), torch.ones(4_096), atol=1e-5)
    assert int(truth.sum()) == 41


@pytest.mark.parametrize("zipf", [0.0, 1.0, 2.0])
def test_embed_like_topic_sizes_follow_the_exponent(zipf):
    """Rows lie near their topic (cosine ~0.71 at noise 1); a larger
    exponent puts more of them on the first topics, so the rows' mean
    direction grows longer."""
    x, truth = make_data(_small(zipf=zipf, topics=50), 3, "cpu")
    mean = float(x[~truth].mean(0).norm())
    assert 0.0 < mean < 1.0
    if zipf == 2.0:
        assert mean > 0.35
    if zipf == 0.0:
        assert mean < 0.2
