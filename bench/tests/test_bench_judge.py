"""The judge on answers of the plain reference at a small size: a sound
answer reads low on every number, and each kind of wrong answer reads high
on the number that is there for it."""
import copy

import numpy as np
import pytest
import torch

from bench.harness.data import make_data
from bench.reference import algorithm, judge
from bench.tests.small import SMALL_LIMITS, small_cell


@pytest.fixture(scope="module")
def case():
    cfg = small_cell("kdd.fit").config
    x, _ = make_data(cfg, 5, "cpu")
    return x, cfg, algorithm.fit(x, cfg, 17)


def _nums(case, mutate=None):
    x, cfg, ans = case
    ans = copy.deepcopy(ans)
    if mutate:
        mutate(ans)
    return judge.judge_fit(x, ans, cfg)


def test_sound_answer_reads_low(case):
    nums = _nums(case)
    assert all(nums[k] <= SMALL_LIMITS[k] for k in judge.NUMBERS), nums


def test_judge_counts_wrong_answers(case):
    x, cfg, ans = case
    ok, _, wrong = judge.judge(x, [ans, ans], cfg, SMALL_LIMITS)
    assert ok and wrong == 0
    bad = copy.deepcopy(ans)
    bad["cost"] *= 2
    ok, worst, wrong = judge.judge(x, [ans, bad], cfg, SMALL_LIMITS)
    assert not ok and wrong == 1 and worst["cost_gap"] > 0.5


def _move_weight(ans):
    """The heaviest center hands half of its rows to another center of
    its site: each site's mass kept."""
    ids, w, cand = (ans["summary_ids"], ans["summary_weights"],
                    ans["summary_candidates"])
    top = int(np.argmax(np.where(cand, 0, w)))
    other = np.nonzero((ids // 1000 == ids[top] // 1000) & ~cand)[0]
    other = int(other[other != top][0])
    half = w[top] // 2
    w[top] -= half
    w[other] += half


def _drop_centers(ans):
    """Site 0 sends half of its centers; their weight goes to the rest."""
    ids, w, cand = (ans["summary_ids"], ans["summary_weights"],
                    ans["summary_candidates"])
    site0 = np.nonzero((ids < 1000) & ~cand)[0]
    drop = site0[::2]
    w[site0[1]] += w[drop].sum()
    keep = np.ones(ids.size, bool)
    keep[drop] = False
    for key in ("summary_ids", "summary_weights", "summary_candidates"):
        ans[key] = ans[key][keep]
    ans["comm_records"] = float(keep.sum())


@pytest.mark.parametrize("mutate,number", [
    (_move_weight, "moved_share"),
    (_drop_centers, "broken"),
    (lambda a: a.update(cost=a["cost"] * 1.01), "cost_gap"),
    (lambda a: a.update(centers=a["centers"] + 0.5), "center_step"),
    (lambda a: a.update(comm_records=a["comm_records"] + 1), "broken"),
    (lambda a: a.update(outlier_ids=np.concatenate(
        [a["outlier_ids"], a["outlier_ids"][:1]])), "broken"),
])
def test_wrong_answer_reads_high(case, mutate, number):
    nums = _nums(case, mutate)
    assert nums[number] > SMALL_LIMITS[number], nums


def test_quality_against_planted_outliers(case):
    x, cfg, ans = case
    truth = torch.zeros((x.shape[0],), dtype=torch.bool)
    truth[torch.as_tensor(ans["outlier_ids"])] = True
    q = judge.quality([ans], truth)
    assert q["precision"] == 1.0 and q["recall"] == 1.0
