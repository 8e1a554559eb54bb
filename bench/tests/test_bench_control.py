"""The control, the plain reference computed with TF32 matrix products in
the program's place, is judged not correct at each cell's own size, on
three seeds; the program at the same size is judged correct.  On the card
only (``python -m pytest bench/tests -m chip``)."""
import pytest

from bench.harness import program
from bench.harness.data import make_data
from bench.harness.spec import load_cell
from bench.reference import algorithm, judge

CELLS = ["kdd.fit", "susy.fit", "kdd4.fit"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_judged_wrong(workload, card):
    cell = load_cell(workload)
    cfg, n_fits = cell.config, int(cell.traffic["check_fits"])
    limits = judge.load_limits(cell.config_name)
    for seed in (9031, 9032, 9033):
        x, _ = make_data(cfg, seed, card)
        answers = [algorithm.fit(x, cfg, program.fit_seed(seed, i),
                                 tf32=True) for i in range(n_fits)]
        correct, numbers, _ = judge.judge(x, answers, cfg, limits)
        assert not correct, (seed, numbers)


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["kdd.fit", "susy.fit"])
def test_program_is_judged_correct(workload, card):
    cell = load_cell(workload)
    cfg, n_fits = cell.config, int(cell.traffic["check_fits"])
    x, _ = make_data(cfg, 9041, card)
    fit = program.make_fit(cfg, x, card)
    answers = [program.to_host(fit(program.fit_seed(9041, i)))
               for i in range(n_fits)]
    correct, numbers, _ = judge.judge(
        x, answers, cfg, judge.load_limits(cell.config_name))
    assert correct, numbers
