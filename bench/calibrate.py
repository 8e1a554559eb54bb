"""The readings that a configuration's limits,
``bench/reference/limits/<config>.json``, are set from, at a cell's own
size, on the card.

    python3 bench/calibrate.py --workload kdd.fit --seeds 11-22 \
        --control-seeds 31-33 --out cal_kdd.json

For each ``--seeds`` seed (``--fault``: with that fault of
``bench/tests/faults.py`` planted in the program): the cell's rows, then as many fits of the
program as a run checks (the traffic's ``check_fits``, sampler seeds as a
run's), each judged; a seed's reading of a number is the largest over its
fits, as in a run.  For each ``--control-seeds`` seed the same with the
control in the program's place: the plain reference (``bench/reference``)
with TF32 matrix products, the nearest precision below the configuration's
float32.  ``--reference-seeds`` adds the reference at float32 (TF32 off),
a second witness that sound answers read low.  Prints, per number, the
lower reading (largest over the program's seeds) and the upper (smallest
over the control's), writes every reading to ``--out``, and names the
configuration's limits file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _program_answers(rank, world, device, cell, seeds, judge_seed=None,
                     t_start=None):
    """Fits of the program per seed on this rank; ``judge_seed(seed, x,
    answers)`` on rank 0."""
    import torch
    import torch.distributed as dist
    from bench.harness import program
    from bench.harness.data import make_data
    n_fits = int(cell.traffic["check_fits"])
    for j, seed in enumerate(seeds):
        x, _ = make_data(cell.config, seed, device)
        fit = program.make_fit(cell.config, x, device)
        if j == 0:
            fit(program.fit_seed(seed, -1))            # warm
        answers = [program.to_host(fit(program.fit_seed(seed, i)))
                   for i in range(n_fits)]
        del fit
        if judge_seed:
            judge_seed(seed, x, answers)
        del x
        torch.cuda.empty_cache()
        if world > 1:
            dist.barrier()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--reference-seeds", default="")
    ap.add_argument("--fault", default="",
                    help="plant this fault of bench/tests/faults.py in the "
                         "program for the --seeds runs")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from bench.harness import program
    from bench.harness.data import make_data
    from bench.harness.runner import ranks
    from bench.harness.spec import load_cell
    from bench.reference import algorithm, judge
    from bench.tests.faults import plant
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    cfg, n_fits = cell.config, int(cell.traffic["check_fits"])
    readings = {"program": {}, "control": {}, "reference": {}}

    def record(kind, seed, x, answers):
        t0 = time.perf_counter()
        nums = [judge.judge_fit(x, a, cfg) for a in answers]
        worst = {k: max(float(n.get(k, float("inf"))) for n in nums)
                 for k in judge.NUMBERS}
        readings[kind][seed] = worst
        print(f"{kind} seed {seed} {json.dumps(worst)} judge_s "
              f"{time.perf_counter() - t0:.2f}", flush=True)

    seeds = _seeds(args.seeds)
    if args.fault:
        plant(args.fault)
    if seeds:
        with ranks(cell.chips, "cuda", _program_answers, (cell, seeds),
                   (plant, args.fault) if args.fault else None) as dev:
            _program_answers(0, cell.chips, dev, cell, seeds,
                             lambda s, x, a: record("program", s, x, a))
    dev = torch.device("cuda:0")
    for kind, text, tf32 in (("control", args.control_seeds, True),
                             ("reference", args.reference_seeds, False)):
        for seed in _seeds(text):
            x, _ = make_data(cfg, seed, dev)
            t0 = time.perf_counter()
            answers = [algorithm.fit(x, cfg, program.fit_seed(seed, i),
                                     tf32=tf32) for i in range(n_fits)]
            print(f"{kind} seed {seed} fit_s "
                  f"{(time.perf_counter() - t0) / n_fits:.2f}", flush=True)
            record(kind, seed, x, answers)
            del x
            torch.cuda.empty_cache()
    summary = {}
    for k in judge.NUMBERS:
        lo = [r[k] for r in readings["program"].values()]
        hi = [r[k] for r in readings["control"].values()]
        summary[k] = {"lower": max(lo) if lo else None,
                      "upper": min(hi) if hi else None,
                      "program_median": float(np.median(lo)) if lo else None}
        print(f"number {k} lower {summary[k]['lower']} upper "
              f"{summary[k]['upper']}", flush=True)
    print(f"limits set from these readings go to "
          f"{judge.LIMITS / (cell.config_name + '.json')}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "device":
                   torch.cuda.get_device_name(dev), "readings": readings,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
