"""Run one cell of ``BENCHMARK.json`` on the machine this starts on.

    python3 bench/run.py --workload kdd.fit --seed 7 --seconds 10 --trace 0

Makes the cell's rows on the card from ``--seed``, builds and warms the
fit's kernels, runs fits back to back for ``--seconds``, and judges a
sample of them against the plain reference (``bench/reference``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a device trace of the
window), ``device`` and, traced, ``breakdown``; its last key, ``check``,
holds each number compared with its limit, which are also the last lines
of standard error.

Exits non-zero and prints no result where there is no CUDA device or
fewer than the cell asks for, where the program's package is not in the
checkout, or where ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` is loaded once the window has closed, in this process or in any
rank of a cell on several cards.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")   # nothing in /dev/shm
    import torch
    from bench.harness.runner import (ForbiddenModules, forbidden_modules,
                                      run_cell)
    from bench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        result, lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0", T_START)
    except ForbiddenModules as e:
        print(f"bench: {e}", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of the JAX side are loaded: {bad}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
