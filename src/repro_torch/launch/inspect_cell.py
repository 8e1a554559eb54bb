"""Hill-climbing helper, port of ``repro.launch.inspect_cell``: count one
cell (optionally with config overrides), write its per-op rows, and print
the top collectives / products / copies / gathers by local bytes.

  PYTHONPATH=src python -m repro_torch.launch.inspect_cell qwen2-72b \\
      train_4k [--multi] [--set remat_policy=dots] [--top 15]

The reference dumps the partitioned HLO to ``/tmp/{arch}_{shape}.hlo`` and
walks it; the port has no HLO and writes the counted rows of
``launch/hlo.py`` (one per op and input shapes, with its count, bytes,
flops and wire bytes) as JSON to ``artifacts/inspect_cell/{arch}_{shape}
.json`` under the working directory.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import lower_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--dp-tp", default=None,
                    help="logical mesh reshape, e.g. 64,4")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--kind", default=None,
                    help="filter: all-gather/all-reduce/dot/copy/gather/...")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    rows_path = Path("artifacts/inspect_cell") / f"{args.arch}_{args.shape}.json"
    dp_tp = tuple(int(v) for v in args.dp_tp.split(",")) if args.dp_tp \
        else None
    rec = lower_cell(args.arch, args.shape, args.multi,
                     dump_hlo=str(rows_path), cfg_overrides=overrides or None,
                     dp_tp=dp_tp)
    for k in ("hlo_flops", "hlo_bytes", "wire_bytes", "compute_s", "memory_s",
              "collective_s", "bottleneck", "useful_flops_ratio"):
        print(f"{k:22s} {rec.get(k)}")
    if rec.get("status") != "ok":
        print(rec.get("reason", ""))
        return
    print(f"collectives: { {k: (v['count'], round(v['wire_bytes'] / 1e9, 2)) for k, v in rec.get('collectives', {}).items()} }")
    print(f"\nrows at {rows_path}; top-{args.top} contributors:")
    rows = json.loads(rows_path.read_text())
    if args.kind:
        rows = [r for r in rows if r["kind"] == args.kind]
    else:
        rows = [r for r in rows if r["kind"] not in ("pointwise", "op")]
    key = "wire_bytes" if args.kind and "-" in args.kind else "bytes"
    rows.sort(key=lambda r: -max(r[key], r["wire_bytes"]))
    for r in rows[: args.top]:
        b = max(r["bytes"], r["wire_bytes"])
        print(f"  {r['kind']:14s} {b / 1e9:9.2f} GB x{r['count']:<5d} "
              f"{r['op']} {r['shapes']}"[:150])


if __name__ == "__main__":
    main()
