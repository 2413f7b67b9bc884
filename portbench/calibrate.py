"""Readings that the limits of a cell's comparison are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> --base <seed>
        [--seconds <s>] [--control <n>] [--faults frozen,half]
        [--program-faults frozen,half]

In one process: the program's sound runs on ``n`` seeds (a short window
each, the cell's own sizes), giving each compared number's lower reading
(the largest); then, on the first ``--control`` seeds, the control (the
reference in bfloat16 in the program's place), each ``--faults`` planted in
the reference in its place, and each ``--program-faults`` planted in the
program's timed path through a whole run, giving the upper readings (the
smallest).  One JSON line a reading, then a summary line.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run  # noqa: E402  (sets the cache directories first)
from portbench import cells  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=2147483000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--program-faults", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [args.base + 7919 * k for k in range(args.seeds)]
    lower, upper = {}, {}
    for seed in seeds:
        r = run.run_cell(args.workload, seed, args.seconds, False, device=args.device)
        got = {k: v["value"] for k, v in r["checks"].items()}
        print(json.dumps({"kind": "program", "seed": seed, "numbers": got,
                          "metrics": r["metrics"]}), flush=True)
        for k, v in got.items():
            lower[k] = max(lower.get(k, 0.0), v)

    def upper_of(name, seed, got):
        print(json.dumps({"kind": name, "seed": seed, "numbers": got}), flush=True)
        for k, v in got.items():
            upper.setdefault(name, {})[k] = min(upper.get(name, {}).get(k, float("inf")), v)

    kinds = [None] + [f for f in args.faults.split(",") if f]
    for seed in seeds[:args.control]:
        ctx, cell = run.context(args.workload, seed, args.device)
        mod = cells.driver(cell["driver"])
        for fault in kinds:
            upper_of(fault or "control", seed, mod.control(ctx, fault))
        for fault in [f for f in args.program_faults.split(",") if f]:
            r = run.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                             fault=fault)
            upper_of(f"program_{fault}", seed, {k: v["value"] for k, v in r["checks"].items()})
    print(json.dumps({"kind": "summary", "workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
