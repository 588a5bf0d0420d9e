"""Readings that the check limits are set from, in one process: the
program's on many seeds, and the control's (controls.py: the reference in
the program's place, one precision below the configuration's) on a few,
each at the cell's own size through the harness's own window and check.

    python3 -m ifebench.calibrate --workload <cell> --seeds 1 2 3 ...
        --control-seeds 7 8 9 [--seconds 2] [--out FILE]

Prints one JSON line per run: who ran it, the seed, the readings, what
was compared and how long the check took.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ifebench import harness
from ifebench.control import CONTROLS


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m ifebench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    kind = cell.module("entries", cell.spec["entry"]).CHECK_OUTPUT
    jobs = ([("program", s, None) for s in args.seeds]
            + [("control", s, CONTROLS[kind]) for s in args.control_seeds])
    for who, seed, entry_class in jobs:
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, 0, t,
                             entry_class=entry_class,
                             warm=entry_class is None)
        line = json.dumps({"cell": args.workload, "who": who, "seed": seed,
                           "correct": r["correct"], "attempted": r["attempted"],
                           "checks": r["checks"], "metrics": r["metrics"],
                           "device": r["device"],
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
