"""The controls of the two cells whose entries pick their own ROIs
(entries/make_bag_resident.py's tiling, entries/make_bag_dense.py's dense
grid): the reference in the program's place one precision below the
configuration's float32 (the Gaussian FIR products in TF32, as
control.py's), over the entry's own ROIs. A run with either has to come out
not correct.

    python3 -m ifebench.control_dense --workload <cell> --seeds 1 2 ...
        --control-seeds 7 8 ... [--seconds 2] [--out FILE]

runs the program on `--seeds` and the control on `--control-seeds`, each
at the cell's own size through the harness's window and check, and prints
calibrate.py's line for each run."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from ifebench import harness
from ifebench.checks.bag_dense import dense_starts, reference_rows
from ifebench.control import BagControl


def _entry_module(run):
    return run.cell.module("entries", run.cell.spec["entry"])


class BagTilingControl(BagControl):
    """make_bag_resident's place: its tiling, the bag of float32 TF32
    features."""

    def __init__(self, run):
        super().__init__(run)
        size = tuple(int(s) for s in run.roi_size)
        tiling = _entry_module(run).tiling
        for slot in range(run.pool_size):
            run.rois[slot] = tiling(run.scan_tensors(slot)[1], size)


class BagDenseControl:
    """make_bag_dense's place: the mask's x >= X / 2 half cleared, the
    benchmark's own dense starts, and the sampled rows of float32 TF32
    features."""

    def __init__(self, run):
        self.run = run
        self.sample_rows = _entry_module(run).sample_rows
        for slot in range(run.pool_size):
            mask = run.scan_tensors(slot)[1]
            mask[mask.shape[0] // 2:] = 0

    def scan(self, slot, keep):
        starts = dense_starts(self.run.scan_tensors(slot)[1],
                              self.run.roi_size)
        sel = self.sample_rows(self.run.seed, slot, len(starts))
        rows = reference_rows(self.run, slot, starts[sel], torch.float32,
                              tf32=True)
        return len(starts), sel, starts[sel], rows


CONTROLS = {"make_bag_resident": BagTilingControl,
            "make_bag_dense": BagDenseControl}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m ifebench.control_dense")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    control = CONTROLS[harness.load_cell(args.workload).spec["entry"]]
    jobs = ([("program", s, None) for s in args.seeds]
            + [("control", s, control) for s in args.control_seeds])
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
