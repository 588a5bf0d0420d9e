"""The two cells whose entries pick their own ROIs, at a small size on the
CPU: mil-bag-4s.dense-rois (make_bag_device on the pool's tensors, ROIs
tiling the lungs) and mil-bag-dense-4s.right-lung (make_bag_dense_device,
an ROI at every voxel of one lung). Their last lines, their controls read
not correct, the dense check catches planted faults, and the dense
binning's two metrics read nothing where there is nothing to read."""
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ifebench import harness
from ifebench.checks.bag_dense import dense_starts
from ifebench.control_dense import CONTROLS
from ifebench.harness import load_module
from ifebench.trace import Trace
from ife_tpu_torch.roi.bag import make_bag_dense_device
from ife_tpu_torch.roi.generate import generate_dense_rois
from ife_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "ifebench" / "metrics"
SMALL = dict(shape=(48, 48, 40), roi_size=(9, 9, 9), n_rois=4, pool=2)
DENSE = "mil-bag-dense-4s.right-lung"
TILING = "mil-bag-4s.dense-rois"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MS = load_module(METRICS / "dense_hist_ms_per_scan.py", "metrics")
ROOF = load_module(METRICS / "dense_hist_roofline_pct.py", "metrics")


def run_small(cell, trace=0, entry_class=None, seed=2**31 + 77):
    return harness.run_cell(cell, seed, 0.3, trace, time.perf_counter(),
                            device="cpu", overrides=SMALL,
                            entry_class=entry_class,
                            warm=entry_class is None or trace,
                            log=lambda msg: None)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [TILING, DENSE])
def test_the_cells_run_correct_with_their_metrics(cell, trace):
    r = run_small(cell, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    units = {m["name"]: m["unit"]
             for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    if trace:
        # the CPU's trace holds no device record: the device metrics stay out
        assert r["metrics"] == {} and set(r["breakdown"]) == {
            "device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"bags_per_s", "bag_ms_p95", "setup_s"}
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name]
    spec = json.loads((ROOT / "ifebench/workloads" / f"{cell}.json")
                      .read_text())
    assert set(r["checks"]) == set(spec["check"]["limits"])


def test_the_tiling_holds_the_grid_points_in_the_mask_whose_box_fits():
    tiling = harness.load_cell(TILING).module("entries",
                                              "make_bag_resident").tiling
    mask = torch.zeros((30, 28, 26), dtype=torch.uint8)
    mask[3:25, 5:20, 2:24] = 1
    mask[12, 13, 14] = 0                   # a grid point left out
    got = tiling(mask, (9, 9, 9))
    centres = [(x, y, z) for z in range(2, 24, 4) for y in range(5, 20, 4)
               for x in range(3, 25, 4)
               if mask[x, y, z] and all(4 <= c <= n - 5 for c, n in
                                        zip((x, y, z), mask.shape))]
    assert got.tolist() == [[x - 4, y - 4, z - 4] for x, y, z in centres]


def test_the_dense_starts_are_generate_dense_rois():
    rng = np.random.default_rng(3)
    mask = (rng.random((20, 18, 16)) < 0.2).astype(np.uint8)
    want = [list(r.index) for r in generate_dense_rois(mask, (5, 7, 3))]
    assert dense_starts(torch.from_numpy(mask), (5, 7, 3)).tolist() == want


@pytest.mark.parametrize("cell", [TILING, DENSE])
def test_the_control_is_not_correct(cell):
    entry = harness.load_cell(cell).spec["entry"]
    r = run_small(cell, entry_class=CONTROLS[entry], seed=2**31 + 5)
    assert r["correct"] is False
    assert r["checks"]["bag_moved"]["value"] > r["checks"]["bag_moved"]["limit"]


def _dense_entry(fault):
    base = harness.load_cell(DENSE).module("entries", "make_bag_dense")

    class Faulty(base.Entry):
        def scan(self, slot, keep):
            image, mask = self.run.scan_tensors(slot)
            sigmas, size = self.run.sigmas, self.size
            if fault == "scale":
                sigmas = sigmas[:-1]
            if fault == "short":
                size = size[:2] + (size[2] - 1,)
            starts, rows = make_bag_dense_device(
                image, mask, sigmas, self.run.edges[:8 * len(sigmas)], size,
                tuple(self.run.spacing), device=self.run.device)
            if fault == "scale":
                rows = torch.cat([rows, torch.zeros_like(rows[:, :rows.shape[1]
                                                              // len(sigmas)])],
                                 dim=1)
            n = int(starts.shape[0])
            sel = base.sample_rows(self.run.seed, slot, n)
            at = torch.from_numpy((sel + 1) % n if fault == "shifted" else sel)
            return n, sel, starts[torch.from_numpy(sel)].numpy(), rows[at].numpy()
    return Faulty


@pytest.mark.parametrize("fault", ["shifted", "scale", "short"])
def test_a_broken_dense_bag_is_not_correct(fault):
    r = run_small(DENSE, entry_class=_dense_entry(fault))
    assert r["correct"] is False and r["failed"] > 0


# ---------------------------------------------------------------------------
# the two metrics of the dense binning
# ---------------------------------------------------------------------------

class _Event:
    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _trace(n_scans, kernels=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "ifebench.scan",
           "ts": 0, "dur": 10_000}]
    ev += [{"ph": "X", "cat": "kernel", "name": name, "ts": 10, "dur": dur}
           for name, dur in kernels]
    return Trace(ev, n_scans)


@pytest.fixture
def store(monkeypatch):
    m = profiling.StageMetrics()
    monkeypatch.setattr(profiling, "_global_metrics", m)
    return m


def _span(store, name, device_ms):
    i = store.open(name, work=5, events=(_Event(0.0), _Event(device_ms)))
    store.close(i)


def test_dense_hist_ms_per_scan_sums_the_binning_spans(store):
    ctx = SimpleNamespace(trace=_trace(2, [("k", 100)]))
    assert MS.read(ctx) is None
    _span(store, "bag.bin", 3.0)
    assert MS.read(ctx) is None
    for ms in (1.5, 2.5, 4.0):
        _span(store, "bag.dense.bin", ms)
    assert MS.read(ctx) == pytest.approx(4.0)
    assert MS.read(SimpleNamespace(trace=None)) is None
    assert MS.read(SimpleNamespace(trace=_trace(2))) is None


def _roof_ctx(trace, mask):
    run = SimpleNamespace(roi_size=(3, 3, 3), sigmas=(0.6, 1.2), bins=4,
                          scan_tensors=lambda slot: (None, mask))
    return SimpleNamespace(trace=trace, run=run, traced_slots=[0, 0])


def test_dense_hist_roofline_pct_reads_the_dense_kernels_only():
    mask = torch.zeros((10, 9, 8), dtype=torch.uint8)
    mask[2:6, 3:5, 1:7] = 1
    mask[0, 0, 0] = 1                      # its box does not fit
    n, region = ROOF.dense_work(mask, (3, 3, 3))
    assert n == 4 * 2 * 6 and region == 6 * 4 * 8
    floor = ROOF.floor_ms(n, region, 4)
    assert floor == pytest.approx(
        (region * 33 + n * 8 * 4 * 4) / 3.35e12 * 1e3)
    mask_only = _roof_ctx(_trace(2, [("histogram_kernel", 50)]), mask)
    assert ROOF.read(mask_only) is None
    assert ROOF.read(_roof_ctx(None, mask)) is None
    assert ROOF.read(_roof_ctx(_trace(2), mask)) is None
    ctx = _roof_ctx(_trace(2, [("void dense_hist_rows_kernel(...)", 30),
                               ("void dense_hist_bins_kernel(...)", 10),
                               ("other", 500)]), mask)
    assert ROOF.read(ctx) == pytest.approx(
        100.0 * 2 * 2 * floor * 1e-3 / 40e-6)
