"""The checks fail what they must: the control (the reference in TF32 in
the program's place) and the faults of a broken timed path each come out
not correct, at a small size on the CPU, through the harness's own run."""
import time

import numpy as np
import pytest
import torch

from ifebench import harness
from ifebench.control import CONTROLS

from ife_tpu_torch.roi.bag import make_bag_device
from ife_tpu_torch.roi.generate import ROI

SMALL = dict(shape=(48, 48, 40), roi_size=(9, 9, 9), n_rois=4, pool=2)
FEATURE_CELLS = ("ct-features-4s.lung", "ct-features-4s.full")


def run_small(cell, entry_class=None, seed=2**31 + 5):
    return harness.run_cell(cell, seed, 0.3, 0, time.perf_counter(),
                            device="cpu", overrides=SMALL,
                            entry_class=entry_class, log=lambda msg: None)


@pytest.mark.parametrize("cell", FEATURE_CELLS + ("mil-bag-4s.lung",))
def test_the_control_is_not_correct(cell):
    kind = "bag" if cell.startswith("mil-bag") else "features8"
    r = run_small(cell, CONTROLS[kind])
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _features_entry(fault):
    base = harness.load_cell("ct-features-4s.lung").module(
        "entries", "features8_scan").Entry

    class Faulty(base):
        def scan(self, slot, keep):
            out = super().scan(slot, True)
            image, _ = self.run.scan_tensors(slot)
            if fault == "unchanged":
                out = [tuple(image.clone() for _ in range(8)) for _ in out]
            elif fault == "half":
                z = image.shape[2] // 2
                out = [tuple(torch.cat([c[..., :z], torch.zeros_like(c[..., z:])],
                                       dim=-1) for c in scale) for scale in out]
            elif fault == "altered":
                c = out[2][3].clone()
                c.view(-1)[c.numel() // 2] += c.abs().max()
                out[2] = out[2][:3] + (c,) + out[2][4:]
            return out if keep else None
    return Faulty


def _bag_entry(fault):
    base = harness.load_cell("mil-bag-4s.lung").module(
        "entries", "make_bag_device").Entry

    class Faulty(base):
        def scan(self, slot, keep):
            bag = super().scan(slot, keep)
            if fault == "unchanged":
                return np.zeros_like(bag)
            if fault == "half":
                # half of each box's voxels binned, the frequencies over them
                image, mask = self.run.host_pool[slot]
                sx, sy, sz = self.run.roi_size
                rois = [ROI(r.index, (sx, sy, sz // 2)) for r in self.rois[slot]]
                return make_bag_device(image, mask, self.run.sigmas,
                                       self.run.edges, rois, self.run.spacing,
                                       device=self.run.device)
            bag = bag.copy()
            bag[1, 5] += 0.25
            bag[1, 6] -= 0.25
            return bag
    return Faulty


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", FEATURE_CELLS)
def test_a_broken_feature_pass_is_not_correct(cell, fault):
    r = run_small(cell, _features_entry(fault))
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_bag_is_not_correct(fault):
    r = run_small("mil-bag-4s.lung", _bag_entry(fault))
    assert r["correct"] is False and r["failed"] > 0
