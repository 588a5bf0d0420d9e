"""The benchmark's inputs: seeded scans, lung masks, ROIs and edges."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ifebench import inputs

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SHAPE = (64, 64, 50)


def scan_cfg(name="ct-features-4s"):
    return json.loads((CONFIGS / f"{name}.json").read_text())["scan"]


def test_same_seed_same_scan_other_seed_other_scan():
    a = inputs.make_scan(scan_cfg(), "lung", 2**31 + 7, 1, 4, "cpu", SHAPE)
    b = inputs.make_scan(scan_cfg(), "lung", 2**31 + 7, 1, 4, "cpu", SHAPE)
    c = inputs.make_scan(scan_cfg(), "lung", 2**31 + 8, 1, 4, "cpu", SHAPE)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.float32 and a[1].dtype == torch.uint8
    assert a[0].shape == SHAPE and a[0].is_contiguous()


def test_lung_mask_fills_about_a_tenth_and_ones_fill_all():
    fills = [float(inputs.make_scan(scan_cfg(), "lung", 3, s, 4, "cpu",
                                    SHAPE)[1].double().mean())
             for s in range(4)]
    assert all(0.08 <= f <= 0.11 for f in fills), fills
    # every seed holds the same set of lung sizes, in another order
    other = [float(inputs.make_scan(scan_cfg(), "lung", 4, s, 4, "cpu",
                                    SHAPE)[1].double().mean())
             for s in range(4)]
    assert abs(np.mean(fills) - np.mean(other)) < 0.1 * np.mean(fills)
    ones = inputs.make_scan(scan_cfg(), "ones", 3, 0, 4, "cpu", SHAPE)[1]
    assert bool((ones == 1).all())


def test_intensities_are_chest_ct_like():
    image, mask = inputs.make_scan(scan_cfg(), "lung", 5, 0, 4, "cpu", SHAPE)
    lung = image[mask != 0]
    assert -900 < float(lung.mean()) < -850
    assert float(image[0, 0, :].mean()) < -950          # air at the corner
    assert float(image[SHAPE[0] // 2, SHAPE[1] // 4, :].mean()) > -100  # body


def test_rois_are_centred_in_the_mask_inside_the_volume_and_seeded():
    _, mask = inputs.make_scan(scan_cfg(), "lung", 5, 0, 4, "cpu", SHAPE)
    m = mask.numpy()
    size = (9, 9, 9)
    a = inputs.draw_rois(m, 20, size, 5, 0)
    assert np.array_equal(a, inputs.draw_rois(m, 20, size, 5, 0))
    assert not np.array_equal(a, inputs.draw_rois(m, 20, size, 6, 0))
    assert a.shape == (20, 3)
    assert (a >= 0).all() and (a + size <= np.asarray(SHAPE)).all()
    c = a + np.asarray(size) // 2
    assert (m[c[:, 0], c[:, 1], c[:, 2]] != 0).all()


def test_rois_refuse_an_empty_mask():
    with pytest.raises(ValueError):
        inputs.draw_rois(np.zeros((20, 20, 20), np.uint8), 3, (5, 5, 5), 1, 0)


def test_the_configured_edges_load():
    cfg = json.loads((CONFIGS / "mil-bag-4s.json").read_text())
    edges = inputs.load_edges(CONFIGS / cfg["bag"]["edges"],
                              8 * len(cfg["sigmas"]), cfg["bag"]["bins"])
    assert len(edges) == 32 and all(e.shape == (31,) for e in edges)
    assert all((np.diff(e) > 0).all() for e in edges)
