"""roi/bag.py:make_bag_device builds its bag on the device and fetches it
once: the same bag to the bit as a per-scale, per-class assembly on the
host (the form the bag had before it stayed on the device), for interleaved
size classes and for one class over every ROI; an ROI with no masked voxel
keeps its NaN row; no ROIs give no rows; bad edges raise before any feature
pass; one "bag.fetch" span a call. On the card (marker gpu) a call on a
scan already there synchronises with the host once, at its fetch.

This file imports neither JAX nor ife_tpu; on the card run its card cases
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_bag_device.py -q
"""
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ife_tpu_torch.ops.features import NUM_FEATURES, features8_auto_channels
from ife_tpu_torch.roi import bag as B
from ife_tpu_torch.roi.generate import ROI
from ife_tpu_torch.utils import profiling as P

SHAPE = (24, 22, 20)
SPACING = (0.78, 0.78, 1.0)
SIGMAS = (0.8, 1.6)
A, Bs, C = (5, 5, 5), (4, 6, 3), (7, 3, 5)

# sizes A, B, A, C, B, ...: three classes, interleaved
MIXED = [ROI((2, 3, 4), A), ROI((10, 8, 6), Bs), ROI((12, 12, 12), A),
         ROI((0, 0, 0), C), ROI((15, 14, 16), Bs), ROI((6, 9, 2), C),
         ROI((18, 2, 14), A)]
ONE_CLASS = [ROI((2, 3, 4), A), ROI((12, 12, 12), A), ROI((7, 1, 9), A),
             ROI((18, 2, 14), A)]


def _scan():
    rng = np.random.default_rng(25)
    img = (rng.standard_normal(SHAPE) * 100.0 - 850.0).astype(np.float32)
    # labels of 2 over most of the volume; the corner block
    # [16:, 14:, 12:) holds no masked voxel
    mask = (rng.random(SHAPE) > 0.3).astype(np.uint8) * 2
    mask[16:, 14:, 12:] = 0
    return img, mask


def _edges(bins=6, seed=5):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.normal(-600.0 if k % NUM_FEATURES == 0 else 0.0,
                               200.0 if k % NUM_FEATURES == 0 else 50.0,
                               bins - 1))
            for k in range(NUM_FEATURES * len(SIGMAS))]


def _assembled_on_the_host(img, mask, edges, rois, device="cpu"):
    """The bag assembled as make_bag_device assembled it before it kept the
    bag on the device: per scale and size class the frequencies fetched and
    written into an f64 host bag, row by row of the class."""
    dev = torch.device(device)
    hist_size = B._check_hist_spec(edges, NUM_FEATURES * len(SIGMAS))
    x, m = B._scan_inputs(img, mask, torch.float32, dev)
    starts = np.asarray([r.index for r in rois], np.int64).reshape(-1, 3)
    bag = np.zeros((len(rois), hist_size * NUM_FEATURES * len(SIGMAS)))
    for sigma, e, cols in B._scales(SIGMAS, edges, hist_size):
        feats = features8_auto_channels(x, m, sigma, SPACING)
        for size, idxs in B._size_classes(rois):
            freqs = B.roi_feature_histograms_device(feats, m, starts[idxs],
                                                    e, size)
            bag[idxs, cols] = (freqs.cpu().numpy().astype(np.float64)
                               .reshape(len(idxs), -1))
    return bag


@pytest.fixture
def store(monkeypatch):
    """A fresh span store in the place of the process's."""
    m = P.StageMetrics()
    monkeypatch.setattr(P, "_global_metrics", m)
    return m


@pytest.mark.parametrize("rois", [MIXED, ONE_CLASS],
                         ids=["interleaved_classes", "one_class"])
def test_the_device_bag_is_the_host_assembly_to_the_bit(rois):
    img, mask = _scan()
    edges = _edges()
    got = B.make_bag_device(img, mask, SIGMAS, edges, rois, SPACING,
                            device="cpu")
    want = _assembled_on_the_host(img, mask, edges, rois)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and from the scan as tensors on the device
    np.testing.assert_array_equal(B.make_bag_device(
        torch.from_numpy(img), torch.from_numpy(mask), SIGMAS, edges, rois,
        SPACING, device="cpu"), want)


def test_an_roi_without_masked_voxels_keeps_its_nan_row():
    img, mask = _scan()
    edges = _edges()
    rois = MIXED + [ROI((17, 15, 13), A), ROI((16, 14, 12), Bs)]
    got = B.make_bag_device(img, mask, SIGMAS, edges, rois, SPACING,
                            device="cpu")
    assert np.isnan(got[-2:]).all()
    assert not np.isnan(got[:-2]).any()
    np.testing.assert_array_equal(
        got, _assembled_on_the_host(img, mask, edges, rois))


def test_no_rois_give_no_rows():
    img, mask = _scan()
    edges = _edges(bins=4)
    got = B.make_bag_device(img, mask, SIGMAS, edges, [], SPACING,
                            device="cpu")
    assert got.shape == (0, 4 * NUM_FEATURES * len(SIGMAS))
    assert got.dtype == np.float64


@pytest.mark.parametrize("edges, match", [
    ([np.array([0.0])] * 7, "Number of histograms"),
    ([np.array([0.0])] * 15 + [np.array([0.0, 1.0])], "same bin count"),
], ids=["count", "bins"])
def test_bad_edges_raise_before_any_feature_pass(monkeypatch, edges, match):
    img, mask = _scan()
    passes = []
    monkeypatch.setattr(B, "features8_auto_channels",
                        lambda *a, **k: passes.append(a))
    monkeypatch.setattr(B, "_scan_inputs", lambda *a, **k: passes.append(a))
    with pytest.raises(ValueError, match=match):
        B.make_bag_device(img, mask, SIGMAS, edges, MIXED, SPACING,
                          device="cpu")
    assert passes == []


@pytest.mark.parametrize("rois", [MIXED, ONE_CLASS],
                         ids=["interleaved_classes", "one_class"])
def test_one_fetch_a_call(store, rois):
    img, mask = _scan()
    edges = _edges()
    with profile(activities=[ProfilerActivity.CPU]):
        B.make_bag_device(img, mask, SIGMAS, edges, rois, SPACING,
                          device="cpu")
    names = [r.name for r in store.records]
    classes = len(B._size_classes(rois))
    assert names.count("bag") == 1
    assert names.count("bag.bin") == len(SIGMAS) * classes
    assert names[-1] == "bag.fetch" and names.count("bag.fetch") == 1
    assert store.records[-1].work == len(rois)


def test_a_bool_mask_is_taken_as_the_weights():
    img, mask = _scan()
    x = torch.from_numpy(img)
    feats = features8_auto_channels(x, torch.from_numpy(mask), 0.8, SPACING)
    starts = np.asarray([r.index for r in ONE_CLASS], np.int64)
    e = np.stack(_edges()[:NUM_FEATURES])
    labels = B.roi_feature_histograms_device(feats, torch.from_numpy(mask),
                                             starts, e, A)
    weights = B.roi_feature_histograms_device(
        feats, torch.from_numpy(mask != 0), starts, e, A)
    assert torch.equal(labels, weights)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `python -m "
                    "pytest --noconftest -m gpu tests/test_torch_bag_device.py`")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("rois", [MIXED, ONE_CLASS, []],
                         ids=["interleaved_classes", "one_class", "no_rois"])
def test_a_resident_scan_waits_for_the_card_once(cuda, rois):
    img, mask = _scan()
    edges = _edges()
    x, m = torch.from_numpy(img).to(cuda), torch.from_numpy(mask).to(cuda)
    want = _assembled_on_the_host(img, mask, edges, rois, cuda)
    # the first call builds the kernels and fills the allocators' caches
    B.make_bag_device(x, m, SIGMAS, edges, rois, SPACING, device=cuda)
    torch.cuda.synchronize(cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = B.make_bag_device(x, m, SIGMAS, edges, rois, SPACING,
                                    device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, syncs
    np.testing.assert_array_equal(got, want)
