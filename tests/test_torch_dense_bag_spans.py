"""The spans of roi/bag.py:make_bag_dense_device on the CPU: "bag.dense"
over the inputs' staging, "bag.dense.index" and, a scale at a time, the
feature pass's spans and "bag.dense.bin", each counting the ROIs.

This file imports neither JAX nor ife_tpu."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ife_tpu_torch.roi.bag import make_bag_dense_device
from ife_tpu_torch.roi.generate import generate_dense_rois
from ife_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

SHAPE = (18, 16, 14)
SIZE = (5, 5, 5)


@pytest.fixture
def store(monkeypatch):
    """A fresh store in the place of the process's."""
    m = P.StageMetrics()
    monkeypatch.setattr(P, "_global_metrics", m)
    return m


def _scan():
    rng = np.random.default_rng(2)
    img = (rng.standard_normal(SHAPE) * 100.0 - 800.0).astype(np.float32)
    mask = np.zeros(SHAPE, np.uint8)
    mask[4:13, 3:12, 2:11] = 1
    mask[6, 7, 5] = 0
    return img, mask


@pytest.mark.parametrize("sigmas", [(0.7,), (0.7, 1.5)])
def test_make_bag_dense_device_records_its_span_tree(store, sigmas):
    img, mask = _scan()
    edges = [np.linspace(-900.0, -700.0, 5) for _ in range(8 * len(sigmas))]
    n = len(generate_dense_rois(mask, SIZE))
    want = make_bag_dense_device(img, mask, sigmas, edges, SIZE, device="cpu")
    assert store.records == []
    with profile(activities=[ProfilerActivity.CPU]):
        got = make_bag_dense_device(img, mask, sigmas, edges, SIZE,
                                    device="cpu")
    assert got[1].numpy().tobytes() == want[1].numpy().tobytes()

    recs = store.records
    parent = {r.index: (recs[r.parent].name if r.parent is not None else None)
              for r in recs}
    assert recs[0].name == "bag.dense" and parent[0] is None
    assert recs[0].work == n > 0
    assert all(r.request == 0 for r in recs)
    assert [(r.name, parent[r.index]) for r in recs[1:5]] == [
        ("bag.stage", "bag.dense"), ("bag.stage.h2d", "bag.stage"),
        ("bag.stage.pinned", "bag.stage.h2d"),
        ("bag.dense.index", "bag.dense")]
    assert recs[4].work == n
    bins = [r for r in recs if r.name == "bag.dense.bin"]
    assert len(bins) == len(sigmas)
    assert all(parent[r.index] == "bag.dense" and r.work == n for r in bins)
    # the feature pass's spans (the kernel dispatcher's, on the card) run
    # inside the call
    assert all(parent[r.index] in ("bag.dense", "features.sweep",
                                   "features.xs_stream", "features.nc_post")
               for r in recs if r.name.startswith("features."))
    assert {r.name for r in recs} <= {
        "bag.dense", "bag.stage", "bag.stage.h2d", "bag.stage.pinned",
        "bag.dense.index", "bag.dense.bin", "features.sweep",
        "features.xs_stream", "features.nc_post", "features.mask"}


def test_a_dense_bag_of_no_roi_records_no_binning(store):
    img, _ = _scan()
    mask = np.zeros(SHAPE, np.uint8)
    edges = [np.linspace(-900.0, -700.0, 5) for _ in range(8)]
    with profile(activities=[ProfilerActivity.CPU]):
        starts, rows = make_bag_dense_device(img, mask, (0.7,), edges, SIZE,
                                             device="cpu")
    assert starts.shape == (0, 3) and rows.shape == (0, 8 * 6)
    assert [(r.name, r.work) for r in store.records
            if r.name.startswith("bag.dense")] == [("bag.dense", 0),
                                                   ("bag.dense.index", 0)]
