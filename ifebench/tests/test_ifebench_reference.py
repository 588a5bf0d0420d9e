"""The reference against the port's plain composed ops, its blocks against
its whole volume, and its bag rows against the port's host bag."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ifebench import inputs, reference
from ifebench.tests.test_ifebench_inputs import scan_cfg

from ife_tpu_torch.ops.features import features8
from ife_tpu_torch.roi.bag import make_bag
from ife_tpu_torch.roi.generate import ROI

SPACING = (0.78, 0.78, 1.0)
SHAPE = (40, 36, 30)


@pytest.fixture(scope="module")
def scan():
    return inputs.make_scan(scan_cfg(), "lung", 11, 0, 4, "cpu", SHAPE)


@pytest.mark.parametrize("sigma", [0.6, 1.2, 2.4, 4.8])
def test_reference_is_the_plain_composed_ops_in_f64(scan, sigma):
    image, mask = scan
    ref = reference.features(image, mask, sigma, SPACING)
    ops = features8(image.double(), mask, sigma, SPACING).permute(3, 0, 1, 2)
    # the same functions; the FIR sums associate otherwise (the port adds
    # each pair of taps first), which the eigen solve magnifies near ties
    for k in range(8):
        scale = max(float(ops[k].abs().max()), 1.0)
        assert float((ref[k] - ops[k]).abs().max()) <= 1e-9 * scale, k


@pytest.mark.parametrize("sigma", [0.6, 4.8])
def test_blocks_equal_the_whole_volume(scan, sigma):
    image, mask = scan
    whole = reference.features(image, mask, sigma, SPACING)
    assert torch.equal(reference.features_region(image, mask, sigma, SPACING,
                                                 slab=7), whole)
    lo, hi = (3, 5, 2), (31, 30, 29)
    box = reference.features_region(image, mask, sigma, SPACING, lo=lo, hi=hi,
                                    slab=11)
    assert torch.equal(box, whole[:, 3:31, 5:30, 2:29])


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -(1.0 + 3 * 2**-12), 3.14159265], dtype=torch.float32)
    got = reference.tf32_round(x)
    assert got.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0]
    assert got[4].item() == -(1.0 + 2**-10)
    assert abs(got[5].item() - 3.14159265) <= 2**-11 * 4


def test_bag_rows_are_the_ports_host_bag_in_f64(scan):
    image, mask = scan
    sigmas = (0.6, 2.4)
    rng = np.random.default_rng(3)
    edges = [np.sort(rng.normal(-850 if k % 8 == 0 else 0, 30, 15))
             for k in range(8 * len(sigmas))]
    starts = inputs.draw_rois(mask.numpy(), 6, (9, 9, 9), 11, 0)
    rois = [ROI(tuple(int(v) for v in s), (9, 9, 9)) for s in starts]
    port = make_bag(image.numpy(), mask.numpy(), sigmas, edges, rois, SPACING,
                    dtype=torch.float64, device="cpu")
    lo, hi = reference.roi_region(starts, (9, 9, 9), SHAPE)
    region = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    rows = []
    for i, s in enumerate(sigmas):
        feats = reference.features_region(image, mask, s, SPACING, lo=lo, hi=hi)
        rows.append(reference.bag_rows(feats, mask[region], lo, starts,
                                       (9, 9, 9), np.stack(edges[8 * i:8 * i + 8])))
    assert np.array_equal(np.concatenate(rows, axis=1), port)


def _imported_top_names(path: Path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    pkg = Path(__file__).resolve().parent.parent
    banned = {"jax", "jaxlib", "flax", "ife_tpu", "bench", "bench_torch",
              "chip_smoke", "benchmarks"}
    for path in pkg.rglob("*.py"):
        assert not _imported_top_names(path) & banned, path
    for name in ("reference.py", "checks/features8.py", "checks/bag.py",
                 "control.py", "inputs.py"):
        assert "ife_tpu_torch" not in _imported_top_names(pkg / name), name
