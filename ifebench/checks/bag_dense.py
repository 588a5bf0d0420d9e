"""Check of dense bag rows: for every kept scan, the program's number of
ROIs and its sampled starts against the benchmark's own dense centres of
the scan's mask, and its sampled rows against the float64 reference's rows
of those ROIs.

Two numbers: starts_wrong, the worst over the kept scans of the ROI count's
difference (0 or 1) plus the sampled starts that differ from the
benchmark's at the same index; bag_moved, as in checks/bag.py, the worst
half-L1 distance between a sampled row and the reference's, over every
(scale, feature) histogram. A NaN reads as inf.

The dense centres (`dense_starts`) are computed here from the mask alone:
every voxel where it is nonzero whose box of the configuration's size,
start = centre - size // 2, lies inside the volume, ordered z, then y, then
x fastest (MakeBagDense's DenseROIGenerator, an ITK region iterator)."""
from __future__ import annotations

import numpy as np
import torch

from ifebench import reference
from ifebench.checks.bag import moved

NAMES = ("bag_moved", "starts_wrong")


def dense_starts(mask: torch.Tensor, size) -> np.ndarray:
    """(N, 3) int64 starts of the dense centres of `mask`, in order."""
    size = [int(s) for s in size]
    shape = list(mask.shape)
    if any(n < s for n, s in zip(shape, size)):
        return np.zeros((0, 3), np.int64)
    inside = tuple(slice(s // 2, n - s + s // 2 + 1)
                   for n, s in zip(shape, size))
    zyx = (mask[inside] != 0).permute(2, 1, 0).nonzero().cpu().numpy()
    return np.ascontiguousarray(zyx[:, ::-1]).astype(np.int64)


def reference_rows(run, slot, starts, dtype=None, tf32=False):
    """(len(starts), bins * 8 * n_scales) f64 rows of the reference for the
    boxes at `starts` of a slot's scan (features in float64, or in `dtype`
    with tf32 for the control)."""
    dtype = dtype or torch.float64
    image, mask = run.scan_tensors(slot)
    lo, hi = reference.roi_region(starts, run.roi_size, image.shape)
    region = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    per_scale = []
    for i, sigma in enumerate(run.sigmas):
        feats = reference.features_region(image, mask, sigma, run.spacing,
                                          run.truncate, lo, hi, dtype, tf32)
        edges = np.stack(run.edges[i * reference.N_FEATURES:
                                   (i + 1) * reference.N_FEATURES])
        per_scale.append(reference.bag_rows(feats, mask[region], lo, starts,
                                            run.roi_size, edges))
        del feats
    return np.concatenate(per_scale, axis=1)


def check(run, held, limits):
    """(readings, compared, failed) over every kept scan."""
    refs = {}
    worst_moved, worst_wrong, failed = 0.0, 0, 0
    for _, slot, (n, sel, starts, rows) in held:
        if slot not in refs:
            refs[slot] = dense_starts(run.scan_tensors(slot)[1], run.roi_size)
        want = refs[slot]
        sel = np.asarray(sel, np.int64)
        known = sel < len(want)
        wrong = int(n != len(want)) + int((~known).sum()) + int(
            (np.asarray(starts)[known] != want[sel[known]]).any(axis=1).sum())
        m = moved(rows, reference_rows(run, slot, want[sel[known]]), run.bins) \
            if known.all() and len(sel) else float("inf")
        failed += not (wrong <= limits["starts_wrong"]
                       and m <= limits["bag_moved"])
        worst_moved = max(worst_moved, m)
        worst_wrong = max(worst_wrong, wrong)
    return ({"bag_moved": worst_moved, "starts_wrong": worst_wrong},
            len(held), failed)
