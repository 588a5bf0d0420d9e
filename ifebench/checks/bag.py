"""Check of bag rows: every bag returned in the window against the bag the
float64 reference gives for its scan, the same ROIs and edges.

One number, bag_moved: the worst over every bag, ROI and histogram (scale,
feature) of half the L1 distance between the two rows of frequencies, the
share of the ROI's masked voxels that a bin lost to others. A voxel whose
feature lies within rounding of an edge may bin either way; a wrong
feature, ROI, scale or edge moves whole bins. A NaN reads as inf.
"""
from __future__ import annotations

import numpy as np

from ifebench import reference

NAMES = ("bag_moved",)


def reference_bag(run, slot, dtype=None, tf32=False):
    """(n_rois, bins * 8 * n_scales) f64 rows of the reference for a slot,
    from the box that holds all its ROIs (features in float64, or in
    `dtype` with tf32 for the control)."""
    import torch
    dtype = dtype or torch.float64
    image, mask = run.scan_tensors(slot)
    starts = run.rois[slot]
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


def moved(got, ref, bins):
    """Worst half-L1 distance between rows of `bins` frequencies."""
    d = np.abs(np.asarray(got, np.float64) - ref).reshape(
        ref.shape[0], -1, bins).sum(axis=-1) * 0.5
    return float(np.nan_to_num(d, nan=np.inf).max())


def check(run, held, limits):
    """(readings, compared, failed) over every bag of the window."""
    refs = {}
    worst = 0.0
    failed = 0
    for _, slot, bag in held:
        if slot not in refs:
            refs[slot] = reference_bag(run, slot)
        m = moved(bag, refs[slot], run.bins)
        failed += not m <= limits["bag_moved"]
        worst = max(worst, m)
    return {"bag_moved": worst}, len(held), failed
