"""Expected signed distance from region centers to interest points (a copy
of ife_tpu/stats/distance.py; scipy is imported at the top, as there, so a
host without scipy fails on import).

Reference: include/ife/Statistics/ExpectedDistanceFromCenterToInterestPoint.h
:11-43 — signed Maurer distance map of the object mask (inside positive,
physical spacing) multiplied by a probability image, averaged over mask
voxels.

Implementation: Euclidean distance transforms via scipy (exact Felzenszwalb
EDT), signed = +EDT(distance to background) inside, -EDT(distance to
foreground) outside. This matches ITK SignedMaurerDistanceMapImageFilter
with InsideIsPositive(true) up to the voxel-center boundary convention.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def signed_distance_map(mask: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Signed Euclidean distance, positive inside the mask."""
    m = np.asarray(mask) != 0
    sampling = tuple(float(s) for s in spacing)
    inside = ndimage.distance_transform_edt(m, sampling=sampling)
    outside = ndimage.distance_transform_edt(~m, sampling=sampling)
    return inside - outside


def expected_distance_from_center_to_interest_point(
    object_mask: np.ndarray,
    prob_image: np.ndarray,
    spacing=(1.0, 1.0, 1.0),
) -> float:
    """Mean over mask voxels of signed_distance * probability.

    Returns 0 for an empty mask (reference :41).
    """
    m = np.asarray(object_mask) != 0
    if not m.any():
        return 0.0
    sd = signed_distance_map(m, spacing)
    prod = sd * np.asarray(prob_image, dtype=np.float64)
    return float(prod[m].sum() / m.sum())
