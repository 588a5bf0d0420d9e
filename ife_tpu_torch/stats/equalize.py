"""Equal-frequency ("equalized") histogram edge determination (a copy of
ife_tpu/stats/equalize.py, host numpy code).

Exact algorithm re-derived from the reference
(include/ife/Statistics/DetermineEdgesForEqualizedHistogram.h:23-139):
from a SORTED sample array, produce nBins-1 edges splitting the samples
into (as close as possible) equal-count bins, with a surplus/deficit
balance carried across bins and a nearest-of-lower/upper-bound rule for
runs of duplicate values.

The exact path is inherently sequential over bins and runs on host
(nBins is small); for sharded multi-host statistics the scalable path
`edges_from_dense_counts` derives approximate equalized edges from an
all-reduced dense pre-histogram (SURVEY.md §7 hard-part 4 — the
approximation switch is explicit and documented).
"""
from __future__ import annotations

import bisect

import numpy as np


def determine_edges_for_equalized_histogram(samples, n_bins: int) -> np.ndarray:
    """Exact reference semantics. `samples` must be sorted ascending.

    Returns n_bins - 1 edge values (elements of `samples`).
    Raises ValueError if n_bins > len(samples)
    (reference DetermineEdgesForEqualizedHistogram.h:36-38 throws
    std::out_of_range).
    """
    s = np.asarray(samples)
    n = s.size
    n_bins = int(n_bins)
    if n_bins > n:
        raise ValueError(
            "Too many bins. Number of bins must be less or equal to number of samples"
        )

    samples_per_bin = n // n_bins
    surplus = n - samples_per_bin * n_bins
    deficit = 0
    pos = 0
    edges = []

    for n_edge in range(n_bins - 1):
        index = samples_per_bin
        # distribute surplus/deficit over the remaining bins, biased onto
        # the first bins (reference :50-67)
        if surplus:
            share = surplus // (n_bins - n_edge)
            if share == 0:
                share = 1
            index += share
            surplus -= share
        elif deficit:
            share = deficit // (n_bins - n_edge)
            if share == 0:
                share = 1
            index -= share
            deficit -= share

        pos += index
        v = s[pos]
        # first occurrence of v in [0, pos)
        lb = bisect.bisect_left(s, v, 0, pos)
        if lb != pos:
            # duplicates: choose the nearer of run-start / run-end
            ub = bisect.bisect_right(s, v, pos, n)
            if ub == n:
                # all remaining values equal -> only the lower bound makes sense
                pos = lb
            else:
                lbdist = pos - lb
                ubdist = ub - pos
                if lbdist < ubdist or (lbdist == ubdist and deficit):
                    pos = lb
                    if lbdist > deficit:
                        surplus = lbdist - deficit
                        deficit = 0
                    else:
                        deficit -= lbdist
                else:
                    pos = ub
                    if ubdist > surplus:
                        deficit = ubdist - surplus
                        surplus = 0
                    else:
                        surplus -= ubdist
        edges.append(s[pos])

    return np.asarray(edges, dtype=s.dtype)


def edges_from_dense_counts(
    bin_edges: np.ndarray, counts: np.ndarray, n_bins: int
) -> np.ndarray:
    """Approximate equalized edges from a dense pre-histogram.

    The multi-host path: each shard computes a fine dense histogram
    (e.g. 64k bins over the observed range), counts are psum-reduced, and
    quantile edges are interpolated here from the merged counts. Replaces
    the reference's global sort (tools/DetermineHistogramBinEdges...cxx:283)
    which needs all samples in one address space.

    Args:
      bin_edges: (B+1,) fine-histogram boundaries.
      counts: (B,) merged counts.
      n_bins: target number of equalized bins.

    Returns:
      (n_bins - 1,) interpolated edge values.
    """
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        raise ValueError("empty histogram")
    cdf = np.concatenate([[0.0], np.cumsum(counts)]) / total
    targets = np.arange(1, n_bins) / n_bins
    # invert the piecewise-linear CDF
    return np.interp(targets, cdf, bin_edges)
