"""Collective statistics: all-reduced histograms over a sharded volume
(counterpart of ife_tpu/parallel/stats.py).

The reference accumulates samples in a single-thread std::vector and sorts
(DetermineHistogramBinEdges_...cxx:219-296) — the scalable equivalent sums
per-block dense histograms, all-reduces the integer counts across processes
and derives quantile edges from the reduced counts. Exact sort-based edges
remain available on a single host via ife_tpu_torch.stats.equalize.

Counts are int32 sums of int32 block counts: exact, and independent of the
order of blocks and processes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ife_tpu_torch.kernels.histogram import histogram_counts_multi
from ife_tpu_torch.parallel.mesh import (
    BlockMesh, ShardedVolume, pad_to_mesh, shard_volume,
)
from ife_tpu_torch.stats.equalize import edges_from_dense_counts
from ife_tpu_torch.stats.histogram import (
    histogram_counts, snap_pow2_grid, uniform_histogram_counts,
)


def _all_reduce(t: torch.Tensor, op=None) -> torch.Tensor:
    """`t` reduced over the processes of torch.distributed, in place (a
    no-op without a process group)."""
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
    return t


def _weights(m: torch.Tensor) -> torch.Tensor:
    return (m != 0).to(torch.int32)


def sharded_masked_histogram(
    values: ShardedVolume,
    mask: ShardedVolume,
    edges,
    mesh: BlockMesh,
) -> torch.Tensor:
    """Global histogram counts of masked voxels of a sharded volume.

    values, mask: sharded (X, Y, Z); edges: (E,), the same on every process.
    Returns (E+1,) int32 counts on mesh.device, the same on every process ==
    the single-device histogram of values[mask != 0].
    """
    e = torch.as_tensor(np.asarray(edges) if not isinstance(
        edges, torch.Tensor) else edges)
    local = sum(histogram_counts(v, e, _weights(m))
                for v, m in zip(values.blocks, mask.blocks))
    return _all_reduce(local)


def _masked_minmax(values: ShardedVolume, mask: ShardedVolume):
    """(min, max) of values[mask != 0] over the whole mesh, as floats (+inf,
    -inf for an empty mask)."""
    los, his = [], []
    for v, m in zip(values.blocks, mask.blocks):
        inside = m != 0
        big = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
        los.append(torch.where(inside, v, big).min())
        his.append(torch.where(inside, v, -big).max())
    lo = _all_reduce(torch.stack(los).min(), dist.ReduceOp.MIN)
    hi = _all_reduce(torch.stack(his).max(), dist.ReduceOp.MAX)
    return float(lo), float(hi)


def _fine_bounds(lo: float, hi: float, n_fine: int, dtype):
    """(snapped, bounds): the grid of a fine histogram over [lo, hi] — the
    power-of-two snapped grid (stats.histogram.snap_pow2_grid) for f32
    values and n_fine a multiple of 64, when its guard holds; else a
    linspace grid."""
    snapped = (snap_pow2_grid(lo, hi, n_fine)
               if n_fine % 64 == 0 and dtype == torch.float32 else None)
    if snapped is not None:
        return snapped, snapped[2]
    return None, np.linspace(lo, hi, n_fine + 1)


def _merge_tails(raw: np.ndarray, n_fine: int) -> np.ndarray:
    """Reference-convention counts over n_fine + 1 edges (n_fine + 2 bins)
    -> n_fine counts: bin 0 also holds v == lo exactly, the last tail is
    empty."""
    counts = raw[1 : n_fine + 1].copy()
    counts[0] += raw[0]
    return counts


def masked_fine_histograms_multi(
    channels: Sequence[ShardedVolume],
    mask: ShardedVolume,
    mesh: BlockMesh,
    n_fine: int = 4096,
) -> list:
    """masked_fine_histogram for a TUPLE of channels sharing one mask:
    per-channel (bounds, counts), all channels of a block binned in one
    histogram_counts_multi call (one kernel launch on the card, the mask read
    once). The same grid choice as masked_fine_histogram, so the two return
    identical pairs."""
    bounds_rows = []
    for ch in channels:
        lo, hi = _masked_minmax(ch, mask)
        if not np.isfinite(lo) or not np.isfinite(hi):
            raise ValueError("masked_fine_histograms_multi: empty mask")
        if hi <= lo:
            hi = lo + 1.0
        bounds_rows.append(_fine_bounds(lo, hi, n_fine, ch.dtype)[1])
    # host edges: the kernel's wrapper checks and rounds them there and
    # copies them to the card with the launch
    edges = torch.from_numpy(np.stack(bounds_rows))
    local = sum(
        histogram_counts_multi([ch.blocks[i] for ch in channels], edges,
                               _weights(m))
        for i, m in enumerate(mask.blocks))
    raw = _all_reduce(local).cpu().numpy().astype(np.float64)
    return [(bounds, _merge_tails(raw[c], n_fine))
            for c, bounds in enumerate(bounds_rows)]


def histogram_quantile_edges(
    counts: np.ndarray, edges: np.ndarray, n_bins: int
) -> np.ndarray:
    """Approximate equal-frequency edges from reference-convention counts.

    Adapter over the one CDF-inversion spec, stats.equalize
    .edges_from_dense_counts: `counts` has E+1 entries for E edges (the
    reference bin convention with unbounded tail bins); the tails are
    assigned synthetic finite boundaries one interior-bin-width out, and
    the piecewise-linear CDF is inverted at the n_bins-1 interior
    quantiles. The scalable replacement for the exact global sort.
    """
    counts = np.asarray(counts, dtype=np.float64)
    edges = np.asarray(edges, dtype=np.float64)
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    if counts.size != edges.size + 1:
        raise ValueError(
            f"expected {edges.size + 1} counts for {edges.size} edges, "
            f"got {counts.size}"
        )
    if edges.size < 2:
        raise ValueError("need at least 2 edges to bound the tail bins")
    lo = edges[0] - (edges[1] - edges[0])
    hi = edges[-1] + (edges[-1] - edges[-2])
    bounds = np.concatenate([[lo], edges, [hi]])
    return edges_from_dense_counts(bounds, counts, n_bins)


def masked_fine_histogram(
    values: ShardedVolume,
    mask: ShardedVolume,
    mesh: BlockMesh,
    n_fine: int = 4096,
) -> tuple:
    """(bounds, counts) fine dense histogram of values[mask != 0] over the
    whole mesh: an all-reduced min/max pass sets the range, then one binning
    pass fills `n_fine` equal-width bins.

    The bins come from the power-of-two snapped grid, binned arithmetically
    (stats.histogram.uniform_histogram_counts: integer-exact searchsorted
    semantics). When the grid guard trips (near-constant field far from
    zero) or n_fine is not a multiple of 64, the histogram kernel over a
    linspace grid serves as the exact fallback.

    Returns (bounds (n_fine+1,) float64, counts (n_fine,) float64).
    """
    lo, hi = _masked_minmax(values, mask)
    if not np.isfinite(lo) or not np.isfinite(hi):
        raise ValueError("masked_fine_histogram: mask selects no voxels")
    if hi <= lo:  # constant field: one degenerate bin still inverts cleanly
        hi = lo + 1.0
    snapped, bounds = _fine_bounds(lo, hi, n_fine, values.dtype)
    if snapped is not None:
        m, k, _ = snapped
        local = sum(
            uniform_histogram_counts(v, _weights(w), m, np.ldexp(1.0, k),
                                     n_fine)
            for v, w in zip(values.blocks, mask.blocks))
        return bounds, _all_reduce(local).cpu().numpy().astype(np.float64)
    raw = sharded_masked_histogram(
        values, mask, torch.from_numpy(bounds).to(values.dtype), mesh)
    return bounds, _merge_tails(raw.cpu().numpy().astype(np.float64), n_fine)


def merge_fine_histograms(hists, n_out: int | None = None) -> tuple:
    """Merge per-image fine histograms (different ranges) onto one union
    grid by piecewise-linear CDF resampling — the cross-image accumulation
    step of the scalable bin-edge pipeline. Exact when bounds coincide;
    otherwise the error is bounded by one source-bin width.

    Args:
      hists: sequence of (bounds (B_i+1,), counts (B_i,)).
      n_out: union-grid bin count (default: max input resolution).

    Returns (union_bounds (n_out+1,), merged_counts (n_out,)).
    """
    if not hists:
        raise ValueError("no histograms to merge")
    lo = min(float(b[0]) for b, _ in hists)
    hi = max(float(b[-1]) for b, _ in hists)
    if n_out is None:
        n_out = max(len(c) for _, c in hists)
    if hi <= lo:
        hi = lo + 1.0
    union = np.linspace(lo, hi, n_out + 1)
    merged = np.zeros(n_out, dtype=np.float64)
    for bounds, counts in hists:
        cum = np.concatenate([[0.0], np.cumsum(np.asarray(counts, np.float64))])
        cum_u = np.interp(union, np.asarray(bounds, np.float64), cum,
                          left=0.0, right=float(cum[-1]))
        merged += np.diff(cum_u)
    return union, merged


def sharded_feature_fine_histograms(
    image,
    mask,
    sigmas: Sequence[float],
    mesh: BlockMesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
    n_fine: int = 4096,
    use_fused=None,
):
    """Per-(scale, feature) fine histograms of masked feature voxels, from
    whole host arrays, without ever assembling a feature volume: features
    stay in their blocks, statistics all-reduce.

    The mask is edge-padded for the FEATURE pass (see pad_to_mesh) but
    zero-padded for COUNTING, so pad voxels never enter the statistics.

    Returns a scale-major list of length len(sigmas)*8 of (bounds, counts)
    — index i*8+k is scale i, feature k, matching the reference hist-spec
    layout (tools/MakeBag.cxx:453).
    """
    from ife_tpu_torch.parallel.features import sharded_features8

    mask_np = np.asarray(mask)
    img_p, _ = pad_to_mesh(np.asarray(image, np.float32), mesh)
    msk_feat, _ = pad_to_mesh(mask_np, mesh)
    msk_count, _ = pad_to_mesh((mask_np != 0).astype(np.uint8), mesh,
                               mode="constant")
    img_s = shard_volume(img_p, mesh)
    mskf_s = shard_volume(msk_feat, mesh)
    mskc_s = shard_volume(msk_count, mesh)

    out = []
    for s in sigmas:
        # channels bin one at a time, as in ife_tpu: each has its own range
        # pass, and the fine grid is binned arithmetically, not by the
        # multi-channel kernel
        feats = sharded_features8(img_s, mskf_s, float(s), mesh, spacing,
                                  truncate, use_fused=use_fused, stack=False)
        for chan in feats:
            out.append(masked_fine_histogram(chan, mskc_s, mesh, n_fine))
    return out
