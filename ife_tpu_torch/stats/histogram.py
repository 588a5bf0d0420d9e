"""Dense histograms with fixed edges (counterpart of
ife_tpu/stats/histogram.py).

Reference semantics (include/ife/Statistics/DenseHistogram.h:13-78):
n sorted edges define n+1 bins
    (-inf, e0], (e0, e1], ..., (e_{n-1}, +inf)
i.e. bin(x) = index of first edge >= x  ==  searchsorted(edges, x, 'left').
Frequencies are counts / total.

On the card every f32 histogram goes to the hand-written CUDA kernel
(kernels/histogram.py: one binary search and one shared-memory atomic per
value); ife_tpu's cumulative compare-reduce existed because a scatter-add
was pathological on the TPU. Counts accumulate in int32, as in ife_tpu.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ife_tpu_torch.kernels.histogram import (
    _checked_edges,
    _counts_plain,
    histogram_counts_kernel,
)
from ife_tpu_torch.native_lib import histogram_native


def histogram_counts(
    values: torch.Tensor,
    edges,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Counts over n+1 bins for n edges, reference bin convention.

    Accumulates in int32 (exact to 2.1e9 per bin; an f32 accumulator would
    drop +1 increments past 2^24).

    Args:
      values: any shape; flattened.
      edges: (E,) sorted ascending.
      weights: optional, same size as values: non-negative integer weights
        (cast to int32; in the product paths a 0/1 mask).

    Returns:
      (E+1,) int32 counts.

    f32 CUDA values launch the histogram kernel (edges rounded down to f32,
    the exact f32-value convention); CPU values run histogram_counts_plain;
    CUDA values of any other dtype raise.
    """
    if values.is_cuda:
        if values.dtype != torch.float32:
            raise ValueError(f"histogram_counts: the CUDA kernel takes float32 "
                             f"values, got {values.dtype}")
        return histogram_counts_kernel(values, edges, weights)
    return histogram_counts_plain(values, edges, weights)


def histogram_counts_plain(
    values: torch.Tensor,
    edges,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain form of histogram_counts (counterpart of ife_tpu's
    histogram_counts_xla): searchsorted-left in the promoted dtype of values
    and edges, NaN in the upper tail, any dtype and device. E == 0 returns
    the total (the count, or the sum of the weights)."""
    v = values.reshape(-1)
    w = None if weights is None else weights.reshape(-1).to(torch.int32)
    e = _checked_edges("histogram_counts", edges, v.device)
    if e.dim() != 1:
        raise ValueError(f"histogram_counts: edges must be (E,), got "
                         f"{tuple(e.shape)}")
    return _counts_plain(v, e, w)


def batched_histogram_counts(
    values: torch.Tensor, edges: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Many histograms at once: values (H, N), edges (H, E) -> (H, E+1)
    int32, row h binned by edges[h] with weights[h]. The plain form per row,
    as ife_tpu vmaps its XLA form."""
    return torch.stack([
        histogram_counts_plain(values[h], edges[h],
                               None if weights is None else weights[h])
        for h in range(values.shape[0])])


# ---------------------------------------------------------------------------
# fine (many-bin) equal-width histograms: arithmetic binning
# ---------------------------------------------------------------------------

def snap_pow2_grid(lo: float, hi: float, n_fine: int):
    """Snap [lo, hi] to a power-of-two uniform grid e_j = (m + j)·w,
    j = 0..n_fine, with w = 2^k and m integer: the edge set for which
    searchsorted-left binning reduces EXACTLY to f32 arithmetic (see
    uniform_histogram_counts). Returns (m, k, bounds_f64) — every e_j is
    exactly f32-representable — or None when the grid cannot satisfy the
    exactness guard |m| + n_fine + 2 <= 2^22 (a near-constant field far
    from zero: range/|lo| < ~2^-10; callers fall back to the
    compare-reduce path there). A copy of ife_tpu's.

    The grid covers at least [lo, hi] (e_0 <= lo, e_{n_fine} >= hi) and
    at most twice its width.
    """
    lo = float(lo)
    hi = float(hi)
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo or n_fine < 1:
        return None
    # w >= range/(n_fine-1) guarantees e_{n_fine} = e_0 + n_fine*w >= hi
    # even with e_0 = lo - (w - ulp)
    k = int(np.ceil(np.log2((hi - lo) / max(n_fine - 1, 1))))
    if not (-120 <= k <= 120):  # stay far from f32 subnormal/overflow
        return None
    w = float(np.ldexp(1.0, k))
    m = int(np.floor(lo / w))
    if abs(m) + n_fine + 2 > (1 << 22):
        return None
    bounds = (m + np.arange(n_fine + 1, dtype=np.float64)) * w
    return m, k, bounds


def uniform_histogram_counts(
    values: torch.Tensor,
    weights01: torch.Tensor,
    m,
    w,
    n_fine: int,
) -> torch.Tensor:
    """Merged-tail counts over the power-of-two grid of snap_pow2_grid:
    (n_fine,) int32, bin b = {x : e_b < x <= e_{b+1}} with bin 0 also
    holding x <= e_0 — the reference searchsorted convention after the fine
    pipeline's tail merge. Voxels count where weights01 != 0.

    The bin index is arithmetic, as in ife_tpu: d = (x - e_0)·2^-k, floor,
    then a 3-edge windowed correction against the exact edge values
    (m + j)·w, all in f32. ife_tpu accumulated the bins with a one-hot
    matmul on the TPU's matrix unit; here a scatter-add of int64 counts
    does it (plain torch, any device). Integer-exact against ife_tpu.

    Args:
      values: f32, any shape (flattened).
      weights01: same size, 0/1 weights.
      m, w: the snapped grid's integer offset and bin width (from
        snap_pow2_grid), as numbers or 0-d tensors.
      n_fine: bin count, a multiple of 64.
    """
    if n_fine % 64:
        raise ValueError("n_fine must be a multiple of 64")
    x = values.reshape(-1).to(torch.float32)
    w01 = weights01.reshape(-1)
    dev = x.device
    mf = torch.as_tensor(m, dtype=torch.float32, device=dev)
    wf = torch.as_tensor(w, dtype=torch.float32, device=dev)
    inv_w = 1.0 / wf  # reciprocal of a power of two: exact
    L = mf * wf       # e_0; |m| <= 2^22 -> exact
    d = (x - L) * inv_w
    d = torch.where(torch.isnan(d), torch.zeros((), device=dev), d)
    j0 = torch.clamp(torch.floor(d), 0.0, float(n_fine))
    # the true bin b = #{e_j < x} is within 1 of floor(d), and each
    # (m + j0 + t)·w is the exact edge value, so three comparisons pin it
    b = j0.to(torch.int64) - 1
    for t in (-1.0, 0.0, 1.0):
        b = b + (x > (mf + (j0 + t)) * wf).to(torch.int64)
    ob = torch.clamp(b, 1, n_fine) - 1  # tail merge + garbage clamp
    out = torch.zeros(n_fine, dtype=torch.int64, device=dev)
    out.scatter_add_(0, ob, (w01 != 0).to(torch.int64))
    return out.to(torch.int32)


class DenseHistogram:
    """Host-side accumulating histogram mirroring the reference class API
    (insert / get_counts / get_frequencies / reset_counts), with vectorized
    bulk inserts; large f32 inserts bin in the native library's threads, as
    ife_tpu's do.

    Reference: DenseHistogram.h:13-78. getFrequencies divides by the total
    count (an integer sum, DenseHistogram.h:55-60).
    """

    def __init__(self, edges: Sequence[float]):
        e = np.asarray(list(edges), dtype=np.float64)
        if e.size < 1:
            raise ValueError("DenseHistogram needs at least one edge")
        self._edges = e
        self._counts = np.zeros(e.size + 1, dtype=np.uint64)

    @property
    def edges(self) -> np.ndarray:
        return self._edges

    @property
    def num_bins(self) -> int:
        return self._counts.size

    def insert(self, value) -> None:
        self.insert_many(np.atleast_1d(np.asarray(value)))

    def insert_many(self, values, weights=None) -> None:
        """Vectorized bulk insert (weights must be nonneg ints if given)."""
        v = np.asarray(values).reshape(-1)
        # f32 only: the C path bins float32, which could land f64 values in
        # a neighbor bin right at an edge. As in ife_tpu, a NaN lands in bin
        # 0 on this path and in the upper tail on numpy's.
        if weights is None and v.size > (1 << 16) and v.dtype == np.float32:
            self._counts += histogram_native(v, self._edges)
            return
        idx = np.searchsorted(self._edges, v, side="left")
        if weights is None:
            binc = np.bincount(idx, minlength=self._counts.size)
        else:
            binc = np.bincount(
                idx, weights=np.asarray(weights).reshape(-1), minlength=self._counts.size
            )
        self._counts += binc.astype(np.uint64)

    def get_counts(self) -> np.ndarray:
        return self._counts.copy()

    def get_frequencies(self) -> np.ndarray:
        total = self._counts.sum()
        # reference divides by zero -> nan/inf; we keep 0/0 IEEE semantics
        with np.errstate(divide="ignore", invalid="ignore"):
            return self._counts / np.float64(total)

    def reset_counts(self) -> None:
        self._counts[:] = 0

    def __str__(self) -> str:
        # reference operator<< writes comma-separated counts (DenseHistogram.h:80-84)
        return ",".join(str(int(c)) for c in self._counts)
