"""Box histograms at every start of a dense grid of boxes (MakeBagDense's
ROI at every foreground voxel): the CUDA kernels ``csrc/dense_hist.cu`` and
their plain PyTorch twin.

Replaces no TPU kernel: ife_tpu bins a dense bag box by box, as a sparse
one. Here the boxes are the starts of `dense_starts` (roi/generate.py's
generate_dense_rois, built on the device), and for each start and channel
the counts of its box's weighted voxels per bin, in the bin convention of
kernels/histogram.py (bin(v) is the first j with v <= e_j, else E; NaN to
bin E), become a row of frequencies: counts / the box's weighted voxel
count, divided in f32 as roi/bag.py:roi_feature_histograms_device divides
them.

A CUDA tensor launches the two kernels (the bins of the region that holds
every box, then the rows by running box sums; one C call, counted as
``dense_hist`` in LAUNCHES) or raises; a CPU tensor runs the plain twin,
`dense_counts_plain`, a box-sum form of histogram_boxes_plain (3-D prefix
sums of each bin's indicator, eight corners a box). Counts are integers, so
kernel and twin agree exactly.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ife_tpu_torch.kernels._build import launch, use_plain_twin
from ife_tpu_torch.kernels.histogram import (
    _as_edges, _bin_index, _check_cuda_channels, _edges_f32_round_down,
    check_edges,
)

_MAX_BINS = 64           # kMaxEdges + 1
_SMEM_MAX = 232448       # the shared memory one block may take
# waves of rows-kernel blocks a card's SMs should see: x is cut into runs
# (each filling its own first window) until the grid holds as many blocks
_WAVES = 16
# (TY, TZ) tiles of starts a block of the rows kernel owns, largest first
_TILES = ((32, 16), (16, 16), (16, 8), (8, 8), (8, 4), (4, 4), (2, 4),
          (1, 4), (1, 1))

# The rows kernel's last plan (_launch): its RowsPlan's fields, the blocks
# of its grid and the x starts a block sweeps
DENSE_HIST_PLAN: dict = {}


class DenseIndex(NamedTuple):
    """The dense grid of one mask: `starts` (N, 3) int64 in row order;
    `lo` the least start (the corner of the box of starts); over the box of
    starts, int32 volumes of the row of each start or -1 (`row_at`) and of
    the weighted voxels of each start's box (`total_at`); `totals` (N,)
    int32, those of each row."""
    starts: torch.Tensor
    lo: tuple
    row_at: torch.Tensor
    total_at: torch.Tensor
    totals: torch.Tensor


def dense_starts(nonzero: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(N, 3) int64 start corners of the boxes of `size` centred on the
    voxels where `nonzero` (a bool (X, Y, Z) volume) is set and lying inside
    the volume (start = centre - size // 2), in the order of
    roi/generate.py:generate_dense_rois: z, then y, then x fastest."""
    shape = tuple(nonzero.shape)
    size = tuple(int(s) for s in size)
    if any(n < s for n, s in zip(shape, size)):
        return torch.zeros((0, 3), dtype=torch.int64, device=nonzero.device)
    sub = nonzero[tuple(slice(s // 2, n - s + s // 2 + 1)
                        for n, s in zip(shape, size))]
    return sub.permute(2, 1, 0).contiguous().nonzero().flip(1).contiguous()


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last three axes of int32 `x`, with a
    leading zero plane on each: box [a, b) sums to the eight corners'
    alternating sum."""
    p = x.cumsum(-3, dtype=torch.int32).cumsum(-2, dtype=torch.int32).cumsum(
        -1, dtype=torch.int32)
    return torch.nn.functional.pad(p, (1, 0, 1, 0, 1, 0))


def _box_sums(p: torch.Tensor, size) -> torch.Tensor:
    """Sums over the boxes of `size` at every start of `_prefix_sums`'
    volume p (..., X + 1, Y + 1, Z + 1): (..., X - sx + 1, Y - sy + 1,
    Z - sz + 1)."""
    ext = [n - s for n, s in zip(p.shape[-3:], size)]
    out = None
    for ox, sx in ((size[0], 1), (0, -1)):
        for oy, sy in ((size[1], 1), (0, -1)):
            for oz, sz in ((size[2], 1), (0, -1)):
                term = p[..., ox:ox + ext[0], oy:oy + ext[1], oz:oz + ext[2]]
                out = term.clone() if out is None else (
                    out.add_(term) if sx * sy * sz > 0 else out.sub_(term))
    return out


def _region(lo, starts_hi, size):
    return tuple(slice(a, b + s - 1) for a, b, s in zip(lo, starts_hi, size))


def dense_index(nonzero: torch.Tensor, weights: torch.Tensor,
                size: Sequence[int]) -> DenseIndex:
    """The dense grid of the centres where `nonzero` is set, on its device:
    the starts (dense_starts), the row of each start over the box of starts,
    and each box's count of voxels where `weights` (bool) is set. One wait
    for the card: the number of starts and their bounds."""
    size = tuple(int(s) for s in size)
    starts = dense_starts(nonzero, size)
    dev = nonzero.device
    n = starts.shape[0]
    if n == 0:
        empty = torch.zeros((0, 0, 0), dtype=torch.int32, device=dev)
        return DenseIndex(starts, (0, 0, 0), empty, empty,
                          torch.zeros((0,), dtype=torch.int32, device=dev))
    bounds = torch.stack([starts.min(0).values, starts.max(0).values + 1])
    lo, hi = (tuple(int(v) for v in row) for row in bounds.tolist())
    rel = starts - torch.as_tensor(lo, dtype=torch.int64, device=dev)
    row_at = torch.full(tuple(b - a for a, b in zip(lo, hi)), -1,
                        dtype=torch.int32, device=dev)
    row_at[rel[:, 0], rel[:, 1], rel[:, 2]] = torch.arange(
        n, dtype=torch.int32, device=dev)
    w = weights[_region(lo, hi, size)].to(torch.int32)
    total_at = _box_sums(_prefix_sums(w), size)
    totals = total_at[rel[:, 0], rel[:, 1], rel[:, 2]]
    return DenseIndex(starts, lo, row_at, total_at, totals)


def dense_counts_plain(channels: Sequence[torch.Tensor], weights: torch.Tensor,
                       starts, size: Sequence[int], edges) -> torch.Tensor:
    """The kernels' plain twin: (N, C, E+1) int32 counts of every box
    [starts[n], starts[n] + size) of the channels, each voxel where
    `weights` is nonzero counted once, channel c binned by edges[c] ((C, E)) in the promoted dtype of
    the two. Equals kernels/histogram.py:histogram_boxes_plain over the same
    starts with the weights `weights != 0`, by prefix sums of each bin's indicator over the region of the
    boxes."""
    chans = list(channels)
    size = tuple(int(s) for s in size)
    dev = chans[0].device
    e = _as_edges(edges, dev)
    st = torch.as_tensor(starts, dtype=torch.int64, device=dev).reshape(-1, 3)
    nb = e.shape[-1] + 1
    out = torch.zeros((st.shape[0], len(chans), nb), dtype=torch.int32,
                      device=dev)
    if st.shape[0] == 0:
        return out
    lo = st.min(0).values
    region = _region(lo.tolist(), (st.max(0).values + 1).tolist(), size)
    w = weights[region] != 0
    rel = st - lo
    bins = torch.arange(nb, device=dev).view(-1, 1, 1, 1)
    for c, ch in enumerate(chans):
        v = ch[region]
        idx = _bin_index(v.reshape(-1), e[c]).reshape(v.shape)
        onehot = ((idx[None] == bins) & w[None]).to(torch.int32)
        sums = _box_sums(_prefix_sums(onehot), size)
        out[:, c] = sums[:, rel[:, 0], rel[:, 1], rel[:, 2]].T
    return out


class RowsPlan(NamedTuple):
    """A plan of csrc/dense_hist.cu's rows kernel: `G` bins a block (every
    block counts all the bins, padded to quads), a tile of `TY` x `TZ`
    starts, `smem` bytes of shared memory a block, `per_sm` blocks an SM
    holds, and `col_updates`, the column updates a start and x plane: the
    tile's footprint over its starts."""
    G: int
    TY: int
    TZ: int
    smem: int
    per_sm: int
    col_updates: float


def _rows_plan(nbins: int, extent, size, smem: int = _SMEM_MAX) -> RowsPlan:
    """The rows kernel's plan: the largest tile of _TILES (cut to the extent
    of the starts) whose shared memory, as csrc/dense_hist.cu lays it out,
    fits `smem`. A block takes 1,024 threads at up to 64 registers each, so
    an SM holds one."""
    _, SY, SZ = extent
    _, sy, sz = size
    nq = -(-nbins // 4)
    for ty, tz in _TILES:
        ty, tz = min(ty, SY), min(tz, SZ)
        fy, fz = ty + sy - 1, tz + sz - 1
        row_c = fz * nq + (nq - fz * nq) % 32
        row_r = 2 * tz * nq + (2 * nq - 2 * tz * nq) % 32
        need = 4 * (-(-fy * row_c // 2) * 2 + fy * row_r + 2 * ty * tz)
        if need <= smem:
            return RowsPlan(4 * nq, ty, tz, need, 1, fy * fz / (ty * tz))
    raise ValueError(f"dense_hist: boxes of {tuple(size)} with {nbins} bins "
                     f"do not fit a block's shared memory")


def _check_dense(name, chans, weights, nbins, size):
    """The channels and weights the kernels take, and the bins and boxes
    their counters hold."""
    _check_cuda_channels(name, chans, weights)
    shape = tuple(chans[0].shape)
    if len(shape) != 3 or any(tuple(c.shape) != shape for c in chans) \
            or tuple(weights.shape) != shape:
        raise ValueError(f"{name}: channels and weights must be (X, Y, Z) "
                         f"volumes of one shape")
    sx, sy, sz = size
    if not 1 <= nbins <= _MAX_BINS or not 1 <= sx <= 255 or sy < 1 \
            or sz < 1 or sx * sz > 32767:
        raise ValueError(f"{name}: takes 1-{_MAX_BINS} bins and boxes with "
                         f"sx <= 255 and sx * sz <= 32767, got {nbins} bins, "
                         f"box {tuple(size)}")


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(chans, weights, index, size, e32: np.ndarray,
            out: torch.Tensor) -> None:
    """Both kernels, in one C call, over the region of the index's boxes
    into `out`."""
    dev = chans[0].device
    C, E = e32.shape
    X, Y, Z = chans[0].shape
    extent = tuple(index.row_at.shape)
    w = (weights if weights.dtype == torch.bool else weights != 0
         ).contiguous().view(torch.uint8)
    edges = torch.from_numpy(np.ascontiguousarray(e32, np.float32)).to(dev)
    bins = torch.empty((C, *(n + s - 1 for n, s in zip(extent, size))),
                       dtype=torch.uint8, device=dev)
    plan = _rows_plan(E + 1, extent, size)
    blocks = -(-extent[1] // plan.TY) * -(-extent[2] // plan.TZ) * C
    chunks = max(1, min(-(-_WAVES * _sm_count(dev) // blocks),
                        -(-extent[0] // size[0])))
    xchunk = -(-extent[0] // chunks)
    ptrs = (ctypes.c_void_p * C)(*(ch.data_ptr() for ch in chans))
    launch("dense_hist", dev, ptrs, C, w.data_ptr(), edges.data_ptr(), E,
           X, Y, Z, *index.lo, *size, index.row_at.data_ptr(),
           index.total_at.data_ptr(), *extent, bins.data_ptr(), out.data_ptr(),
           out.stride(0), plan.TY, plan.TZ, xchunk, plan.smem)
    DENSE_HIST_PLAN.clear()
    DENSE_HIST_PLAN.update(plan._asdict(),
                           blocks=blocks * -(-extent[0] // xchunk),
                           xchunk=xchunk)
    del bins, edges  # freed in stream order, after the launches


def dense_hist_rows(channels: Sequence[torch.Tensor], weights: torch.Tensor,
                    index: DenseIndex, size: Sequence[int], edges,
                    out: torch.Tensor) -> None:
    """Write every row of `index` into `out` ((N, C * (E+1)) float32, rows
    of any stride, columns contiguous): per channel c the frequencies of the
    box's weighted voxels over the E+1 bins of edges[c] ((C, E), host data),
    counts / index.totals divided in f32.

    CUDA channels (contiguous float32) launch the kernels, with f64 edges
    rounded down to f32 on the host as histogram_boxes rounds them; CPU
    channels run the plain twin, comparing in the promoted dtype."""
    chans = list(channels)
    size = tuple(int(s) for s in size)
    e = _as_edges(edges)
    check_edges("dense_hist_rows", e)
    if e.dim() != 2 or e.shape[0] != len(chans):
        raise ValueError(f"dense_hist_rows: edges must be (C, E) with C = "
                         f"{len(chans)}, got {tuple(e.shape)}")
    n = index.starts.shape[0]
    if tuple(out.shape) != (n, len(chans) * (e.shape[1] + 1)) \
            or out.dtype != torch.float32 or out.stride(-1) != 1:
        raise ValueError(f"dense_hist_rows: out must be float32 ({n}, "
                         f"{len(chans) * (e.shape[1] + 1)}) with contiguous "
                         f"rows, got {out.dtype} {tuple(out.shape)}")
    if use_plain_twin("dense_hist_rows", chans[0]):
        counts = dense_counts_plain(chans, weights, index.starts, size, e)
        out.copy_((counts.to(torch.float32)
                   / index.totals.view(-1, 1, 1).to(torch.float32))
                  .reshape(n, -1))
        return
    _check_dense("dense_hist_rows", chans, weights, e.shape[1] + 1, size)
    if n == 0:
        return
    e32 = _edges_f32_round_down(e).to(torch.float32).numpy()
    _launch(chans, weights, index, size, e32, out)
