"""Searchsorted-left histograms: the CUDA kernel ``csrc/histogram.cu`` and
its plain PyTorch twin.

Replaces ife_tpu/kernels/histogram.py (kernel _hist_multi_kernel, called
through _hist_multi_pallas): histogram_counts_multi keeps its name and
contract, histogram_counts_kernel is the counterpart of
histogram_counts_pallas, and histogram_boxes bins every box of one size in
one launch (the per-ROI binning ife_tpu ran as vmapped XLA ops, because
the TPU kernel's SMEM edges operand could not be batched).

Bin convention (reference DenseHistogram.h:13-78): E non-decreasing edges
give E+1 bins; bin(v) is the first j with v <= e_j, else E; NaN values go
to bin E. Counts are int32 and weights non-negative integers (a 0/1 mask
in the product paths). Edges are host data: every wrapper checks on the
host that they are non-decreasing and free of NaN (and raises otherwise,
or for edges that lie on a device), rounds them there, and copies them to
the card once, beside the box corners, without waiting for the card.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
twin (histogram_plain, histogram_boxes_plain). Integer atomics make the
kernel's counts independent of the order of its adds, so kernel and twin
agree exactly. The kernel has three memory forms (edges and bins in
shared memory; bins alone there; both in global memory), which `_plan`
picks from the table sizes and the card's shared memory; each is held
against the twin on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ife_tpu_torch.kernels._build import launch, use_plain_twin

_MAX_C = 64              # csrc/histogram.cu kMaxChannels
_MAX_BOXES = 65535       # gridDim.y
_TILE = 256              # csrc/histogram.cu: 32 * kRuns voxels a warp tile
_BOX_TILE = 64           # csrc/histogram.cu: 32 * kBoxRuns
_BIG_THREADS = 1024      # csrc/histogram.cu kHistMaxThreads
# the shared memory one block may take (227 KB), and the 1 KB the system
# keeps beside each resident block of an SM's 228 KB
_SMEM_MAX = 232448
_SMEM_RESERVE = 1024
# shared memory up to which a block keeps private bin copies (at least four
# blocks an SM), and the most copies it keeps
_SMEM_PRIVATE = 56 * 1024
_MAX_COPIES = 8
_WEIGHT_KIND = {torch.uint8: 1, torch.int32: 2}


# ---------------------------------------------------------------------------
# edges and weights
# ---------------------------------------------------------------------------

def _edges_f32_round_down(edges: torch.Tensor) -> torch.Tensor:
    """Edges as f32 preserving the comparison convention: for f32 values,
    `v <= e` is invariant under casting e DOWN to the largest f32 <= e (and
    wrong if e rounds up: values in (e, f32(e)] would bin low). A no-op for
    f32 edges (ife_tpu/kernels/histogram.py:_edges_f32_round_down)."""
    if edges.dtype == torch.float32:
        return edges
    e32 = edges.to(torch.float32)
    over = e32.to(edges.dtype) > edges
    return torch.where(
        over, torch.nextafter(e32, torch.full_like(e32, -float("inf"))), e32)


def check_edges(name: str, edges: torch.Tensor) -> None:
    """Raise unless the edges lie on the host and every row is
    non-decreasing and free of NaN: the bin convention (and the kernel's
    binary search) needs both. Edges on a device are refused rather than
    copied back: the wrappers check edges before they move."""
    if edges.device.type != "cpu":
        raise ValueError(f"{name}: edges must be host data (a sequence, an "
                         f"array or a CPU tensor), got a tensor on "
                         f"{edges.device}")
    e = edges.detach()
    if e.dtype in (torch.float16, torch.bfloat16):
        e = e.float()
    a = e.numpy()
    if a.dtype.kind == "f" and np.isnan(a).any():
        raise ValueError(f"{name}: edges contain NaN")
    if a.shape[-1] > 1 and (a[..., 1:] < a[..., :-1]).any():
        raise ValueError(f"{name}: edges must be non-decreasing")


def _as_edges(edges, device=None) -> torch.Tensor:
    e = torch.as_tensor(edges)
    if not e.is_floating_point():
        e = e.to(torch.float64)
    return e if device is None else e.to(device)


def _checked_edges(name: str, edges, device) -> torch.Tensor:
    """Edges as a float tensor on `device`, checked on the host before they
    move."""
    e = _as_edges(edges)
    check_edges(name, e)
    return e.to(device)


def _host_edges(name: str, edges, C: int) -> np.ndarray:
    """(C, E) f32 edges on the host: checked, rounded DOWN to f32 (the exact
    f32-value / f64-edge convention) and, from (E,), shared by the C
    channels."""
    e = _as_edges(edges)
    check_edges(name, e)
    a = _edges_f32_round_down(e).to(torch.float32).numpy()
    if a.ndim == 1:
        a = np.broadcast_to(a, (C, a.shape[0])).copy()
    if a.ndim != 2 or a.shape[0] != C:
        raise ValueError(f"{name}: edges must be (E,) or (C, E) with C = "
                         f"{C}, got {tuple(a.shape)}")
    return np.ascontiguousarray(a)


def _as_weights(weights: torch.Tensor) -> torch.Tensor:
    """The weights the kernel takes: uint8 or int32 (bool as uint8); any
    other dtype converted with .to(torch.int32), as ife_tpu's
    astype(jnp.int32)."""
    if weights.dtype == torch.bool:
        weights = weights.view(torch.uint8)
    elif weights.dtype not in _WEIGHT_KIND:
        weights = weights.to(torch.int32)
    return weights.contiguous()


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def _bin_index(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Searchsorted-left bin of every value of v (1-D) over edges e (1-D,
    non-decreasing), compared in their promoted dtype; NaN -> len(e)."""
    dt = torch.promote_types(v.dtype, e.dtype)
    idx = torch.searchsorted(e.to(dt).contiguous(), v.to(dt).contiguous(),
                             right=False)
    if v.is_floating_point():
        idx = torch.where(torch.isnan(v), e.shape[0], idx)
    return idx


def _counts_plain(v: torch.Tensor, e: torch.Tensor, w) -> torch.Tensor:
    """(E+1,) int32 counts of 1-D values v; w None or 1-D integer weights.
    int64 sums cast to int32: the same wrap as ife_tpu's int32 sums."""
    idx = _bin_index(v, e)
    add = (torch.ones_like(idx) if w is None else w.to(torch.int64))
    out = torch.zeros(e.shape[0] + 1, dtype=torch.int64, device=v.device)
    return out.scatter_add_(0, idx, add).to(torch.int32)


def histogram_plain(channels: Sequence[torch.Tensor], edges: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain twin over whole channels: (C, E+1) int32 counts;
    channel c is binned by edges[c] ((C, E)) in the promoted dtype of the
    two, with the shared weights."""
    edges = _as_edges(edges, channels[0].device)
    w = None if weights is None else weights.reshape(-1)
    return torch.stack([_counts_plain(ch.reshape(-1), edges[c], w)
                        for c, ch in enumerate(channels)])


def histogram_boxes_plain(channels: Sequence[torch.Tensor],
                          weights: torch.Tensor | None, starts, size,
                          edges: torch.Tensor) -> torch.Tensor:
    """The kernel's plain twin over boxes: (B, C, E+1) int32, box b the
    crop [s_b, s_b + size) of every channel and of the weights."""
    st = _box_starts(starts, channels[0].shape, size)
    edges = _as_edges(edges, channels[0].device)
    out = []
    for x0, y0, z0 in st.tolist():
        sl = (slice(x0, x0 + size[0]), slice(y0, y0 + size[1]),
              slice(z0, z0 + size[2]))
        out.append(histogram_plain([ch[sl] for ch in channels], edges,
                                   None if weights is None else weights[sl]))
    if not out:
        return torch.zeros((0, len(channels), edges.shape[-1] + 1),
                           dtype=torch.int32, device=channels[0].device)
    return torch.stack(out)


def _box_starts(starts, shape, size) -> np.ndarray:
    """(B, 3) int64 start corners on the host, clamped so every box lies
    inside `shape`, as lax.dynamic_slice clamps them in ife_tpu."""
    if isinstance(starts, torch.Tensor):
        starts = starts.cpu()
    st = np.asarray(starts, dtype=np.int64).reshape(-1, 3)
    hi = np.asarray(shape, np.int64) - np.asarray(size, np.int64)
    if (hi < 0).any():
        raise ValueError(f"box size {tuple(size)} exceeds the volume "
                         f"{tuple(shape)}")
    return np.clip(st, 0, hi)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class HistPlan(NamedTuple):
    """One launch's form: the edges in shared memory (else read through
    L1), the private bin copies a block keeps in shared memory (0: counts
    straight into global memory), threads a block, and the most blocks a
    box can use (one per `threads // 32` tiles)."""
    edges_shared: bool
    copies: int
    threads: int
    blocks_per_box: int


def _edge_row(E: int) -> int:
    """The length of a row of the kernel's edge table: E edges padded with
    +inf to twice the largest power of two <= E (0 for E = 0), so that its
    search needs no bound check."""
    return 0 if E == 0 else 2 << (E.bit_length() - 1)


def _plan(C: int, E: int, n: int, smem: int = _SMEM_MAX,
          boxes: bool = False) -> HistPlan:
    """The kernel's form for C channels of E edges over boxes of n voxels
    (`boxes`: the box path, else one flat run) on a card whose blocks may
    take `smem` bytes of shared memory. The edge table (rows of
    _edge_row(E)) and the bins both in shared memory where they fit, with
    up to _MAX_COPIES private bin copies while a block stays under
    _SMEM_PRIVATE; else the bins alone there and the edges read through L1
    (8 x 4096 edges); else both in global memory (64 x 4096). _BIG_THREADS
    a block where the table leaves room for one block an SM, else 256. The
    launcher sizes the grid to one wave of the blocks CUDA's occupancy query
    keeps resident (the registers a form uses are known there), at most
    blocks_per_box a box; each box's warps walk its tiles in a grid-stride
    loop."""
    edge_b, bin_b = 4 * C * _edge_row(E), 4 * C * (E + 1)
    if edge_b + bin_b <= smem:
        edges_shared = True
        copies = next((k for k in (8, 4, 2) if k <= _MAX_COPIES
                       and edge_b + k * bin_b <= min(_SMEM_PRIVATE, smem)), 1)
    elif bin_b <= smem:
        edges_shared, copies = False, 1
    else:
        edges_shared, copies = False, 0
    used = (edge_b if edges_shared else 0) + copies * bin_b
    fit = (smem + _SMEM_RESERVE) // (used + _SMEM_RESERVE)
    threads = _BIG_THREADS if fit == 1 else 256
    tiles = -(-n // (_BOX_TILE if boxes else _TILE))
    return HistPlan(edges_shared, copies, threads,
                    max(1, -(-tiles // (threads // 32))))


def _upload(device, e32: np.ndarray, starts) -> torch.Tensor:
    """The (C, P) f32 edge table and the (B, 3) box corners (int32; None for
    a flat run) in one device buffer: one copy from pinned host memory, which
    does not wait for the card (a copy from pageable memory over 64 KB
    does, and 8 x 4096 edges are 128 KB)."""
    parts = [e32.reshape(-1).view(np.uint8)]
    if starts is not None:
        parts.append(np.ascontiguousarray(starts, dtype=np.int32)
                     .reshape(-1).view(np.uint8))
    host = torch.empty(sum(p.size for p in parts), dtype=torch.uint8,
                       pin_memory=True)
    np.concatenate(parts, out=host.numpy())
    return host.to(device, non_blocking=True)


def _launch_boxes(chans, weights, e32, starts, shape, size, out) -> None:
    """Bin the channels over every box into `out` ((B, C, E+1) int32,
    zeroed): starts (B, 3) host corners, or None for one flat run of
    size[2] voxels. One launch a group of <= _MAX_C channels and <=
    _MAX_BOXES boxes."""
    dev = chans[0].device
    C, E = e32.shape
    B = 1 if starts is None else starts.shape[0]
    P = _edge_row(E)
    table = np.full((C, P), np.inf, dtype=np.float32)
    table[:, :E] = e32
    buf = _upload(dev, table, starts)
    e_ptr = buf.data_ptr()
    kind = 0 if weights is None else _WEIGHT_KIND[weights.dtype]
    wptr = 0 if weights is None else weights.data_ptr()
    _, Y, Z = shape
    sx, sy, sz = size
    n, stride = sx * sy * sz, C * (E + 1)
    for c0 in range(0, C, _MAX_C):
        group = chans[c0:c0 + _MAX_C]
        ptrs = (ctypes.c_void_p * len(group))(*(ch.data_ptr() for ch in group))
        for b0 in range(0, B, _MAX_BOXES):
            nbox = min(B - b0, _MAX_BOXES)
            p = _plan(len(group), E, n, boxes=starts is not None)
            sptr = 0 if starts is None else e_ptr + 4 * C * P + 12 * b0
            launch("histogram", dev, ptrs, len(group), wptr, kind,
                   e_ptr + 4 * c0 * P, E, sptr, nbox, Y, Z, sx, sy, sz,
                   int(p.edges_shared), p.copies, p.threads, p.blocks_per_box,
                   stride,
                   out.data_ptr() + 4 * (b0 * stride + c0 * (E + 1)))
    del buf  # freed in stream order, after the launches


def _check_cuda_channels(name, chans, weights):
    """Every channel a contiguous float32 tensor of one size on one CUDA
    device, and the weights beside them with one value per voxel."""
    dev, n = chans[0].device, chans[0].numel()
    for ch in chans:
        if ch.device != dev or ch.device.type != "cuda":
            raise ValueError(f"{name}: every channel must be on one CUDA "
                             f"device, got {ch.device}")
        if ch.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 channels, got {ch.dtype}")
        if ch.numel() != n or not ch.is_contiguous():
            raise ValueError(f"{name}: channels must be contiguous and of one "
                             f"size, got {tuple(ch.shape)} vs "
                             f"{tuple(chans[0].shape)}")
    if weights is not None and (weights.device != dev or weights.numel() != n):
        raise ValueError(f"{name}: weights must lie on {dev} with one value "
                         "per voxel")


def histogram_boxes(channels: Sequence[torch.Tensor],
                    weights: torch.Tensor | None, starts, size: Sequence[int],
                    edges) -> torch.Tensor:
    """(B, C, E+1) int32 weighted counts of every box: box b is
    [starts[b], starts[b] + size) of the (X, Y, Z) channels and of the
    weight/mask volume; channel c is binned by edges[c] ((C, E), host data).

    The batched form of ife_tpu/roi/bag.py:roi_feature_histograms_device's
    binning. Starts are clamped so each box lies inside the volume (as
    lax.dynamic_slice clamps them). CUDA channels (contiguous float32) launch
    the kernel, with f64 edges rounded down to f32 on the host; CPU channels
    run the plain twin, comparing in the promoted dtype of channels and
    edges (identical for f32 channels).
    """
    chans = list(channels)
    size = tuple(int(s) for s in size)
    e = _as_edges(edges)
    check_edges("histogram_boxes", e)
    if e.dim() != 2 or e.shape[0] != len(chans):
        raise ValueError(f"histogram_boxes: edges must be (C, E) with C = "
                         f"{len(chans)}, got {tuple(e.shape)}")
    if use_plain_twin("histogram_boxes", chans[0]):
        return histogram_boxes_plain(chans, weights, starts, size, e)
    if chans[0].dim() != 3:
        raise ValueError("histogram_boxes: channels must be (X, Y, Z) volumes")
    _check_cuda_channels("histogram_boxes", chans, weights)
    shape = tuple(chans[0].shape)
    if any(tuple(ch.shape) != shape for ch in chans):
        raise ValueError(f"histogram_boxes: channels must be of one shape, "
                         f"got {[tuple(ch.shape) for ch in chans]}")
    st = _box_starts(starts, shape, size)
    B, E = st.shape[0], e.shape[1]
    out = torch.zeros((B, len(chans), E + 1), dtype=torch.int32,
                      device=chans[0].device)
    if B == 0 or min(size) == 0:
        return out
    if weights is not None and tuple(weights.shape) != shape:
        raise ValueError(f"histogram_boxes: weights of shape "
                         f"{tuple(weights.shape)}, channels {shape}")
    w = None if weights is None else _as_weights(weights)
    e32 = _edges_f32_round_down(e).to(torch.float32).numpy()
    _launch_boxes(chans, w, np.ascontiguousarray(e32), st, shape, size, out)
    return out


def histogram_counts_multi_plain(channels: Sequence[torch.Tensor], edges,
                                 weights: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """histogram_counts_multi through the plain twin, on any device: what
    the kernel is held against on the card."""
    e = _host_edges("histogram_counts_multi", edges, len(channels))
    return histogram_plain([c.reshape(-1).to(torch.float32) for c in channels],
                           torch.from_numpy(e), weights)


def histogram_counts_multi(channels: Sequence[torch.Tensor], edges,
                           weights: torch.Tensor | None = None) -> torch.Tensor:
    """C channels binned in one pass over the shared weights stream:
    channels is a sequence of C equally sized tensors, edges (E,) shared or
    (C, E) per channel (host data), weights an optional shared non-negative
    integer tensor. Returns (C, E+1) int32; row c equals
    histogram_counts(channels[c], edges[c], weights) for f32 channels.
    Channels are compared in f32 with edges rounded DOWN to f32, as ife_tpu
    does (the exact f32-value / f64-edge convention). Any E.

    CUDA channels launch the kernel over their memory as it lies (the flat
    case of histogram_boxes); CPU channels run the plain twin.
    """
    chans = list(channels)
    e = _host_edges("histogram_counts_multi", edges, len(chans))
    if use_plain_twin("histogram_counts_multi", chans[0]):
        return histogram_plain([c.reshape(-1).to(torch.float32) for c in chans],
                               torch.from_numpy(e), weights)
    chans = [c if c.dtype == torch.float32 and c.is_contiguous()
             else c.to(torch.float32).contiguous() for c in chans]
    w = None if weights is None else _as_weights(weights)
    _check_cuda_channels("histogram_counts_multi", chans, w)
    C, n, E = len(chans), chans[0].numel(), e.shape[1]
    out = torch.zeros((1, C, E + 1), dtype=torch.int32, device=chans[0].device)
    if n > 0:
        _launch_boxes(chans, w, e, None, (1, 1, 1), (1, 1, n), out)
    return out[0]


def histogram_counts_kernel(values: torch.Tensor, edges,
                            weights: torch.Tensor | None = None) -> torch.Tensor:
    """(E,) edges -> (E+1,) int32 counts of `values` (any shape, flattened):
    the one-channel case of histogram_counts_multi. Counterpart of ife_tpu's
    histogram_counts_pallas."""
    return histogram_counts_multi([values], edges, weights)[0]
