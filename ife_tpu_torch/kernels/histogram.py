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
in the product paths). Every wrapper checks on the host that the edges are
non-decreasing and free of NaN, and raises otherwise.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
twin (histogram_plain, histogram_boxes_plain). Integer atomics make the
kernel's counts independent of the order of its adds, so kernel and twin
agree exactly.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ife_tpu_torch.kernels._build import launch, use_plain_twin

_THREADS = 256           # csrc/histogram.cu kHistThreads
_WARPS = _THREADS // 32
_MAX_C = 64              # csrc/histogram.cu kMaxChannels
_MAX_BOXES = 65535       # gridDim.y
# dynamic shared memory a block may take (227 KB) less the kernel's static
# channel-pointer table and a reserve
_SMEM_MAX = 232448 - 1024
# shared memory per block up to which at least 4 blocks share an SM
_SMEM_PRIVATE = 48 * 1024
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
    """Raise unless every edge row is non-decreasing and free of NaN: the
    bin convention (and the kernel's binary search) needs both."""
    e = edges.detach().cpu()
    if e.is_floating_point() and bool(torch.isnan(e).any()):
        raise ValueError(f"{name}: edges contain NaN")
    if e.shape[-1] > 1 and bool((e[..., 1:] < e[..., :-1]).any()):
        raise ValueError(f"{name}: edges must be non-decreasing")


def _as_edges(edges, device=None) -> torch.Tensor:
    e = torch.as_tensor(edges)
    if not e.is_floating_point():
        e = e.to(torch.float64)
    return e if device is None else e.to(device)


def _checked_edges(name: str, edges, device) -> torch.Tensor:
    """Edges as a float tensor on `device`, checked before they move: edges
    from the host are checked there, with no device round trip."""
    e = _as_edges(edges)
    check_edges(name, e)
    return e.to(device)


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
    st = np.asarray(torch.as_tensor(starts).cpu(), dtype=np.int64).reshape(-1, 3)
    hi = np.asarray(shape, np.int64) - np.asarray(size, np.int64)
    if (hi < 0).any():
        raise ValueError(f"box size {tuple(size)} exceeds the volume "
                         f"{tuple(shape)}")
    return np.clip(st, 0, hi)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _plan(C: int, E: int, n: int, B: int, device) -> tuple:
    """(copies, blocks per box): private bin copies per block (one per warp
    while a block stays under _SMEM_PRIVATE, else one; 0 = the global-
    memory path when edges and one copy exceed a block's shared memory),
    and enough blocks to fill the card about once over all boxes (the
    kernel's grid-stride loop spreads each box over its blocks)."""
    edge_b, bin_b = 4 * C * E, 4 * C * (E + 1)
    copies = next((k for k in (_WARPS, 4, 2, 1)
                   if edge_b + k * bin_b <= _SMEM_PRIVATE), 0)
    if copies == 0 and edge_b + bin_b <= _SMEM_MAX:
        copies = 1
    smem = edge_b + copies * bin_b
    per_sm = max(1, min(2048 // _THREADS, 232448 // max(smem + 1024, 1)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_box = max(1, (sms * per_sm) // B)
    return copies, int(min(per_box, -(-n // _THREADS)))


def _launch_boxes(chans, weights, starts_dev, B, shape, size, edges32, out):
    """One launch per group of <= _MAX_C channels: out[:, group] gets the
    group's counts."""
    _, Y, Z = shape
    sx, sy, sz = size
    n = sx * sy * sz
    E = edges32.shape[1]
    kind = 0 if weights is None else _WEIGHT_KIND[weights.dtype]
    wptr = 0 if weights is None else weights.data_ptr()
    sptr = 0 if starts_dev is None else starts_dev.data_ptr()
    dev = chans[0].device
    for c0 in range(0, len(chans), _MAX_C):
        group = chans[c0:c0 + _MAX_C]
        C = len(group)
        e = edges32[c0:c0 + C].contiguous()
        part = out if C == out.shape[1] else torch.zeros(
            (B, C, E + 1), dtype=torch.int32, device=dev)
        copies, per_box = _plan(C, E, n, B, dev)
        ptrs = (ctypes.c_void_p * C)(*(ch.data_ptr() for ch in group))
        launch("histogram", dev, ptrs, C, wptr, kind, e.data_ptr(), E, sptr,
               B, Y, Z, sx, sy, sz, copies, per_box, part.data_ptr())
        if part is not out:
            out[:, c0:c0 + C] = part


def _check_cuda_channels(name, chans, weights):
    shape, dev = chans[0].shape, chans[0].device
    for ch in chans:
        if ch.device != dev or ch.device.type != "cuda":
            raise ValueError(f"{name}: every channel must be on one CUDA "
                             f"device, got {ch.device}")
        if ch.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 channels, got {ch.dtype}")
        if ch.shape != shape or not ch.is_contiguous():
            raise ValueError(f"{name}: channels must be contiguous and of one "
                             f"shape, got {tuple(ch.shape)} vs {tuple(shape)}")
    if weights is not None and (weights.device != dev
                                or weights.numel() != chans[0].numel()):
        raise ValueError(f"{name}: weights must lie on {dev} with one value "
                         "per voxel")


def histogram_boxes(channels: Sequence[torch.Tensor],
                    weights: torch.Tensor | None, starts, size: Sequence[int],
                    edges: torch.Tensor) -> torch.Tensor:
    """(B, C, E+1) int32 weighted counts of every box: box b is
    [starts[b], starts[b] + size) of the (X, Y, Z) channels and of the
    weight/mask volume; channel c is binned by edges[c] ((C, E)).

    The batched form of ife_tpu/roi/bag.py:roi_feature_histograms_device's
    binning. Starts are clamped so each box lies inside the volume (as
    lax.dynamic_slice clamps them). CUDA channels (contiguous float32) launch
    the kernel, with f64 edges rounded down to f32; CPU channels run the
    plain twin, comparing in the promoted dtype of channels and edges
    (identical for f32 channels).
    """
    chans = list(channels)
    size = tuple(int(s) for s in size)
    edges = _checked_edges("histogram_boxes", edges, chans[0].device)
    if edges.dim() != 2 or edges.shape[0] != len(chans):
        raise ValueError(f"histogram_boxes: edges must be (C, E) with C = "
                         f"{len(chans)}, got {tuple(edges.shape)}")
    if use_plain_twin("histogram_boxes", chans[0]):
        return histogram_boxes_plain(chans, weights, starts, size, edges)
    if chans[0].dim() != 3:
        raise ValueError("histogram_boxes: channels must be (X, Y, Z) volumes")
    _check_cuda_channels("histogram_boxes", chans, weights)
    shape = tuple(chans[0].shape)
    st = _box_starts(starts, shape, size)
    B, E = st.shape[0], edges.shape[1]
    out = torch.zeros((B, len(chans), E + 1), dtype=torch.int32,
                      device=chans[0].device)
    if B == 0 or min(size) == 0:
        return out
    if weights is not None and tuple(weights.shape) != shape:
        raise ValueError(f"histogram_boxes: weights of shape "
                         f"{tuple(weights.shape)}, channels {shape}")
    w = None if weights is None else _as_weights(weights)
    e32 = _edges_f32_round_down(edges).contiguous()
    st_dev = torch.from_numpy(st).to(chans[0].device)
    for b0 in range(0, B, _MAX_BOXES):
        b1 = min(B, b0 + _MAX_BOXES)
        _launch_boxes(chans, w, st_dev[b0:b1], b1 - b0, shape, size, e32,
                      out[b0:b1])
    return out


def _multi_inputs(channels, edges):
    """Channels flattened and cast to f32, edges rounded DOWN to f32 and
    broadcast to (C, E), as ife_tpu's histogram_counts_multi prepares them
    (the exact f32-value / f64-edge convention); edges checked."""
    chans = [c.reshape(-1).to(torch.float32) for c in channels]
    C = len(chans)
    e = _edges_f32_round_down(
        _checked_edges("histogram_counts_multi", edges, chans[0].device))
    if e.dim() == 1:
        e = e[None, :].expand(C, e.shape[0])
    if e.dim() != 2 or e.shape[0] != C:
        raise ValueError(f"histogram_counts_multi: edges must be (E,) or "
                         f"(C, E) with C = {C}, got {tuple(e.shape)}")
    return chans, e


def histogram_counts_multi_plain(channels: Sequence[torch.Tensor], edges,
                                 weights: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """histogram_counts_multi through the plain twin, on any device: what
    the kernel is held against on the card."""
    chans, e = _multi_inputs(channels, edges)
    return histogram_plain(chans, e, weights)


def histogram_counts_multi(channels: Sequence[torch.Tensor], edges,
                           weights: torch.Tensor | None = None) -> torch.Tensor:
    """C channels binned in one pass over the shared weights stream:
    channels is a sequence of C equally sized tensors, edges (E,) shared or
    (C, E) per channel, weights an optional shared non-negative integer
    tensor. Returns (C, E+1) int32; row c equals
    histogram_counts(channels[c], edges[c], weights) for f32 channels.
    Channels are compared in f32 with edges rounded DOWN to f32, as ife_tpu
    does (the exact f32-value / f64-edge convention). Any E.

    CUDA channels launch the kernel (the one-box case of histogram_boxes
    over the flattened input); CPU channels run the plain twin.
    """
    chans, e = _multi_inputs(channels, edges)
    if use_plain_twin("histogram_counts_multi", chans[0]):
        return histogram_plain(chans, e, weights)
    chans = [c.contiguous() for c in chans]
    w = None if weights is None else _as_weights(weights.reshape(-1))
    _check_cuda_channels("histogram_counts_multi", chans, w)
    C, n, E = len(chans), chans[0].numel(), e.shape[1]
    out = torch.zeros((1, C, E + 1), dtype=torch.int32, device=chans[0].device)
    if n == 0:
        return out[0]
    _launch_boxes(chans, w, None, 1, (1, 1, n), (1, 1, n), e.contiguous(), out)
    return out[0]


def histogram_counts_kernel(values: torch.Tensor, edges,
                            weights: torch.Tensor | None = None) -> torch.Tensor:
    """(E,) edges -> (E+1,) int32 counts of `values` (any shape, flattened):
    the one-channel case of histogram_counts_multi. Counterpart of ife_tpu's
    histogram_counts_pallas."""
    return histogram_counts_multi([values], edges, weights)[0]
