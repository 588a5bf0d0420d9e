"""Whole-image transform ops backing the utility tools (counterpart of
ife_tpu/ops/transform.py).

Reference analogs: MaskedImageFilter, ExtractMaskedRegion,
ExtractBoundingBox, PadImage, Resample, ExtractSlices, ExtractWindow.

The ops that ife_tpu ran as jnp on its device (mask_image, relabel_mask,
intensity_window and the two resamplers at order <= 1) run in torch on
`device`: None is this process's card (parallel.mesh.default_device, which
raises on a host without one unless IFE_PLATFORM=cpu), "cpu" asks for the
CPU. Their inputs may be tensors or numpy arrays. The box, pad and slice
helpers are numpy, as in ife_tpu; cubic resampling runs scipy on the host,
as ife_tpu does.

The resamplers reproduce jax.scipy.ndimage.map_coordinates as ife_tpu runs
it on the CPU under x64: coordinates in f64 (numpy, on the host), order 0
rounds half away from zero, order 1 weighs two neighbours per axis, and
mode "constant" replaces each neighbour outside the source by cval while
keeping its weight (a point at -0.5 is 0.5 * cval + 0.5 * v[0]); `_linear`
says how the corners sum. Mode "constant" pads the source by one voxel of
cval, so an index outside it clips to a pad voxel.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ife_tpu_torch.core.volume import Volume
from ife_tpu_torch.parallel.mesh import default_device


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """`x` (a tensor or an array) on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mask_image(img, mask, outside=0.0, device=None) -> torch.Tensor:
    """out = img where mask != 0 else outside, in img's dtype (reference
    tools/MaskedImageFilter.cxx:86-105)."""
    dev = default_device(device)
    img, mask = _tensor(img, dev), _tensor(mask, dev)
    return torch.where(mask != 0, img,
                       torch.tensor(outside, dtype=img.dtype, device=dev))


def relabel_mask(mask, include: Sequence[int], inside=1, outside=0,
                 device=None) -> torch.Tensor:
    """values in `include` -> inside, else outside, in mask's dtype
    (reference tools/ExtractMaskedRegion.cxx:20-72 MembershipFunctor)."""
    dev = default_device(device)
    mask = _tensor(mask, dev)
    inc = torch.tensor(sorted(int(v) for v in include), device=dev)
    return torch.where(torch.isin(mask, inc),
                       torch.tensor(inside, dtype=mask.dtype, device=dev),
                       torch.tensor(outside, dtype=mask.dtype, device=dev))


def bounding_box(mask) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(start, size) of the mask's axis-aligned bounding box (reference
    tools/ExtractBoundingBox.cxx:93-122, ImageMaskSpatialObject)."""
    m = _host(mask) != 0
    if not m.any():
        raise ValueError("mask has no foreground voxels")
    start, size = [], []
    for d in range(m.ndim):
        axes = tuple(a for a in range(m.ndim) if a != d)
        proj = m.any(axis=axes)
        idx = np.nonzero(proj)[0]
        start.append(int(idx[0]))
        size.append(int(idx[-1] - idx[0] + 1))
    return tuple(start), tuple(size)


def crop_to_bounding_box(vol: Volume, mask) -> Volume:
    start, size = bounding_box(mask)
    return vol.crop(start, size)


def pad_to_size_2d(
    img: np.ndarray, target: Sequence[int], value=0.0
) -> np.ndarray:
    """Centered constant pad of a 2D image to `target` (reference
    tools/PadImage.cxx:60-76). Asymmetric remainder goes to the high side."""
    out_shape = tuple(int(t) for t in target)
    pads = []
    for d in range(2):
        extra = out_shape[d] - img.shape[d]
        if extra < 0:
            raise ValueError(
                f"target {out_shape} smaller than image {img.shape} on axis {d}"
            )
        pads.append((extra // 2, extra - extra // 2))
    return np.pad(img, pads, mode="constant", constant_values=value)


def intensity_window(img, level: float = -500.0, width: float = 1500.0,
                     device=None) -> torch.Tensor:
    """Window/level to uint8 (reference tools/ExtractWindow.cxx:36-40,
    177-195 — IntensityWindowingImageFilter defaults level -500 width 1500,
    output [0, 255]). ife_tpu's f32 arithmetic in its order, rounding half
    to even."""
    dev = default_device(device)
    img = _tensor(img, dev)
    if not img.is_floating_point():
        img = img.to(torch.float32)
    lo = level - width / 2.0
    hi = level + width / 2.0

    def c(v):  # a Python scalar as ife_tpu's weak type makes it: img's dtype
        return torch.tensor(v, dtype=img.dtype, device=dev)

    y = (img - c(lo)) / c(hi - lo) * c(255.0)
    return torch.clip(torch.round(y), 0, 255).to(torch.uint8)


def _round_half_away_from_zero(c: np.ndarray) -> np.ndarray:
    """map_coordinates' nearest index (lax.round); exact, unlike
    floor(c + 0.5), at the largest double below one half."""
    t = np.trunc(c)
    return (t + np.sign(c) * (np.abs(c - t) >= 0.5)).astype(np.int64)


def _gather(vol: torch.Tensor, idx: Sequence[np.ndarray]) -> torch.Tensor:
    """vol at the outer product of per-axis indices (index_select per
    axis)."""
    for axis, i in enumerate(idx):
        vol = vol.index_select(axis, torch.from_numpy(i).to(vol.device))
    return vol


def _fma(w: torch.Tensor, v: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """f32 fma(w, v, acc). The product of two f32 values is exact in f64, so
    the f64 addcmul rounds once to f64 (with or without contraction) and the
    cast once to f32: the fused rounding, except where the f64 sum lands on
    an f32 tie."""
    return acc.double().addcmul_(w.double(), v.double()).to(torch.float32)


def _linear(src: torch.Tensor, coords: Sequence[np.ndarray], shift: int,
            top: Sequence[int], select: bool) -> torch.Tensor:
    """map_coordinates order 1 as ife_tpu computes it on the CPU under x64.

    Per axis the indices floor(c) + shift and the one after it, clipped into
    [0, top[axis]], with f64 weights 1 - w and w (w = c - floor(c)). The
    weights are weakly typed, so each corner's weight product (f64, in axis
    order) is rounded to f32 and the corners sum in f32, in
    itertools.product order (the last axis fastest), and XLA's CPU build
    contracts that sum into FMAs: term k > 1 as fma(w_k, v_k, acc), the
    first two as fma(w_0, v_0, w_1 v_1) where a select feeds the products
    (mode "constant", `select`) and as fma(w_1, v_1, w_0 v_0) where none
    does (mode "nearest"). The corners are gathered by index_select, axis by
    axis, each partial gather shared by the corners under it: never a
    volume of indices."""
    dev = src.device
    nd = src.dim()
    idx, wts = [], []
    for axis, (c, t) in enumerate(zip(coords, top)):
        lower = np.floor(c)
        w_hi = c - lower
        i = lower.astype(np.int64) + shift
        view = [1] * nd
        view[axis] = -1
        idx.append([torch.from_numpy(np.clip(j, 0, t)).to(dev)
                    for j in (i, i + 1)])
        wts.append([torch.from_numpy(w).to(dev).view(view)
                    for w in (1 - w_hi, w_hi)])

    def corners(vol, axis, w):
        if axis == nd:
            yield w.expand(vol.shape).to(torch.float32), vol
            return
        for k in (0, 1):
            yield from corners(vol.index_select(axis, idx[axis][k]), axis + 1,
                               wts[axis][k] if w is None else w * wts[axis][k])

    terms = corners(src, 0, None)
    w0, v0 = next(terms)
    if select:
        w1, v1 = next(terms)
        acc = _fma(w0, v0, w1 * v1)
        del w1, v1
    else:
        acc = w0 * v0
    del w0, v0
    for w, v in terms:
        acc = _fma(w, v, acc)
    return acc


def resample_to_spacing_2d(
    img,
    spacing: Sequence[float],
    out_spacing: float = 0.25,
    order: int = 3,
    device=None,
) -> torch.Tensor:
    """Resample a 2D image to isotropic `out_spacing`, nearest
    extrapolation at edges; f32 on `device`.

    Semantics target: reference tools/ExtractWindow.cxx:112-161 (0.25 mm
    isotropic, itk::BSplineInterpolateImageFunction order 3 +
    NearestNeighborExtrapolate; output size via ceil, :119-122; the mask
    path uses nearest-neighbor, :230-232 -> order=0). order > 1 is scipy's
    B-spline on the host, as in ife_tpu; order <= 1 runs on the device in
    map_coordinates' mode "nearest" (order 0 first rounds the grid half to
    even, as ife_tpu's jnp.round does).
    """
    dev = default_device(device)
    in_shape = tuple(img.shape)
    out_shape = tuple(
        int(math.ceil(in_shape[d] * spacing[d] / out_spacing))
        for d in range(2)
    )
    coords = [
        (np.arange(out_shape[d]) * out_spacing) / spacing[d] for d in range(2)
    ]
    if order > 1:
        from scipy import ndimage as _ndi

        grid = np.meshgrid(*coords, indexing="ij")
        out = _ndi.map_coordinates(
            np.asarray(_host(img), dtype=np.float32), grid, order=order,
            mode="nearest",
        )
        return torch.from_numpy(out).to(dev)
    src = _tensor(img, dev).to(torch.float32)
    top = [n - 1 for n in in_shape]
    if order == 0:
        return _gather(src, [np.clip(np.round(c), 0, t).astype(np.int64)
                             for c, t in zip(coords, top)])
    return _linear(src, coords, 0, top, select=False)


def resample_to_grid(
    source: Volume, target: Volume, order: int = 1, default_value: float = 0.0,
    device=None,
) -> Volume:
    """Resample `source` onto `target`'s voxel grid, aligning by physical
    origin/spacing — a translation transform from the origin difference
    (reference tools/Resample.cxx:83-103). f32 on `device`; a point whose
    neighbour lies outside the source takes `default_value` for it
    (map_coordinates' mode "constant")."""
    if order not in (0, 1):
        raise NotImplementedError("resample_to_grid takes order 0 or 1")
    dev = default_device(device)
    coords = []
    for d in range(3):
        phys = target.origin[d] + target.spacing[d] * np.arange(target.shape[d])
        coords.append((phys - source.origin[d]) / source.spacing[d])
    # one voxel of cval around the source: an index outside [0, n) clips to
    # a pad voxel
    src = torch.nn.functional.pad(
        _tensor(source.data, dev).to(torch.float32), (1, 1) * 3,
        value=default_value)
    top = [n + 1 for n in source.shape]
    if order == 0:
        data = _gather(src, [np.clip(_round_half_away_from_zero(c) + 1, 0, t)
                             for c, t in zip(coords, top)])
    else:
        data = _linear(src, coords, 1, top, select=True)
    return Volume(data, spacing=target.spacing, origin=target.origin)


def slice_indices(
    n: int,
    indices: Sequence[int] = (),
    fractions: Sequence[float] = (),
    window: int = 0,
    stride: int = 1,
) -> List[int]:
    """Expand slice selections: explicit indices and/or fractional positions,
    each optionally expanded to +/- window neighbors with stride (reference
    tools/ExtractSlices.cxx:167-205)."""
    base = [int(i) for i in indices]
    base += [int(round(f * (n - 1))) for f in fractions]
    out = set()
    for b in base:
        for k in range(-window, window + 1):
            idx = b + k * stride
            if 0 <= idx < n:
                out.add(idx)
    # reference sorts + dedups (tools/ExtractSlices.cxx:200-203)
    return sorted(out)


def extract_slice(vol: np.ndarray, axis: int, index: int, flip: bool = True) -> np.ndarray:
    """One 2D slice along `axis`. With flip=True the slice's SECOND axis is
    reversed for axes 0 and 1 (not 2) — the reference's direction fix for
    formats without orientation metadata (tools/ExtractSlices.cxx:217-231:
    flipAxes = [false, axisIndex != 2]). A flipped slice is a
    negative-stride view: make it contiguous before torch.from_numpy."""
    sl = [slice(None)] * 3
    sl[axis] = index
    plane = np.asarray(vol)[tuple(sl)]
    if flip and axis != 2:
        plane = plane[:, ::-1]
    return plane
