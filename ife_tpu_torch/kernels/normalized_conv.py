"""Normalized Gaussian convolution G*(c*f) / G*c: the CUDA kernel
``csrc/normalized_conv.cu`` and its plain PyTorch twin.

Replaces ife_tpu/kernels/fused.py:fused_normalized_conv_sweep. Three
separable passes (x, y, z) over numerator and denominator with edge-clamped
taps, the certainty used raw, the divide without epsilon: one launch of the
x pass for both arrays, one y launch each, the z pass with the divide. Every
pass stages its inputs in shared memory at clamped positions and walks them
taps outer, a run of outputs a thread; bound by the issue of the taps'
unfused multiplies and adds at large radii, by bytes at small ones; see the
source for the design. ``z_plan`` is the z pass's launch geometry.

``fused_normalized_conv_sweep_tiled`` replaces
ife_tpu/kernels/fused.py:fused_normalized_conv_sweep_tiled: the same
function over ``n_tiles`` Y slabs, each extended by the y radius and sent
through the kernel on its own, the kept rows written into one output. On
the TPU the slabs made the input rings fit VMEM; the CUDA kernel has no such
cap, so here the entry exists for parity and bounds the kernel's scratch (two
slab-sized volumes instead of two whole ones). It equals the untiled kernel
to the bit.

``fused_smooth_yz`` runs the y and z passes alone, the input of the
features8_xs_stream kernel (where ife_tpu/kernels/fused.py:fused_features8
smooths y and z with XLA band einsums); ``fused_smooth_xz`` the x and z
passes alone, the input of the features8_ys_multi kernel (XLA band einsums
in ife_tpu/ops/features.py:multiscale_features8_fused).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, use_plain_twin,
)
from ife_tpu_torch.ops.stencil import kernel_smooth_axis, smooth_taps

MAX_RADIUS = 128  # csrc/normalized_conv.cu kMaxTaps = 2 * 128 + 1
# csrc/normalized_conv.cu: the z pass's outputs a thread, threads a block,
# and the shared memory a block may take
Z_RUN, Z_THREADS, Z_SMEM = 4, 256, 48 * 1024


def z_plan(Z: int, r: int):
    """The z pass's launch geometry (csrc/normalized_conv.cu z_plan, which
    this mirrors): (rows, chunk, len) — the z rows a block owns, the outputs
    a row and step (a multiple of Z_RUN; rows of up to Z_RUN * Z_THREADS
    voxels are one chunk, longer ones take one block and several chunks),
    and the inputs a row and array staged for a chunk, z = c0 - r + j for j
    in [0, len). A block holds the taps and its rows' chunks in Z_SMEM."""
    taps = (2 * r + 1 + 7) // 8 * 8
    runs = -(-Z // Z_RUN)
    if runs >= Z_THREADS:
        rows, chunk = 1, Z_RUN * Z_THREADS
    else:
        rows, chunk = Z_THREADS // runs, Z_RUN * runs
    length = chunk + (2 * r + 3) // 4 * 4 + 8
    rows = max(1, min(rows, (Z_SMEM - 4 * taps) // (2 * 4 * length)))
    return rows, chunk, length


def normalized_conv_plain(image: torch.Tensor, certainty: torch.Tensor,
                          sigma: float,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0),
                          truncate: float = 4.5) -> torch.Tensor:
    """The kernel's plain twin: ops.stencil.normalized_gaussian_convolution
    with the kernel's tap-ordered sums (kernel_smooth_axis) along x, y, z;
    no epsilon."""
    num, den = _smooth_pair_plain(image, certainty, (0, 1, 2), sigma,
                                  spacing, truncate)
    return num / den


def _c_taps(taps):
    return (ctypes.c_float * len(taps))(*taps), len(taps)


def fused_normalized_conv_sweep(image: torch.Tensor, mask: torch.Tensor,
                                sigma: float,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                truncate: float = 4.5) -> torch.Tensor:
    """out = G_sigma*(mask*image) / G_sigma*mask with ZeroFluxNeumann
    boundaries, sigma in physical units; `mask` is the raw certainty (not
    clamped). NaN where the certainty's smoothed support is 0, like the
    reference.

    CUDA tensors (contiguous float32 of one shape) launch the kernel; CPU
    tensors run the plain twin; any other input raises.
    """
    if use_plain_twin("fused_normalized_conv_sweep", image):
        return normalized_conv_plain(image, mask, sigma, spacing, truncate)
    return _launch_normalized_conv("fused_normalized_conv_sweep", image, mask,
                                   sigma, spacing, truncate)


def _launch_normalized_conv(name, image, mask, sigma, spacing, truncate,
                            count_as=None):
    check_cuda_volume(f"{name} image", image)
    check_cuda_volume(f"{name} mask", mask, shape=image.shape)
    X, Y, Z = image.shape
    per_axis = [smooth_taps(float(sigma), float(h), float(truncate))
                for h in spacing]
    if max(r for _, r in per_axis) > MAX_RADIUS:
        raise ValueError(
            f"{name}: radius > {MAX_RADIUS} voxels "
            f"(sigma={sigma}, spacing={tuple(spacing)})")
    (tx, ntx), (ty, nty), (tz, ntz) = (_c_taps(t) for t, _ in per_axis)
    out = torch.empty_like(image)
    s1 = torch.empty_like(image)
    s2 = torch.empty_like(image)
    launch("normalized_conv", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), s1.data_ptr(),
           s2.data_ptr(), X, Y, Z, tx, ntx, ty, nty, tz, ntz,
           count_as=count_as)
    # the launch is asynchronous: the scratch must outlive it. The caching
    # allocator reuses freed blocks only in stream order, so dropping s1/s2
    # here is safe on the current stream.
    return out


def tile_slabs(Y: int, ry: int, n_tiles: int):
    """The Y slabs of fused_normalized_conv_sweep_tiled: per tile
    (y0, y1, e0, e1), the kept rows [y0, y1) (bounds round(t * Y / n_tiles))
    and the rows [e0, e1) it is computed from, the kept rows extended by the
    y radius and clipped at the faces. Taps of a kept row reach at most ry
    rows into the extension, so no kept row sees a slab-edge clamp; the outer
    edges of the first and last slab are the volume's own."""
    if n_tiles < 1:
        raise ValueError(f"n_tiles must be >= 1, got {n_tiles}")
    bounds = [round(t * Y / n_tiles) for t in range(n_tiles + 1)]
    return [(y0, y1, max(0, y0 - ry), min(Y, y1 + ry))
            for y0, y1 in zip(bounds[:-1], bounds[1:])]


def _tiled(conv, image, mask, sigma, spacing, truncate, n_tiles):
    _, ry = smooth_taps(float(sigma), float(spacing[1]), float(truncate))
    out = torch.empty_like(image)
    for y0, y1, e0, e1 in tile_slabs(image.shape[1], ry, int(n_tiles)):
        if y1 == y0:
            continue
        o = conv(image[:, e0:e1].contiguous(), mask[:, e0:e1].contiguous())
        out[:, y0:y1] = o[:, y0 - e0:y1 - e0]
    return out


def normalized_conv_tiled_plain(image: torch.Tensor, certainty: torch.Tensor,
                                sigma: float,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                truncate: float = 4.5,
                                n_tiles: int = 2) -> torch.Tensor:
    """The tiled entry's plain twin: the same slabs through
    normalized_conv_plain."""
    return _tiled(
        lambda f, c: normalized_conv_plain(f, c, sigma, spacing, truncate),
        image, certainty.to(image.dtype), sigma, spacing, truncate, n_tiles)


def fused_normalized_conv_sweep_tiled(image: torch.Tensor, mask: torch.Tensor,
                                      sigma: float,
                                      spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                      truncate: float = 4.5,
                                      n_tiles: int = 2) -> torch.Tensor:
    """fused_normalized_conv_sweep over `n_tiles` contiguous Y slabs
    (tile_slabs), each copied with its extension, swept on its own, its kept
    rows written into the one output: the same values as the untiled entry,
    to the bit.

    CUDA tensors launch the kernel once per slab (counted as
    "normalized_conv_tiled"); CPU tensors run the plain twin; any other
    input raises.
    """
    if use_plain_twin("fused_normalized_conv_sweep_tiled", image):
        return normalized_conv_tiled_plain(image, mask, sigma, spacing,
                                           truncate, n_tiles)
    check_cuda_volume("fused_normalized_conv_sweep_tiled image", image)
    check_cuda_volume("fused_normalized_conv_sweep_tiled mask", mask,
                      shape=image.shape)
    return _tiled(
        lambda f, c: _launch_normalized_conv(
            "fused_normalized_conv_sweep_tiled", f, c, sigma, spacing,
            truncate, count_as="normalized_conv_tiled"),
        image, mask, sigma, spacing, truncate, n_tiles)


def _smooth_pair_plain(image, certainty, axes, sigma, spacing, truncate):
    c = certainty.to(image.dtype)

    def two(v):
        for d in axes:
            v = kernel_smooth_axis(v, d, sigma, float(spacing[d]), truncate)
        return v

    return two(image * c), two(c)


def _fused_smooth_pair(name, kernel, axes, image, certainty, sigma, spacing,
                       truncate):
    """The launch behind fused_smooth_yz / fused_smooth_xz: the passes along
    `axes` (the second is z) over c*image and c."""
    check_cuda_volume(f"{name} image", image)
    check_cuda_volume(f"{name} certainty", certainty, shape=image.shape)
    X, Y, Z = image.shape
    per_axis = [smooth_taps(float(sigma), float(spacing[d]), float(truncate))
                for d in axes]
    if max(r for _, r in per_axis) > MAX_RADIUS:
        raise ValueError(f"{name}: radius > {MAX_RADIUS} voxels "
                         f"(sigma={sigma}, spacing={tuple(spacing)})")
    (ta, nta), (tz, ntz) = (_c_taps(t) for t, _ in per_axis)
    num = torch.empty_like(image)
    den = torch.empty_like(image)
    launch(kernel, image.device,
           image.data_ptr(), certainty.data_ptr(), num.data_ptr(),
           den.data_ptr(), X, Y, Z, ta, nta, tz, ntz)
    return num, den


def smooth_yz_plain(image: torch.Tensor, certainty: torch.Tensor,
                    sigma: float, spacing: Sequence[float] = (1.0, 1.0, 1.0),
                    truncate: float = 4.5):
    """The y/z kernel's plain twin: (G_z G_y (c*image), G_z G_y c)."""
    return _smooth_pair_plain(image, certainty, (1, 2), sigma, spacing,
                              truncate)


def fused_smooth_yz(image: torch.Tensor, certainty: torch.Tensor,
                    sigma: float, spacing: Sequence[float] = (1.0, 1.0, 1.0),
                    truncate: float = 4.5):
    """(G_z G_y (c*image), G_z G_y c) with ZeroFluxNeumann boundaries, the
    certainty c used raw.

    CUDA tensors (contiguous float32 of one shape) launch the kernel's y and
    z passes; CPU tensors run the plain twin; any other input raises.
    """
    if use_plain_twin("fused_smooth_yz", image):
        return smooth_yz_plain(image, certainty, sigma, spacing, truncate)
    return _fused_smooth_pair("fused_smooth_yz", "smooth_yz", (1, 2), image,
                              certainty, sigma, spacing, truncate)


def smooth_xz_plain(image: torch.Tensor, certainty: torch.Tensor,
                    sigma: float, spacing: Sequence[float] = (1.0, 1.0, 1.0),
                    truncate: float = 4.5):
    """The x/z kernel's plain twin: (G_z G_x (c*image), G_z G_x c)."""
    return _smooth_pair_plain(image, certainty, (0, 2), sigma, spacing,
                              truncate)


def fused_smooth_xz(image: torch.Tensor, certainty: torch.Tensor,
                    sigma: float, spacing: Sequence[float] = (1.0, 1.0, 1.0),
                    truncate: float = 4.5):
    """(G_z G_x (c*image), G_z G_x c) with ZeroFluxNeumann boundaries, the
    certainty c used raw: per scale, the input of fused_features8_ys_multi.

    CUDA tensors (contiguous float32 of one shape) launch the kernel's x and
    z passes; CPU tensors run the plain twin; any other input raises.
    """
    if use_plain_twin("fused_smooth_xz", image):
        return smooth_xz_plain(image, certainty, sigma, spacing, truncate)
    return _fused_smooth_pair("fused_smooth_xz", "smooth_xz", (0, 2), image,
                              certainty, sigma, spacing, truncate)
