"""Normalized Gaussian convolution G*(c*f) / G*c: the CUDA kernel
``csrc/normalized_conv.cu`` and its plain PyTorch twin.

Replaces ife_tpu/kernels/fused.py:fused_normalized_conv_sweep. Three
separable passes (x, y, z) over numerator and denominator with edge-clamped
taps, the certainty used raw, the divide without epsilon. Bound by bytes
and, at large radii, by L2 bandwidth; see the source for the design.

``fused_smooth_yz`` runs the y and z passes alone, the input of the
features8_xs_stream kernel (where ife_tpu/kernels/fused.py:fused_features8
smooths y and z with XLA band einsums).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, use_plain_twin,
)
from ife_tpu_torch.ops.stencil import (
    gaussian_smooth_axis, normalized_gaussian_convolution, smooth_taps,
)

MAX_RADIUS = 128  # csrc/normalized_conv.cu kMaxTaps = 2 * 128 + 1
MAX_Z = 232448 // 8  # the z pass stages two float rows in <= 227 KB of shared memory


def normalized_conv_plain(image: torch.Tensor, certainty: torch.Tensor,
                          sigma: float,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0),
                          truncate: float = 4.5) -> torch.Tensor:
    """The kernel's plain twin: ops.stencil.normalized_gaussian_convolution
    (tap-ordered shifted-slice sums along x, y, z; no epsilon)."""
    return normalized_gaussian_convolution(image, certainty, sigma, spacing,
                                           truncate)


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
    check_cuda_volume("fused_normalized_conv_sweep image", image)
    check_cuda_volume("fused_normalized_conv_sweep mask", mask,
                      shape=image.shape)
    X, Y, Z = image.shape
    if Z > MAX_Z:
        raise ValueError(f"fused_normalized_conv_sweep: Z={Z} > {MAX_Z}")
    per_axis = [smooth_taps(float(sigma), float(h), float(truncate))
                for h in spacing]
    if max(r for _, r in per_axis) > MAX_RADIUS:
        raise ValueError(
            f"fused_normalized_conv_sweep: radius > {MAX_RADIUS} voxels "
            f"(sigma={sigma}, spacing={tuple(spacing)})")
    (tx, ntx), (ty, nty), (tz, ntz) = (_c_taps(t) for t, _ in per_axis)
    out = torch.empty_like(image)
    s1 = torch.empty_like(image)
    s2 = torch.empty_like(image)
    launch("normalized_conv", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), s1.data_ptr(),
           s2.data_ptr(), X, Y, Z, tx, ntx, ty, nty, tz, ntz)
    # the launch is asynchronous: the scratch must outlive it. The caching
    # allocator reuses freed blocks only in stream order, so dropping s1/s2
    # here is safe on the current stream.
    return out


def smooth_yz_plain(image: torch.Tensor, certainty: torch.Tensor,
                    sigma: float, spacing: Sequence[float] = (1.0, 1.0, 1.0),
                    truncate: float = 4.5):
    """The y/z kernel's plain twin: (G_z G_y (c*image), G_z G_y c)."""
    c = certainty.to(image.dtype)

    def yz(v):
        v = gaussian_smooth_axis(v, 1, sigma, float(spacing[1]), truncate)
        return gaussian_smooth_axis(v, 2, sigma, float(spacing[2]), truncate)

    return yz(image * c), yz(c)


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
    check_cuda_volume("fused_smooth_yz image", image)
    check_cuda_volume("fused_smooth_yz certainty", certainty,
                      shape=image.shape)
    X, Y, Z = image.shape
    if Z > MAX_Z:
        raise ValueError(f"fused_smooth_yz: Z={Z} > {MAX_Z}")
    per_axis = [smooth_taps(float(sigma), float(h), float(truncate))
                for h in spacing[1:]]
    if max(r for _, r in per_axis) > MAX_RADIUS:
        raise ValueError(f"fused_smooth_yz: radius > {MAX_RADIUS} voxels "
                         f"(sigma={sigma}, spacing={tuple(spacing)})")
    (ty, nty), (tz, ntz) = (_c_taps(t) for t, _ in per_axis)
    num = torch.empty_like(image)
    den = torch.empty_like(image)
    launch("smooth_yz", image.device,
           image.data_ptr(), certainty.data_ptr(), num.data_ptr(),
           den.data_ptr(), X, Y, Z, ty, nty, tz, ntz)
    return num, den
