"""The whole features8 pass as one line sweep: the CUDA kernel
``csrc/features8_sweep.cu`` in its two forms, and their plain PyTorch twins.

Replaces ife_tpu/kernels/fused.py:fused_features8_sweep (image + mask -> the
8 channels: y, z and x smoothing passes, the no-epsilon divide, the tail)
and fused_features8_xs_stream (y/z-smoothed numerator and denominator +
mask -> the 8 channels: the x pass, the divide, the tail). Bound on the H100
by shared-memory traffic and the x ring's size; HBM sees the inputs once and
the 8 channels written once. See the source for the design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, use_plain_twin,
)
from ife_tpu_torch.kernels.features8_post import features8_post_plain
from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
from ife_tpu_torch.kernels.normalized_conv import MAX_RADIUS, smooth_yz_plain
from ife_tpu_torch.ops.stencil import gaussian_smooth_axis, smooth_taps

# csrc/features8_sweep.cu: the s region a block owns (its (y, z) tile plus
# a one-voxel halo), and the shared memory a block may take
_CELLS = (14 + 2) * (32 + 2)
_SY, _SZ = 14 + 2, 32 + 2
_MAX_SMEM = 227 * 1024


def sweep_smem_bytes(rx: int, ry: int, rz: int, smooth_yz: bool = True) -> int:
    """Shared memory of one block (csrc sweep_smem_floats): the x ring of
    2rx+1 numerator and denominator planes, three s planes and, when the
    kernel smooths y and z itself, the extended input plane and its y
    pass."""
    floats = 2 * (2 * rx + 1) * _CELLS + 3 * _CELLS
    if smooth_yz:
        pz = _SZ + 2 * rz
        floats += 2 * (_SY + 2 * ry) * pz + 2 * _SY * pz
    return 4 * floats


def _radii(sigma, spacing, truncate):
    return [smooth_taps(float(sigma), float(h), float(truncate))[1]
            for h in spacing]


def sweep_fits(sigma: float, spacing: Sequence[float],
               truncate: float = 4.5) -> bool:
    """True when fused_features8_sweep takes this scale: every radius
    within the taps a launch carries, the block within shared memory."""
    r = _radii(sigma, spacing, truncate)
    return max(r) <= MAX_RADIUS and sweep_smem_bytes(*r) <= _MAX_SMEM


def xs_stream_fits(sigma: float, spacing: Sequence[float],
                   truncate: float = 4.5) -> bool:
    """True when fused_features8_xs_stream takes this scale (its x ring
    within shared memory)."""
    rx = _radii(sigma, spacing, truncate)[0]
    return sweep_smem_bytes(rx, 0, 0, smooth_yz=False) <= _MAX_SMEM


def _c_taps(taps):
    return (ctypes.c_float * len(taps))(*taps), len(taps)


def features8_sweep_plain(image: torch.Tensor, mask: torch.Tensor,
                          sigma: float,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0),
                          truncate: float = 4.5):
    """The sweep kernel's plain twin: the normalized convolution with the
    clamped mask as certainty, smoothed along y, z, then x (the kernel's
    order), then the post-smoothing tail (polynomial eigen path), masked by
    a select. Tuple of eight (X, Y, Z) tensors."""
    m = torch.clamp(mask.to(image.dtype), 0, 1)
    num, den = smooth_yz_plain(image, m, sigma, spacing, truncate)
    return features8_xs_stream_plain(num, den, m, sigma, spacing, truncate)


def fused_features8_sweep(image: torch.Tensor, mask: torch.Tensor,
                          sigma: float,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0),
                          truncate: float = 4.5, stack: bool = True):
    """features8 of `image` at one scale in one pass; `mask` is clamped to
    [0, 1] (the certainty and, nonzero, the output mask). An (8, X, Y, Z)
    tensor when stack, else a tuple of eight.

    CUDA tensors (contiguous float32 of one shape) launch the kernel; CPU
    tensors run the plain twin; any other input raises.
    """
    if use_plain_twin("fused_features8_sweep", image):
        feats = features8_sweep_plain(image, mask, sigma, spacing, truncate)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_sweep image", image)
    check_cuda_volume("fused_features8_sweep mask", mask, shape=image.shape)
    if not sweep_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_sweep: sigma={sigma} at spacing "
            f"{tuple(spacing)} needs more taps or shared memory than a "
            f"launch has (sweep_fits)")
    (tx, ntx), (ty, nty), (tz, ntz) = (
        _c_taps(smooth_taps(float(sigma), float(h), float(truncate))[0])
        for h in spacing)
    X, Y, Z = image.shape
    out = torch.empty((8, X, Y, Z), dtype=image.dtype, device=image.device)
    launch("features8_sweep", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), X, Y, Z,
           tx, ntx, ty, nty, tz, ntz, *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))


def features8_xs_stream_plain(num_yz: torch.Tensor, den_yz: torch.Tensor,
                              mask: torch.Tensor, sigma: float,
                              spacing: Sequence[float] = (1.0, 1.0, 1.0),
                              truncate: float = 4.5):
    """The xs-stream kernel's plain twin: the x pass of the y/z-smoothed
    numerator and denominator, their divide, then the post-smoothing tail.
    Tuple of eight (X, Y, Z) tensors."""
    hx = float(spacing[0])
    s = (gaussian_smooth_axis(num_yz, 0, sigma, hx, truncate)
         / gaussian_smooth_axis(den_yz, 0, sigma, hx, truncate))
    return features8_post_plain(s, mask, spacing)


def fused_features8_xs_stream(num_yz: torch.Tensor, den_yz: torch.Tensor,
                              mask: torch.Tensor, sigma: float,
                              spacing: Sequence[float] = (1.0, 1.0, 1.0),
                              truncate: float = 4.5, stack: bool = True):
    """features8 from G_z G_y (mask*image) and G_z G_y mask: the x pass,
    the no-epsilon divide and the tail in one pass. `mask` is the CLAMPED
    {0,1} mask. An (8, X, Y, Z) tensor when stack, else a tuple of eight.

    CUDA tensors (contiguous float32 of one shape) launch the kernel; CPU
    tensors run the plain twin; any other input raises.
    """
    if use_plain_twin("fused_features8_xs_stream", num_yz):
        feats = features8_xs_stream_plain(num_yz, den_yz, mask, sigma,
                                          spacing, truncate)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_xs_stream num_yz", num_yz)
    for name, t in (("den_yz", den_yz), ("mask", mask)):
        check_cuda_volume(f"fused_features8_xs_stream {name}", t,
                          shape=num_yz.shape)
    if not xs_stream_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_xs_stream: sigma={sigma} at spacing "
            f"{tuple(spacing)} needs more shared memory than a launch has "
            f"(xs_stream_fits)")
    tx, ntx = _c_taps(smooth_taps(float(sigma), float(spacing[0]),
                                  float(truncate))[0])
    X, Y, Z = num_yz.shape
    out = torch.empty((8, X, Y, Z), dtype=num_yz.dtype, device=num_yz.device)
    launch("features8_xs_stream", num_yz.device,
           num_yz.data_ptr(), den_yz.data_ptr(), mask.data_ptr(),
           out.data_ptr(), X, Y, Z, tx, ntx, *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))
