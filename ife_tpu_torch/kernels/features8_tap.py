"""The windowed features8 kernels ``csrc/features8_tap.cu`` and their plain
PyTorch twins.

``fused_features8_tap`` replaces ife_tpu/kernels/fused.py:fused_features8_tap:
the whole features8 pass in one launch from the raw image and mask, every
thread block smoothing its own halo window along x, then y, then z.
``fused_features8_xs`` replaces ife_tpu/kernels/fused.py:fused_features8_xs:
the y and z passes outside (fused_smooth_yz), then one kernel with the x pass
over a block's window, the divide and the tail.

Both are direct entries that nothing dispatches, as in ife_tpu: the sweep
kernel computes the same function without re-reading halos. A block's window
must fit its shared memory; beyond ``tap_fits`` / ``xs_fits`` the wrappers
raise. See the source for the design and what bounds them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import check_cuda_volume, launch, use_plain_twin
from ife_tpu_torch.kernels.features8_post import features8_post_plain
from ife_tpu_torch.kernels.features8_sweep import (
    _MAX_SMEM, _c_taps, _radii, features8_sweep_plain,
)
from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
from ife_tpu_torch.kernels.normalized_conv import MAX_RADIUS, fused_smooth_yz
from ife_tpu_torch.ops.stencil import normalized_gaussian_convolution, smooth_taps

# csrc/features8_tap.cu: the s region of a block is its core plus a one-voxel
# halo, (8 + 2) x (8 + 2) x (32 + 2) for tap and (16 + 2) planes for xs
_SY, _SZ = 8 + 2, 32 + 2
_TAP_SX, _XS_SX = 8 + 2, 16 + 2


def tap_smem_bytes(rx: int, ry: int, rz: int) -> int:
    """Shared memory of one tap block (csrc tap_smem_floats): the raw window,
    the x pass's output, the smoothed numerator and denominator."""
    wyz = (_SY + 2 * ry) * (_SZ + 2 * rz)
    return 4 * ((_TAP_SX + 2 * rx) * wyz + _TAP_SX * wyz
                + 2 * _TAP_SX * _SY * _SZ)


def tap_fits(sigma: float, spacing: Sequence[float],
             truncate: float = 4.5) -> bool:
    """True when fused_features8_tap takes this scale: its window within a
    block's 227 KB of shared memory, which at equal radii is r <= 8 voxels
    (sigma <= 1.77 voxels at truncate 4.5; r = 9 needs 243 KB)."""
    r = _radii(sigma, spacing, truncate)
    return max(r) <= MAX_RADIUS and tap_smem_bytes(*r) <= _MAX_SMEM


def xs_smem_bytes(rx: int) -> int:
    """Shared memory of one xs block (csrc xs_smem_floats): the two x windows
    and the s region."""
    return 4 * (2 * (_XS_SX + 2 * rx) + _XS_SX) * _SY * _SZ


def xs_fits(sigma: float, spacing: Sequence[float],
            truncate: float = 4.5) -> bool:
    """True when fused_features8_xs takes this scale: the y and z radii within
    the taps a launch carries, the x window within shared memory, which is
    rx <= 29 voxels (rx = 30 needs 231 KB)."""
    r = _radii(sigma, spacing, truncate)
    return max(r) <= MAX_RADIUS and xs_smem_bytes(r[0]) <= _MAX_SMEM


def features8_tap_plain(image: torch.Tensor, mask: torch.Tensor, sigma: float,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        truncate: float = 4.5):
    """The tap kernel's plain twin: the normalized convolution with the
    clamped mask as certainty, smoothed along x, y, then z (the kernel's
    order), then the post-smoothing tail, masked by a select. Tuple of eight
    (X, Y, Z) tensors."""
    m = torch.clamp(mask.to(image.dtype), 0, 1)
    s = normalized_gaussian_convolution(image, m, sigma, spacing, truncate)
    return features8_post_plain(s, m, spacing)


# the xs kernel's plain twin smooths y, z, then x, divides and runs the tail:
# the sweep's twin
features8_xs_plain = features8_sweep_plain


def fused_features8_tap(image: torch.Tensor, mask: torch.Tensor, sigma: float,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        truncate: float = 4.5, stack: bool = True):
    """features8 of `image` at one scale in one launch, each thread block on
    its own halo window; `mask` is clamped to [0, 1] (the certainty and,
    nonzero, the output mask). An (8, X, Y, Z) tensor when stack, else a
    tuple of eight.

    CUDA tensors (contiguous float32 of one shape) launch the kernel, or
    raise when the window does not fit (tap_fits); CPU tensors run the plain
    twin; any other input raises.
    """
    if use_plain_twin("fused_features8_tap", image):
        feats = features8_tap_plain(image, mask, sigma, spacing, truncate)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_tap image", image)
    check_cuda_volume("fused_features8_tap mask", mask, shape=image.shape)
    if not tap_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_tap: sigma={sigma} at spacing {tuple(spacing)} "
            f"needs a window beyond a block's shared memory (tap_fits)")
    (tx, ntx), (ty, nty), (tz, ntz) = (
        _c_taps(smooth_taps(float(sigma), float(h), float(truncate))[0])
        for h in spacing)
    X, Y, Z = image.shape
    out = torch.empty((8, X, Y, Z), dtype=image.dtype, device=image.device)
    launch("features8_tap", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), X, Y, Z,
           tx, ntx, ty, nty, tz, ntz, *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))


def fused_features8_xs(image: torch.Tensor, mask: torch.Tensor, sigma: float,
                       spacing: Sequence[float] = (1.0, 1.0, 1.0),
                       truncate: float = 4.5, stack: bool = True):
    """features8 of `image` at one scale: the y and z passes of mask*image
    and the mask (fused_smooth_yz), then one launch with the x pass over each
    block's window, the divide and the tail; `mask` is clamped to [0, 1]. An
    (8, X, Y, Z) tensor when stack, else a tuple of eight.

    CUDA tensors (contiguous float32 of one shape) launch the kernels, or
    raise when the x window does not fit (xs_fits); CPU tensors run the plain
    twin; any other input raises.
    """
    if use_plain_twin("fused_features8_xs", image):
        feats = features8_xs_plain(image, mask, sigma, spacing, truncate)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_xs image", image)
    check_cuda_volume("fused_features8_xs mask", mask, shape=image.shape)
    if not xs_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_xs: sigma={sigma} at spacing {tuple(spacing)} "
            f"needs a window beyond a block's shared memory (xs_fits)")
    m = torch.clamp(mask, 0, 1)
    num, den = fused_smooth_yz(image, m, sigma, spacing, truncate)
    tx, ntx = _c_taps(smooth_taps(float(sigma), float(spacing[0]),
                                  float(truncate))[0])
    X, Y, Z = image.shape
    out = torch.empty((8, X, Y, Z), dtype=image.dtype, device=image.device)
    launch("features8_xs", image.device,
           num.data_ptr(), den.data_ptr(), m.data_ptr(), out.data_ptr(),
           X, Y, Z, tx, ntx, *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))
