"""The direct features8 entries ``csrc/features8_tap.cu`` and their plain
PyTorch twins.

``fused_features8_tap`` replaces ife_tpu/kernels/fused.py:fused_features8_tap:
the whole features8 pass in one launch from the raw image and mask, smoothed
along x, then y, then z. The kernel sweeps y, the axis of the middle pass:
a block owns an (x, z) tile of 14 x 32 voxels and a chunk of y rows; per row
it loads image and mask once (``cp.async``), runs the x pass into a ring of
2ry + 1 x-pass rows in shared memory, sums the ring for the y pass, runs the
z pass, divides and emits the row before through the shared tail. Rows of a
chunk on which the tile holds no voxel inside the mask are zeros and are not
swept.
``fused_features8_xs`` replaces ife_tpu/kernels/fused.py:fused_features8_xs:
the y and z passes outside (fused_smooth_yz), then one kernel in which each
thread walks its own column of the y/z-smoothed inputs along x from global
memory, divides into 18 s planes in shared memory, and the block emits 16
planes through the tail; a block with no voxel inside the mask stores zeros.

``fused_features8_tap(..., variant="copyfloor")`` is the tap's roofline
probe (ife_tpu/kernels/fused.py:638-645): the tap's row loads at the
scale's radii, then channel k of the core written as m + k (k even) or
image*m + k (k odd), m the clamped mask; counted as features8_tap_copyfloor.

Both are direct entries that nothing dispatches, as in ife_tpu: the sweep
kernel computes the same function. The tap's block keeps its ring of x-pass
rows in shared memory where it fits (``tap_smem_bytes``: r <= 11 voxels at
equal radii) and in global scratch beyond (``tap_ring_scratch_floats``), up
to r <= 44; xs takes every radius a launch's taps carry. Beyond ``tap_fits``
/ ``xs_fits`` the wrappers raise. See the source for the design and what
bounds them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import check_cuda_volume, launch, use_plain_twin
from ife_tpu_torch.kernels.features8_post import features8_post_plain
from ife_tpu_torch.kernels.features8_sweep import (
    _CELLS, _MAX_SMEM, _SY, _SZ, _c_taps, _radii, _ybuf_stride,
    features8_sweep_plain,
)
from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
from ife_tpu_torch.kernels.normalized_conv import (
    MAX_RADIUS, fused_smooth_yz, normalized_conv_plain,
)
from ife_tpu_torch.ops.stencil import smooth_taps

# csrc/features8_tap.cu: the tap's (x, z) tile and the xs kernel's (y, z)
# tile are the sweep's (its s region _SY x _SZ); the xs kernel computes
# 16 + 2 s planes a block
_XS_SX = 16 + 2


def _tap_base_bytes(rx: int, rz: int) -> int:
    """csrc tap_base_floats, in bytes: two raw rows of c*f and c on
    (16 + 2rx) x (34 + 2rz) cells, the y pass of both and three s rows."""
    return 4 * (4 * (_SY + 2 * rx) * (_SZ + 2 * rz) + 2 * _SY * _ybuf_stride(rz)
                + 3 * _CELLS)


def _tap_ring_floats(ry: int, rz: int) -> int:
    """csrc tap_ring_floats: the ring of 2ry + 1 x-pass rows of both fields
    on 16 x (34 + 2rz) cells."""
    return (2 * ry + 1) * 2 * _SY * (_SZ + 2 * rz)


def tap_smem_bytes(rx: int, ry: int, rz: int) -> int:
    """Shared memory of one tap block with its ring: _tap_base_bytes and
    the ring. Beyond a block's 227 KB the ring goes to global scratch
    (tap_ring_scratch_floats) and the block keeps the rest."""
    return _tap_base_bytes(rx, rz) + 4 * _tap_ring_floats(ry, rz)


def tap_ring_scratch_floats(shape: Sequence[int], rx: int, ry: int,
                            rz: int) -> int:
    """Floats of global scratch a tap launch on `shape` needs for its rings:
    0 when the ring fits shared memory beside the block's other buffers,
    else one ring for each block of the grid (csrc ife_features8_tap: Z / 32
    by X / 14 by Y / chunk blocks, rounded up, a chunk of
    min(Y, max(128, 32 (ry + 1))) rows)."""
    if tap_smem_bytes(rx, ry, rz) <= _MAX_SMEM:
        return 0
    X, Y, Z = shape
    chunk = min(Y, max(128, 32 * (ry + 1)))
    blocks = -(-Z // (_SZ - 2)) * -(-X // (_SY - 2)) * -(-Y // chunk)
    return _tap_ring_floats(ry, rz) * blocks


def tap_fits(sigma: float, spacing: Sequence[float],
             truncate: float = 4.5) -> bool:
    """True when fused_features8_tap takes this scale: the block's raw rows,
    y pass and s rows within 227 KB of shared memory (its ring there too up
    to r = 11 at equal radii, in global scratch beyond), which at equal
    radii is r <= 44 voxels (sigma below 9.9 voxels at truncate 4.5), and
    every scale it took with a whole window in shared memory (r <= 8 at
    equal radii; ry up to 32 beside small rx, rz)."""
    r = _radii(sigma, spacing, truncate)
    return max(r) <= MAX_RADIUS and _tap_base_bytes(r[0], r[2]) <= _MAX_SMEM


def xs_smem_bytes() -> int:
    """Shared memory of one xs block (csrc xs_smem_floats): its 18 s planes
    of 16 x 34 cells, whatever the radius (the x pass runs from global
    memory)."""
    return 4 * _XS_SX * _CELLS


def xs_fits(sigma: float, spacing: Sequence[float],
            truncate: float = 4.5) -> bool:
    """True when fused_features8_xs takes this scale: every radius within
    the taps a launch carries (MAX_RADIUS, 128 voxels)."""
    return max(_radii(sigma, spacing, truncate)) <= MAX_RADIUS


def features8_tap_plain(image: torch.Tensor, mask: torch.Tensor, sigma: float,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        truncate: float = 4.5):
    """The tap kernel's plain twin: the normalized convolution with the
    clamped mask as certainty, smoothed along x, y, then z (the kernel's
    order), then the post-smoothing tail, masked by a select. Tuple of eight
    (X, Y, Z) tensors."""
    m = torch.clamp(mask.to(image.dtype), 0, 1)
    s = normalized_conv_plain(image, m, sigma, spacing, truncate)
    return features8_post_plain(s, m, spacing)


def features8_tap_copyfloor_plain(image: torch.Tensor, mask: torch.Tensor):
    """The tap copy floor's plain twin: m + k for even k, image*m + k for odd
    k, k = 0..7, with m the mask clamped to [0, 1]. Tuple of eight."""
    m = torch.clamp(mask.to(image.dtype), 0, 1)
    num = image * m
    return tuple((num if k % 2 else m) + float(k) for k in range(8))


# the xs kernel's plain twin smooths y, z, then x, divides and runs the tail:
# the sweep's twin
features8_xs_plain = features8_sweep_plain


def fused_features8_tap(image: torch.Tensor, mask: torch.Tensor, sigma: float,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        truncate: float = 4.5, stack: bool = True,
                        variant: str = "features"):
    """features8 of `image` at one scale in one launch, smoothed x, y, z in
    a sweep along y; `mask` is clamped to [0, 1] (the certainty and,
    nonzero, the output mask). An (8, X, Y, Z) tensor when stack, else a
    tuple of eight.

    variant: "features" (the default), or "copyfloor", the roofline probe:
    the same row loads at this scale, and channel k written as m + k (k
    even) or image*m + k (k odd), m the clamped mask. ife_tpu's "concat"
    and "roll" are Mosaic lane-shift choices with the same outputs and raise
    here, like any other value.

    CUDA tensors (contiguous float32 of one shape) launch the kernel, or
    raise when its block does not fit (tap_fits); CPU tensors run the plain
    twin; any other input raises.
    """
    if variant not in ("features", "copyfloor"):
        raise ValueError("fused_features8_tap: variant must be 'features' or "
                         f"'copyfloor', got {variant!r}")
    copy_floor = variant == "copyfloor"
    if use_plain_twin("fused_features8_tap", image):
        feats = (features8_tap_copyfloor_plain(image, mask) if copy_floor else
                 features8_tap_plain(image, mask, sigma, spacing, truncate))
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_tap image", image)
    check_cuda_volume("fused_features8_tap mask", mask, shape=image.shape)
    if not tap_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_tap: sigma={sigma} at spacing {tuple(spacing)} "
            f"needs a block beyond its shared memory (tap_fits)")
    (tx, ntx), (ty, nty), (tz, ntz) = (
        _c_taps(smooth_taps(float(sigma), float(h), float(truncate))[0])
        for h in spacing)
    X, Y, Z = image.shape
    out = torch.empty((8, X, Y, Z), dtype=image.dtype, device=image.device)
    n_scratch = 0 if copy_floor else tap_ring_scratch_floats(
        image.shape, *_radii(sigma, spacing, truncate))
    scratch = torch.empty(n_scratch, dtype=image.dtype, device=image.device)
    launch("features8_tap", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), X, Y, Z,
           tx, ntx, ty, nty, tz, ntz, *stencil_reciprocals(spacing),
           int(copy_floor), scratch.data_ptr() if n_scratch else None,
           n_scratch,
           count_as="features8_tap_copyfloor" if copy_floor else None)
    return out if stack else tuple(out.unbind(0))


def fused_features8_xs(image: torch.Tensor, mask: torch.Tensor, sigma: float,
                       spacing: Sequence[float] = (1.0, 1.0, 1.0),
                       truncate: float = 4.5, stack: bool = True):
    """features8 of `image` at one scale: the y and z passes of mask*image
    and the mask (fused_smooth_yz), then one launch with the x pass down each
    thread's column, the divide and the tail; `mask` is clamped to [0, 1]. An
    (8, X, Y, Z) tensor when stack, else a tuple of eight.

    CUDA tensors (contiguous float32 of one shape) launch the kernels, or
    raise beyond the taps a launch carries (xs_fits); CPU tensors run the
    plain twin; any other input raises.
    """
    if use_plain_twin("fused_features8_xs", image):
        feats = features8_xs_plain(image, mask, sigma, spacing, truncate)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_xs image", image)
    check_cuda_volume("fused_features8_xs mask", mask, shape=image.shape)
    if not xs_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_xs: sigma={sigma} at spacing {tuple(spacing)} "
            f"needs more taps than a launch carries (xs_fits)")
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
