"""The whole features8 pass as one line sweep: the CUDA kernels of
``csrc/features8_sweep.cu`` and ``csrc/features8_sweep_multi.cu``, and their
plain PyTorch twins.

Replaces ife_tpu/kernels/fused.py:fused_features8_sweep (image + mask -> the
8 channels: y, z and x smoothing passes, the no-epsilon divide, the tail)
and fused_features8_xs_stream (y/z-smoothed numerator and denominator +
mask -> the 8 channels: the x pass, the divide, the tail).

The sweep is bound on the H100 by the instructions its SMs issue, not by
memory (HBM sees the inputs once and the 8 channels written once). Its
design (csrc/sweep_passes.cuh) spends as few as it can per multiply-add: one
thread per cell of the smoothed region keeps the x pass's 2rx+1 planes in a
register queue (the x radius is a template parameter, rx <= SWEEP_MAX_RX; no
shared-memory ring), the y pass makes four outputs per walk over shared
memory, the next raw plane arrives by cp.async while this one is computed,
and a plane costs two barriers. A block sweeps only the planes of its chunk
on which its tile holds a voxel inside the mask and stores zeros elsewhere,
so the time follows the mask's coverage. The xs-stream kernel serves the x
radii beyond: its x ring (too long for a thread's registers) lives in shared
memory, with the next plane in flight by cp.async, on a tile chosen for the
most warps an SM holds at the radius, and it skips the planes and tails the
mask leaves empty as the sweep does.

``fused_features8_sweep_multi`` replaces
ife_tpu/kernels/fused.py:fused_features8_sweep_multi: S scales of the sweep
in one launch, the same threads running scale after scale on one raw plane
with every scale's x queue in registers. Each scale equals
fused_features8_sweep to the bit. What one launch takes is a register
budget (SWEEP_MULTI_CLASSES).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, scale_taps_tensor, use_plain_twin,
)
from ife_tpu_torch.kernels.features8_post import features8_post_plain
from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
from ife_tpu_torch.kernels.normalized_conv import MAX_RADIUS, smooth_yz_plain
from ife_tpu_torch.ops.stencil import kernel_smooth_axis, smooth_taps

# csrc/sweep_passes.cuh: the s region a block owns (its (y, z) tile plus a
# one-voxel halo), the shared memory a block may take, and the x radii the
# sweep is instantiated for (its x queue lives in registers)
_CELLS = (14 + 2) * (32 + 2)
_SY, _SZ = 14 + 2, 32 + 2
# csrc/features8_sweep.cu kXsMinTileY: the s region of the narrowest tile
# the xs-stream kernel is instantiated for (its launcher picks among tiles of
# 14, 8, 6 and 4 rows the one with the most warps an SM holds)
_XS_CELLS = (4 + 2) * (32 + 2)
_MAX_SMEM = 227 * 1024
SWEEP_MAX_RX = 10
# csrc/features8_sweep_multi.cu, the launcher's list: (class of the largest x radius,
# scales one launch takes in it); S * 2 * (2 * class + 1) <= 60 queue
# registers a thread
SWEEP_MULTI_CLASSES = ((2, 4), (4, 3), (7, 2), (10, 1))


def _ybuf_stride(rz: int) -> int:
    """csrc sweep_ybuf_stride: the padded row of the y pass buffer."""
    return _SZ + (2 * rz + 31) // 32 * 32


def sweep_smem_bytes(rx: int, ry: int, rz: int, smooth_yz: bool = True) -> int:
    """Shared memory of one block. The sweep (csrc sweep_smem_floats): two
    buffers of the extended raw plane (c*f and c), the y pass of both, three
    s planes; its x queue is in registers, so rx does not count. The
    xs-stream kernel (smooth_yz=False, csrc xs_stream_smem_floats) at its
    narrowest tile: the x ring of 2rx+2 numerator and denominator planes
    (the window of 2rx+1 and the plane in flight) and three s planes."""
    if not smooth_yz:
        return 4 * (2 * (2 * rx + 2) * _XS_CELLS + 3 * _XS_CELLS)
    return 4 * (4 * (_SY + 2 * ry) * (_SZ + 2 * rz)
                + 2 * _SY * _ybuf_stride(rz) + 3 * _CELLS)


def _radii(sigma, spacing, truncate):
    return [smooth_taps(float(sigma), float(h), float(truncate))[1]
            for h in spacing]


def sweep_fits(sigma: float, spacing: Sequence[float],
               truncate: float = 4.5) -> bool:
    """True when fused_features8_sweep takes this scale: the x radius among
    those the kernel is instantiated for (rx <= SWEEP_MAX_RX), every radius
    within the taps a launch carries, the block within shared memory."""
    r = _radii(sigma, spacing, truncate)
    return (r[0] <= SWEEP_MAX_RX and max(r) <= MAX_RADIUS
            and sweep_smem_bytes(*r) <= _MAX_SMEM)


def xs_stream_fits(sigma: float, spacing: Sequence[float],
                   truncate: float = 4.5) -> bool:
    """True when fused_features8_xs_stream takes this scale: its x ring
    within a block's shared memory at the narrowest tile (rx <= 69)."""
    rx = _radii(sigma, spacing, truncate)[0]
    return sweep_smem_bytes(rx, 0, 0, smooth_yz=False) <= _MAX_SMEM


def _check_plane(name: str, shape) -> None:
    """The sweeps keep a voxel's offset within its x plane in 32 bits."""
    if shape[1] * shape[2] >= 2 ** 31:
        raise ValueError(f"{name}: an x plane of {shape[1]} x {shape[2]} "
                         f"voxels is beyond 2^31")


def _c_taps(taps):
    return (ctypes.c_float * len(taps))(*taps), len(taps)


NO_FACE = 1 << 30  # a clamp of -NO_FACE / +NO_FACE: no true face on that side


def face_clamps(name: str, clamps, shape):
    """`clamps` as four Python ints [x_lo, x_hi, y_lo, y_hi] (None: the
    array's own faces, [0, X - 1, 0, Y - 1]). On a halo-extended shard block
    they are the kept core's faces on the sides that are true volume faces,
    and -/+NO_FACE where the halo holds a neighbour's data; the stencil's
    phantom clamps to the smoothed field there and nowhere else
    (csrc/s_ring.cuh FaceClamps). Host integers: nothing is read from the
    card."""
    if clamps is None:
        return [0, shape[0] - 1, 0, shape[1] - 1]
    if isinstance(clamps, torch.Tensor) and clamps.device.type != "cpu":
        raise ValueError(f"{name}: clamps must be host integers, got a "
                         f"tensor on {clamps.device}")
    vals = [int(v) for v in clamps]
    if len(vals) != 4 or max(abs(v) for v in vals) > NO_FACE:
        raise ValueError(f"{name}: clamps must be [x_lo, x_hi, y_lo, y_hi] "
                         f"within +-2^30, got {vals}")
    return vals


def features8_sweep_plain(image: torch.Tensor, mask: torch.Tensor,
                          sigma: float,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0),
                          truncate: float = 4.5, clamps=None):
    """The sweep kernel's plain twin: the normalized convolution with the
    clamped mask as certainty, smoothed along y, z, then x (the kernel's
    order), then the post-smoothing tail (polynomial eigen path) with its
    stencil clamped at `clamps` (face_clamps), masked by a select. Tuple of
    eight (X, Y, Z) tensors."""
    m = torch.clamp(mask.to(image.dtype), 0, 1)
    num, den = smooth_yz_plain(image, m, sigma, spacing, truncate)
    return features8_xs_stream_plain(num, den, m, sigma, spacing, truncate,
                                     clamps)


def fused_features8_sweep(image: torch.Tensor, mask: torch.Tensor,
                          sigma: float,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0),
                          truncate: float = 4.5, stack: bool = True,
                          clamps=None):
    """features8 of `image` at one scale in one pass; `mask` is clamped to
    [0, 1] (the certainty and, nonzero, the output mask). An (8, X, Y, Z)
    tensor when stack, else a tuple of eight.

    clamps: [x_lo, x_hi, y_lo, y_hi], the true faces of a halo-extended shard
    block (face_clamps); None is the whole volume.

    CUDA tensors (contiguous float32 of one shape) launch the kernel; CPU
    tensors run the plain twin; any other input raises.
    """
    faces = face_clamps("fused_features8_sweep", clamps, image.shape)
    if use_plain_twin("fused_features8_sweep", image):
        feats = features8_sweep_plain(image, mask, sigma, spacing, truncate,
                                      None if clamps is None else faces)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_sweep image", image)
    check_cuda_volume("fused_features8_sweep mask", mask, shape=image.shape)
    _check_plane("fused_features8_sweep", image.shape)
    if not sweep_fits(sigma, spacing, truncate):
        raise ValueError(
            f"fused_features8_sweep: sigma={sigma} at spacing "
            f"{tuple(spacing)} needs an x radius beyond {SWEEP_MAX_RX}, or "
            f"more taps or shared memory than a launch has (sweep_fits)")
    (tx, ntx), (ty, nty), (tz, ntz) = (
        _c_taps(smooth_taps(float(sigma), float(h), float(truncate))[0])
        for h in spacing)
    X, Y, Z = image.shape
    out = torch.empty((8, X, Y, Z), dtype=image.dtype, device=image.device)
    launch("features8_sweep", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), X, Y, Z,
           tx, ntx, ty, nty, tz, ntz, *faces, *stencil_reciprocals(spacing),
           count_as=None if clamps is None else "features8_sweep_clamps")
    return out if stack else tuple(out.unbind(0))


def features8_xs_stream_plain(num_yz: torch.Tensor, den_yz: torch.Tensor,
                              mask: torch.Tensor, sigma: float,
                              spacing: Sequence[float] = (1.0, 1.0, 1.0),
                              truncate: float = 4.5, clamps=None):
    """The xs-stream kernel's plain twin: the x pass of the y/z-smoothed
    numerator and denominator, their divide, then the post-smoothing tail
    (clamped at `clamps`, four ints, for the sweep's twin). Tuple of eight
    (X, Y, Z) tensors."""
    hx = float(spacing[0])
    s = (kernel_smooth_axis(num_yz, 0, sigma, hx, truncate)
         / kernel_smooth_axis(den_yz, 0, sigma, hx, truncate))
    faces = None if clamps is None else (clamps[:2], clamps[2:])
    return features8_post_plain(s, mask, spacing, faces=faces)


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


def sweep_multi_smem_bytes(radii) -> int:
    """Shared memory of one block of the multi-scale sweep (csrc
    sweep_multi_smem_floats) for `radii`, one (rx, ry, rz) per scale: every
    scale's taps, y pass buffer (at the largest z radius) and three s
    planes, then two buffers of the raw plane at the largest y and z
    radii."""
    ry = max(r[1] for r in radii)
    rz = max(r[2] for r in radii)
    floats = sum(2 * sum(r) + 3 for r in radii)
    floats += len(radii) * (2 * _SY * _ybuf_stride(rz) + 3 * _CELLS)
    floats += 4 * (_SY + 2 * ry) * (_SZ + 2 * rz)
    return 4 * floats


def sweep_multi_max_scales(rx_max: int) -> int:
    """The scales one fused_features8_sweep_multi launch takes when the
    largest x radius is `rx_max`: every scale's x queue, sized by the class
    of rx_max, must stay in a thread's registers (0 beyond SWEEP_MAX_RX)."""
    for cls, scales in SWEEP_MULTI_CLASSES:
        if rx_max <= cls:
            return scales
    return 0


def sweep_multi_fits(sigmas, spacing: Sequence[float],
                     truncate: float = 4.5) -> bool:
    """True when one fused_features8_sweep_multi launch takes this set of
    scales: no more of them than the register budget of their largest x
    radius allows (sweep_multi_max_scales), every radius within the taps a
    launch carries, the block within shared memory."""
    radii = [_radii(s, spacing, truncate) for s in sigmas]
    if not radii:
        return False
    return (len(radii) <= sweep_multi_max_scales(max(r[0] for r in radii))
            and max(max(r) for r in radii) <= MAX_RADIUS
            and sweep_multi_smem_bytes(radii) <= _MAX_SMEM)


def features8_sweep_multi_plain(image: torch.Tensor, mask: torch.Tensor,
                                sigmas,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                truncate: float = 4.5, clamps=None):
    """The multi-scale sweep's plain twin: features8_sweep_plain per scale.
    A tuple of S tuples of eight (X, Y, Z) tensors."""
    return tuple(features8_sweep_plain(image, mask, float(s), spacing,
                                       truncate, clamps) for s in sigmas)


def fused_features8_sweep_multi(image: torch.Tensor, mask: torch.Tensor,
                                sigmas,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                truncate: float = 4.5, stack: bool = True,
                                clamps=None):
    """features8 of `image` at the S scales `sigmas` in one pass that reads
    the image and the mask once; per scale exactly fused_features8_sweep. An
    (S, 8, X, Y, Z) tensor when stack, else a tuple of S tuples of eight.

    clamps: [x_lo, x_hi, y_lo, y_hi], the true faces of a halo-extended shard
    block (face_clamps), shared by every scale; None is the whole volume.

    CUDA tensors (contiguous float32 of one shape) make ONE kernel launch,
    or raise when the scale set does not fit one (sweep_multi_fits): there is
    no per-scale fallback. CPU tensors run the plain twin; any other input
    raises.
    """
    faces = face_clamps("fused_features8_sweep_multi", clamps, image.shape)
    sigmas = tuple(float(s) for s in sigmas)
    if not sigmas:
        raise ValueError("fused_features8_sweep_multi: no scale given")
    if use_plain_twin("fused_features8_sweep_multi", image):
        groups = features8_sweep_multi_plain(
            image, mask, sigmas, spacing, truncate,
            None if clamps is None else faces)
        if stack:
            return torch.stack([torch.stack(g, 0) for g in groups], 0)
        return groups
    check_cuda_volume("fused_features8_sweep_multi image", image)
    check_cuda_volume("fused_features8_sweep_multi mask", mask,
                      shape=image.shape)
    _check_plane("fused_features8_sweep_multi", image.shape)
    if not sweep_multi_fits(sigmas, spacing, truncate):
        raise ValueError(
            f"fused_features8_sweep_multi: sigmas={sigmas} at spacing "
            f"{tuple(spacing)} need more scales for their largest x radius, "
            f"more taps or more shared memory than one launch has "
            f"(sweep_multi_fits)")
    S = len(sigmas)
    per = [[smooth_taps(s, float(h), float(truncate)) for h in spacing]
           for s in sigmas]
    taps = scale_taps_tensor([t for scale in per for t, _ in scale],
                             image.device)
    radii = (ctypes.c_int64 * (3 * S))(*(r for scale in per for _, r in scale))
    X, Y, Z = image.shape
    out = torch.empty((S, 8, X, Y, Z), dtype=image.dtype, device=image.device)
    launch("features8_sweep_multi", image.device,
           image.data_ptr(), mask.data_ptr(), out.data_ptr(), X, Y, Z, S,
           taps.data_ptr(), radii, *faces, *stencil_reciprocals(spacing),
           count_as=(None if clamps is None
                     else "features8_sweep_multi_clamps"))
    # `taps` is freed when this returns; the caching allocator reuses the
    # block only in stream order, after the launch that reads it
    if stack:
        return out
    return tuple(tuple(g.unbind(0)) for g in out.unbind(0))
