"""The last stage of the multi-scale features8 pass, every scale in one
launch: the CUDA kernel ``csrc/features8_ys_multi.cu`` and its plain PyTorch
twin.

Replaces ife_tpu/kernels/fused.py:fused_features8_ys_multi. Per scale, from
the numerator and denominator already smoothed along x and z
(kernels.normalized_conv.fused_smooth_xz): the y Gaussian of both, the
no-epsilon divide, the post-smoothing tail, masked by a select. ife_tpu
hands its kernel a band matrix per scale (ops/stencil.py _band_matrix, the
edge clamp folded into its first and last rows); the kernel here takes the
taps that matrix is made of (ops.stencil.smooth_taps) and clamps the index.
On the H100 its bytes (2 reads + 8 writes per voxel and scale) are a third
of its time; the rest is the FIR's arithmetic, the clamped loads and the
tail; see the source for the design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    MAX_SCALES, check_cuda_volume, launch, scale_taps_tensor, use_plain_twin,
)
from ife_tpu_torch.kernels.features8_post import features8_post_plain
from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
from ife_tpu_torch.kernels.normalized_conv import MAX_RADIUS
from ife_tpu_torch.ops.stencil import kernel_smooth_axis, smooth_taps


def features8_ys_multi_plain(nums, dens, mask: torch.Tensor, sigmas,
                             spacing: Sequence[float] = (1.0, 1.0, 1.0),
                             truncate: float = 4.5):
    """The kernel's plain twin: per scale the y pass of numerator and
    denominator (tap-ordered, edge-clamped), their divide, then the
    post-smoothing tail. A tuple of S tuples of eight (X, Y, Z) tensors."""
    hy = float(spacing[1])
    groups = []
    for num, den, sigma in zip(nums, dens, sigmas):
        s = (kernel_smooth_axis(num, 1, float(sigma), hy, truncate)
             / kernel_smooth_axis(den, 1, float(sigma), hy, truncate))
        groups.append(features8_post_plain(s, mask, spacing))
    return tuple(groups)


def fused_features8_ys_multi(nums, dens, mask: torch.Tensor, sigmas,
                             spacing: Sequence[float] = (1.0, 1.0, 1.0),
                             truncate: float = 4.5, stack: bool = True):
    """features8 at S scales from G_x G_z (mask*image) and G_x G_z mask per
    scale (`nums`, `dens`: sequences of S (X, Y, Z) tensors), the CLAMPED
    {0,1} `mask`, and the S `sigmas`: one pass for all scales. An
    (S, 8, X, Y, Z) tensor when stack, else a tuple of S tuples of eight.

    CUDA tensors (contiguous float32 of one shape) make ONE kernel launch;
    CPU tensors run the plain twin; any other input raises.
    """
    nums, dens = tuple(nums), tuple(dens)
    sigmas = tuple(float(s) for s in sigmas)
    S = len(nums)
    if S < 1 or not (S == len(dens) == len(sigmas)):
        raise ValueError("nums/dens/sigmas must have equal length >= 1")
    if use_plain_twin("fused_features8_ys_multi", nums[0]):
        groups = features8_ys_multi_plain(nums, dens, mask, sigmas, spacing,
                                          truncate)
        if stack:
            return torch.stack([torch.stack(g, 0) for g in groups], 0)
        return groups
    if S > MAX_SCALES:
        raise ValueError(f"fused_features8_ys_multi: {S} scales > "
                         f"{MAX_SCALES} per launch")
    volumes = [(f"nums[{i}]", v) for i, v in enumerate(nums)]
    volumes += [(f"dens[{i}]", v) for i, v in enumerate(dens)]
    volumes += [("mask", mask)]
    for name, t in volumes:
        check_cuda_volume(f"fused_features8_ys_multi {name}", t,
                          shape=nums[0].shape)
    per_scale = [smooth_taps(s, float(spacing[1]), float(truncate))
                 for s in sigmas]
    if max(r for _, r in per_scale) > MAX_RADIUS:
        raise ValueError(
            f"fused_features8_ys_multi: y radius > {MAX_RADIUS} voxels "
            f"(sigmas={sigmas}, spacing={tuple(spacing)})")
    dev = nums[0].device
    taps = scale_taps_tensor([t for t, _ in per_scale], dev)
    radii = (ctypes.c_int64 * S)(*(r for _, r in per_scale))
    X, Y, Z = nums[0].shape
    out = torch.empty((S, 8, X, Y, Z), dtype=nums[0].dtype, device=dev)
    launch("features8_ys_multi", dev,
           (ctypes.c_void_p * S)(*(v.data_ptr() for v in nums)),
           (ctypes.c_void_p * S)(*(v.data_ptr() for v in dens)), S,
           mask.data_ptr(), out.data_ptr(), X, Y, Z, taps.data_ptr(), radii,
           *stencil_reciprocals(spacing))
    # `taps` is freed when this returns; the caching allocator reuses the
    # block only in stream order, after the launch that reads it
    if stack:
        return out
    return tuple(tuple(g.unbind(0)) for g in out.unbind(0))
