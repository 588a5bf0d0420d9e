"""The post-smoothing features8 pass: the CUDA kernel
``csrc/features8_post.cu`` and its plain PyTorch twin.

Replaces ife_tpu/kernels/fused.py:fused_features8_post_stream (plain mode).
Smoothed volume + mask -> the 8 masked channels [s, |grad s|, e1, e2, e3,
LoG, GaussianCurvature, FrobeniusNorm]. Bound by bytes on the H100 (2 reads
+ 8 writes of f32 per voxel); see the source for the design.

``fused_features8_post`` replaces ife_tpu/kernels/fused.py:fused_features8_post,
the 2-D-grid form of the same pass: its own kernel in the same source, in
which a thread block owns ``block`` = (bx, by) planes and rows and marches
along x with the planes behind it in registers. Same twin, same result.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, use_plain_twin,
)
from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
from ife_tpu_torch.ops.eigen import eigenvalue_feature_channels
from ife_tpu_torch.ops.stencil import gradient_magnitude, hessian


def features8_post_plain(s: torch.Tensor, m: torch.Tensor,
                         spacing: Sequence[float] = (1.0, 1.0, 1.0)):
    """The kernel's plain twin: gradient magnitude, Hessian, eigen features
    on the polynomial no-diagonal path, all zeroed where m == 0 with a
    select (s may be NaN there). Tuple of eight (X, Y, Z) tensors."""
    gm = gradient_magnitude(s, spacing)
    H = hessian(s, spacing)
    feats = eigenvalue_feature_channels(*H.unbind(-1), use_trig=False,
                                        diag_path=False)
    inside = m != 0
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return tuple(torch.where(inside, v, zero) for v in (s, gm, *feats))


def fused_features8_post_stream(s: torch.Tensor, m: torch.Tensor,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                stack: bool = True):
    """Smoothed volume s + mask m (nonzero = inside) -> the 8 masked feature
    channels: an (8, X, Y, Z) tensor when stack, else a tuple of eight.

    CUDA tensors (contiguous float32, m of s's shape) launch the kernel; CPU
    tensors run the plain twin; any other input raises.
    """
    if use_plain_twin("fused_features8_post_stream", s):
        feats = features8_post_plain(s, m, spacing)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_post_stream s", s)
    check_cuda_volume("fused_features8_post_stream m", m, shape=s.shape)
    X, Y, Z = s.shape
    out = torch.empty((8, X, Y, Z), dtype=s.dtype, device=s.device)
    launch("features8_post", s.device,
           s.data_ptr(), m.data_ptr(), out.data_ptr(), X, Y, Z,
           *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))


def fused_features8_post(s: torch.Tensor, m: torch.Tensor,
                         spacing: Sequence[float] = (1.0, 1.0, 1.0),
                         block=(8, 128), stack: bool = True,
                         pre_padded: bool = False):
    """fused_features8_post_stream's function through the windowed kernel:
    a thread block owns `block` = (bx, by) x planes and y rows (one int for
    both) of its z strip. An (8, X, Y, Z) tensor when stack, else a tuple of
    eight.

    pre_padded (s carrying a boundary layer of a halo-extended shard block)
    is not yet ported: it comes with the sharded path.

    CUDA tensors (contiguous float32, m of s's shape) launch the kernel; CPU
    tensors run the plain twin; any other input raises.
    """
    if pre_padded:
        raise NotImplementedError(
            "fused_features8_post(pre_padded=True) is not yet ported: it "
            "serves the sharded path (ife_tpu.parallel)")
    bx, by = (block, block) if isinstance(block, int) else block
    if min(int(bx), int(by)) < 1:
        raise ValueError(f"fused_features8_post: block must be >= 1, got {block}")
    if use_plain_twin("fused_features8_post", s):
        feats = features8_post_plain(s, m, spacing)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_features8_post s", s)
    check_cuda_volume("fused_features8_post m", m, shape=s.shape)
    X, Y, Z = s.shape
    out = torch.empty((8, X, Y, Z), dtype=s.dtype, device=s.device)
    launch("features8_post_windowed", s.device,
           s.data_ptr(), m.data_ptr(), out.data_ptr(), X, Y, Z, int(bx),
           int(by), *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))
