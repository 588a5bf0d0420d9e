"""The post-smoothing features8 pass: the CUDA kernel
``csrc/features8_post.cu`` and its plain PyTorch twin.

Replaces ife_tpu/kernels/fused.py:fused_features8_post_stream, with its
shard modes x_halo and pre_padded.
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
from ife_tpu_torch.kernels.hessian_eig import (
    halo_rows, stencil_mode, stencil_reciprocals, with_shard_halo,
)
from ife_tpu_torch.ops.eigen import eigenvalue_feature_channels
from ife_tpu_torch.ops.stencil import gradient_magnitude, hessian


def features8_post_plain(s: torch.Tensor, m: torch.Tensor,
                         spacing: Sequence[float] = (1.0, 1.0, 1.0),
                         x_halo=None, pre_padded: bool = False, faces=None):
    """The kernel's plain twin: gradient magnitude, Hessian, eigen features
    on the polynomial no-diagonal path, all zeroed where m == 0 with a
    select (s may be NaN there). Tuple of eight tensors of the shape of m,
    the core's.

    x_halo / pre_padded: the kernel's shard modes (with_shard_halo). faces:
    ((x_lo, x_hi), (y_lo, y_hi)), the true faces at which the stencil clamps
    on a halo-extended block (ops.stencil.derivative's `face`), the mode of
    the sweep kernels."""
    fc = (None, None, None) if faces is None else (*faces, None)

    def plain(v):
        gm = gradient_magnitude(v, spacing, fc)
        H = hessian(v, spacing, fc)
        return (v, gm, *eigenvalue_feature_channels(
            *H.unbind(-1), use_trig=False, diag_path=False))

    chans = with_shard_halo(plain, s, x_halo, pre_padded)
    inside = m != 0
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return tuple(torch.where(inside, v, zero) for v in chans)


def _post_core(name, s, m, x_halo, mode):
    """Checks of a post launch; returns (X, Y, Z) of the core and the halo
    rows' pointers."""
    check_cuda_volume(f"{name} s", s)
    X, Y, Z = s.shape
    lo = hi = None
    if mode == 1:
        lo, hi = (h.contiguous() for h in halo_rows(name, x_halo, s.shape, s))
    elif mode == 2:
        X, Y = X - 2, Y - 2
        if min(X, Y) < 1:
            raise ValueError(f"{name}: pre_padded needs a core of >= 1 voxel, "
                             f"got a block of {tuple(s.shape)}")
    check_cuda_volume(f"{name} m", m, shape=(X, Y, Z))
    return (X, Y, Z), lo, hi


def fused_features8_post_stream(s: torch.Tensor, m: torch.Tensor,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0),
                                stack: bool = True, pre_padded: bool = False,
                                x_halo=None):
    """Smoothed volume s + mask m (nonzero = inside) -> the 8 masked feature
    channels: an (8, X, Y, Z) tensor when stack, else a tuple of eight.

    x_halo: a ((1, Y, Z), (1, Y, Z)) pair, the rows -1 and X of s (a
    neighbouring shard's rows), read at the x faces instead of clamping.
    pre_padded: s is (X + 2, Y + 2, Z), the (X, Y, Z) core of m and a
    one-voxel boundary layer on x and y; the core alone is computed and
    written. The two exclude each other.

    CUDA tensors (contiguous float32) launch the kernel; CPU tensors run the
    plain twin; any other input raises.
    """
    name = "fused_features8_post_stream"
    mode = stencil_mode(name, x_halo, pre_padded)
    if use_plain_twin(name, s):
        feats = features8_post_plain(s, m, spacing, x_halo, pre_padded)
        return torch.stack(feats, dim=0) if stack else feats
    (X, Y, Z), lo, hi = _post_core(name, s, m, x_halo, mode)
    out = torch.empty((8, X, Y, Z), dtype=s.dtype, device=s.device)
    launch("features8_post", s.device, s.data_ptr(),
           None if lo is None else lo.data_ptr(),
           None if hi is None else hi.data_ptr(), m.data_ptr(),
           out.data_ptr(), X, Y, Z, mode, *stencil_reciprocals(spacing),
           count_as=(None, "features8_post_x_halo",
                     "features8_post_pre_padded")[mode])
    return out if stack else tuple(out.unbind(0))


def fused_features8_post(s: torch.Tensor, m: torch.Tensor,
                         spacing: Sequence[float] = (1.0, 1.0, 1.0),
                         block=(8, 128), stack: bool = True,
                         pre_padded: bool = False):
    """fused_features8_post_stream's function through the windowed kernel:
    a thread block owns `block` = (bx, by) x planes and y rows (one int for
    both) of its z strip. An (8, X, Y, Z) tensor when stack, else a tuple of
    eight. pre_padded as in fused_features8_post_stream.

    CUDA tensors (contiguous float32) launch the kernel; CPU tensors run the
    plain twin; any other input raises.
    """
    name = "fused_features8_post"
    bx, by = (block, block) if isinstance(block, int) else block
    if min(int(bx), int(by)) < 1:
        raise ValueError(f"{name}: block must be >= 1, got {block}")
    if use_plain_twin(name, s):
        feats = features8_post_plain(s, m, spacing, pre_padded=pre_padded)
        return torch.stack(feats, dim=0) if stack else feats
    (X, Y, Z), _, _ = _post_core(name, s, m, None, 2 if pre_padded else 0)
    out = torch.empty((8, X, Y, Z), dtype=s.dtype, device=s.device)
    launch("features8_post_windowed", s.device,
           s.data_ptr(), m.data_ptr(), out.data_ptr(), X, Y, Z, int(bx),
           int(by), int(bool(pre_padded)), *stencil_reciprocals(spacing),
           count_as=("features8_post_windowed_pre_padded" if pre_padded
                     else None))
    return out if stack else tuple(out.unbind(0))
