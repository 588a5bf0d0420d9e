"""Hessian + eigen features of the unsmoothed volume: the CUDA kernel
``csrc/hessian_eig.cu`` and its plain PyTorch twin.

Replaces ife_tpu/kernels/fused.py:fused_hessian_eig_stream (and
fused_hessian_eig, the same math through TPU DMA windows — here one kernel
under both names), with their shard modes x_halo and pre_padded. Bound by
bytes on the H100 (1 read + 6 writes of f32 per voxel); see the source for
the design.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, use_plain_twin,
)
from ife_tpu_torch.ops.eigen import eigenvalue_feature_channels
from ife_tpu_torch.ops.stencil import hessian


def stencil_reciprocals(spacing: Sequence[float]):
    """(1/2hx, 1/2hy, 1/2hz, 1/hx^2, 1/hy^2, 1/hz^2) folded in f64 — the
    constants ops.stencil.derivative multiplies by (ife_tpu
    kernels/fused.py:172-177); ctypes rounds each once to f32."""
    hx, hy, hz = (float(v) for v in spacing)
    return (1.0 / (2.0 * hx), 1.0 / (2.0 * hy), 1.0 / (2.0 * hz),
            1.0 / (hx * hx), 1.0 / (hy * hy), 1.0 / (hz * hz))


def halo_rows(name: str, x_halo, shape, like: torch.Tensor):
    """The (lo, hi) pair of an x_halo operand, checked: each a (1, Y, Z)
    tensor of `like`'s dtype and device."""
    lo, hi = x_halo
    for side, h in (("lo", lo), ("hi", hi)):
        if (tuple(h.shape) != (1,) + tuple(shape[1:]) or h.dtype != like.dtype
                or h.device != like.device):
            raise ValueError(
                f"{name}: x_halo {side} row must be {(1,) + tuple(shape[1:])} "
                f"{like.dtype} on {like.device}, got {tuple(h.shape)} "
                f"{h.dtype} on {h.device}")
    return lo, hi


def with_shard_halo(plain, x: torch.Tensor, x_halo, pre_padded: bool):
    """The shard modes of a plain twin `plain(volume) -> channels`: run it on
    the block extended by its halo rows (x_halo), or on the block that
    already carries its boundary layer (pre_padded), and keep the core.
    The extension's outer clamp touches only what is cropped."""
    if x_halo is not None:
        lo, hi = x_halo
        return tuple(c[1:-1] for c in plain(torch.cat([lo, x, hi], dim=0)))
    if pre_padded:
        return tuple(c[1:-1, 1:-1] for c in plain(x))
    return tuple(plain(x))


def stencil_mode(name: str, x_halo, pre_padded: bool) -> int:
    """csrc/features8_tail.cuh StencilMode of a call."""
    if x_halo is not None and pre_padded:
        raise ValueError(f"{name}: x_halo and pre_padded are mutually exclusive")
    return 1 if x_halo is not None else (2 if pre_padded else 0)


def hessian_eig_plain(x: torch.Tensor,
                      spacing: Sequence[float] = (1.0, 1.0, 1.0),
                      x_halo=None, pre_padded: bool = False):
    """The kernel's plain twin: the six eigen features of the
    central-difference Hessian, on the polynomial no-diagonal eigen path the
    kernel computes, in the kernel's shard modes. Tuple of six tensors of
    the core's shape."""
    def plain(v):
        return eigenvalue_feature_channels(
            *hessian(v, spacing).unbind(-1), use_trig=False, diag_path=False)

    return with_shard_halo(plain, x, x_halo, pre_padded)


def fused_hessian_eig_stream(x: torch.Tensor,
                             spacing: Sequence[float] = (1.0, 1.0, 1.0),
                             stack: bool = True, x_halo=None,
                             pre_padded: bool = False):
    """[e1, e2, e3, LoG, GaussianCurvature, FrobeniusNorm] of the Hessian of
    x, eigenvalues ordered |e3| <= |e2| <= |e1|: a (6, X, Y, Z) tensor when
    stack, else a tuple of six (X, Y, Z) tensors.

    x_halo: a ((1, Y, Z), (1, Y, Z)) pair, the rows -1 and X of x (a
    neighbouring shard's rows); the kernel reads them at the x faces instead
    of clamping, so no extended block is built. pre_padded: x is
    (X + 2, Y + 2, Z) and carries a one-voxel boundary layer on x and y
    around the (X, Y, Z) core, which alone is computed and written. The two
    exclude each other.

    A CUDA tensor (contiguous float32) launches the kernel; a CPU tensor runs
    the plain twin (any float dtype); any other input raises.
    """
    name = "fused_hessian_eig_stream"
    mode = stencil_mode(name, x_halo, pre_padded)
    if use_plain_twin(name, x):
        feats = hessian_eig_plain(x, spacing, x_halo, pre_padded)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume(name, x)
    X, Y, Z = x.shape
    lo = hi = None
    if mode == 1:
        lo, hi = (h.contiguous() for h in halo_rows(name, x_halo, x.shape, x))
    elif mode == 2:
        X, Y = X - 2, Y - 2
        if min(X, Y) < 1:
            raise ValueError(f"{name}: pre_padded needs a core of >= 1 voxel, "
                             f"got a block of {tuple(x.shape)}")
    out = torch.empty((6, X, Y, Z), dtype=x.dtype, device=x.device)
    launch("hessian_eig", x.device, x.data_ptr(),
           None if lo is None else lo.data_ptr(),
           None if hi is None else hi.data_ptr(), out.data_ptr(), X, Y, Z,
           mode, *stencil_reciprocals(spacing),
           count_as=(None, "hessian_eig_x_halo", "hessian_eig_pre_padded")[mode])
    return out if stack else tuple(out.unbind(0))


# ife_tpu's windowed variant computes the same function; its DMA window was
# a TPU artefact, so on the card it is this one kernel (ife_tpu's has
# pre_padded alone of the two shard modes)
fused_hessian_eig = fused_hessian_eig_stream
