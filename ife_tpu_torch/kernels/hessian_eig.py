"""Hessian + eigen features of the unsmoothed volume: the CUDA kernel
``csrc/hessian_eig.cu`` and its plain PyTorch twin.

Replaces ife_tpu/kernels/fused.py:fused_hessian_eig_stream (and
fused_hessian_eig, the same math through TPU DMA windows — here one kernel
under both names). Bound by bytes on the H100 (1 read + 6 writes of f32 per
voxel); see the source for the design.
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


def hessian_eig_plain(x: torch.Tensor,
                      spacing: Sequence[float] = (1.0, 1.0, 1.0)):
    """The kernel's plain twin: the six eigen features of the
    central-difference Hessian, on the polynomial no-diagonal eigen path the
    kernel computes. Tuple of six (X, Y, Z) tensors."""
    H = hessian(x, spacing)
    return eigenvalue_feature_channels(*H.unbind(-1), use_trig=False,
                                       diag_path=False)


def fused_hessian_eig_stream(x: torch.Tensor,
                             spacing: Sequence[float] = (1.0, 1.0, 1.0),
                             stack: bool = True):
    """[e1, e2, e3, LoG, GaussianCurvature, FrobeniusNorm] of the Hessian of
    x, eigenvalues ordered |e3| <= |e2| <= |e1|: a (6, X, Y, Z) tensor when
    stack, else a tuple of six (X, Y, Z) tensors.

    A CUDA tensor (contiguous float32) launches the kernel; a CPU tensor runs
    the plain twin (any float dtype); any other input raises.
    """
    if use_plain_twin("fused_hessian_eig_stream", x):
        feats = hessian_eig_plain(x, spacing)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume("fused_hessian_eig_stream", x)
    X, Y, Z = x.shape
    out = torch.empty((6, X, Y, Z), dtype=x.dtype, device=x.device)
    launch("hessian_eig", x.device,
           x.data_ptr(), out.data_ptr(), X, Y, Z, *stencil_reciprocals(spacing))
    return out if stack else tuple(out.unbind(0))


# ife_tpu's windowed variant computes the same function; its DMA window was
# a TPU artefact, so on the card it is this one kernel
fused_hessian_eig = fused_hessian_eig_stream
