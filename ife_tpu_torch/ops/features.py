"""The flagship 8-channel emphysema feature pass (counterpart of
ife_tpu/ops/features.py).

Reference: include/ife/Filters/ImageToEmphysemaFeaturesFilter.{h,hxx}.

Channel order (reference tools/ExtractFeatures.cxx:126-130):
  0 GaussianBlur          masked normalized-convolution smoothing
  1 GradientMagnitude     central-difference |grad| of (0)
  2 Eigenvalue1           Hessian eigenvalues of (0), |e3|<=|e2|<=|e1|
  3 Eigenvalue2
  4 Eigenvalue3
  5 LaplacianOfGaussian   e1+e2+e3
  6 GaussianCurvature     e1*e2*e3
  7 FrobeniusNorm         sqrt(e1^2+e2^2+e3^2)

All channels are zeroed outside the (binary) mask with a select: the
normalized convolution divides without epsilon, so its NaN lives outside
the mask, and NaN * 0 would stay NaN.

Two forms, chosen by ``features8_auto``/``features8_auto_channels`` from
the device of the image, as ife_tpu chooses by platform:
  * ``fused_features8`` — the kernels (polynomial eigen path), one of three
    branches by the x radius (``features8_dispatch_branch``): what a CUDA
    tensor runs;
  * ``features8`` — the plain composition of ops (trig eigen path with the
    reference's diagonal branch): what a CPU tensor runs.

``multiscale_features8_fused`` runs several scales at once: the x and z
smoothing per scale, then one kernel launch for the y smoothing, the divide
and the tail of every scale.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ife_tpu_torch.kernels.features8_post import fused_features8_post_stream
from ife_tpu_torch.kernels.features8_sweep import (
    fused_features8_sweep, fused_features8_xs_stream, sweep_fits,
    xs_stream_fits,
)
from ife_tpu_torch.kernels.features8_ys_multi import fused_features8_ys_multi
from ife_tpu_torch.kernels.hessian_eig import hessian_eig_reference_features
from ife_tpu_torch.kernels.normalized_conv import (
    fused_normalized_conv_sweep, fused_smooth_xz, fused_smooth_yz,
)
from ife_tpu_torch.ops.eigen import eigenvalue_features
from ife_tpu_torch.ops.stencil import (
    gradient_magnitude,
    hessian,
    normalized_gaussian_convolution,
)
from ife_tpu_torch.utils.profiling import span

FEATURE_NAMES = (
    "GaussianBlur",
    "GradientMagnitude",
    "Eigenvalue1",
    "Eigenvalue2",
    "Eigenvalue3",
    "LaplacianOfGaussian",
    "GaussianCurvature",
    "FrobeniusNorm",
)
NUM_FEATURES = 8  # reference ImageToEmphysemaFeaturesFilter.h:62

# The x radii (voxels) up to which features8 goes to the sweep kernel and to
# the xs-stream kernel, cut where the branches' times cross under a
# lung-like mask: chip_smoke.py's dispatch table (the features8 pass at 512^3,
# spacing (0.78, 0.78, 1.0), every x radius 4 .. 28 and 30 .. 48, the
# branches in turns) on an NVIDIA H100 80GB HBM3 at its 700 W limit. Under
# the sphere mask (27% inside) the sweep is the fastest branch at every
# radius it is instantiated for (rx 4: 3.36 ms against 5.04 for y/z +
# xs-stream and 6.16 for normalized_conv + post; rx 10: 4.24 / 6.09 / 7.22),
# y/z + xs-stream beats the staged pair from rx 11 to 24 (rx 11: 6.26
# against 7.41; rx 14: 7.07 / 7.96; rx 24: 9.39 / 9.84) and loses to it from
# rx 25 on (10.66 / 10.11), where its ring leaves an SM too few warps. Under
# a mask of ones the staged pair is the fastest from rx 4 on (rx 4: 6.10
# against the sweep's 6.38; rx 14: 7.82 against 9.96): the sweep and
# xs-stream kernels skip what a sparse mask leaves empty, the staged pair
# does not. The choice stays a function of the radius alone, as in ife_tpu;
# the mask is not read on the host to choose.
_SWEEP_RX_MAX = 10
_XS_RX_MAX = 24


def clamp_mask(mask: torch.Tensor, kind: str | None = None) -> torch.Tensor:
    """Clamp a labeled mask to binary {0,1} (labels 2,3,... -> 1), the
    itk::ClampImageFilter(0,1) before every feature pass (reference
    tools/ExtractFeatures.cxx:98-104), in one pass on the mask's device: a
    bool or unsigned mask as uint8; a signed integer one in its own dtype; a
    float one in its own dtype, NaN kept and -0.0 and all below 0 as +0.0.

    `kind` is the numpy kind ("b", "u", "i" or "f") of a mask that crossed
    from the host as the signed integer of its width (a bool or unsigned
    one: roi/bag.py's staging); None reads it from the tensor's dtype."""
    if kind is None:
        kind = ("f" if mask.is_floating_point()
                else "i" if mask.is_signed() else "u")
    if kind in "bu":
        return (mask != 0).view(torch.uint8)
    if kind == "f":
        # selects, not torch.clamp, whose kernels differ in the sign they
        # give a clamped -0.0
        return torch.where(mask <= 0, 0, torch.where(mask >= 1, 1, mask))
    return mask.clamp(0, 1)


def features8(
    image: torch.Tensor,
    mask: torch.Tensor,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> torch.Tensor:
    """8-channel feature volume at one scale, composed from the plain ops.
    Returns (X, Y, Z, 8).

    `mask` may be any integer/float labels; it is clamped to {0,1} and used
    both as the normalized-convolution certainty and the output mask, as in
    the reference DAG (ImageToEmphysemaFeaturesFilter.hxx:14-55).
    """
    m = clamp_mask(mask)
    mf = m.to(image.dtype)

    smoothed = normalized_gaussian_convolution(image, mf, sigma, spacing, truncate)
    gm = gradient_magnitude(smoothed, spacing)
    eig = eigenvalue_features(hessian(smoothed, spacing))  # (..., 6)

    feats = torch.cat([smoothed[..., None], gm[..., None], eig], dim=-1)
    inside = (m != 0)[..., None]
    return torch.where(inside, feats, torch.zeros((), dtype=image.dtype,
                                                  device=image.device))


def features8_dispatch_branch(sigma, spacing, shape, truncate=4.5) -> str:
    """The kernel branch fused_features8 takes for this scale, by the x
    radius rx = ceil(truncate * sigma / spacing[0]) as in ife_tpu:
      * "sweep" (rx <= 10): fused_features8_sweep, the whole pass in one
        kernel;
      * "xs_stream" (rx <= 24): fused_smooth_yz, then
        fused_features8_xs_stream (x pass, divide and tail in one kernel);
      * "nc_conv+post": fused_normalized_conv_sweep, then
        fused_features8_post_stream.
    `shape` does not matter on the card; a branch whose rings overflow a
    block's shared memory (sweep_fits, xs_stream_fits) passes the scale
    on to the next."""
    rx = math.ceil(truncate * float(sigma) / float(spacing[0]))
    if rx <= _SWEEP_RX_MAX and sweep_fits(sigma, spacing, truncate):
        return "sweep"
    if rx <= _XS_RX_MAX and xs_stream_fits(sigma, spacing, truncate):
        return "xs_stream"
    return "nc_conv+post"


def normalized_convolution_auto(image, certainty, sigma,
                                spacing=(1.0, 1.0, 1.0), truncate=4.5):
    """Masked (normalized) Gaussian convolution: the normalized_conv kernel
    on CUDA, normalized_gaussian_convolution (its plain twin) on the CPU.

    The certainty is used RAW (no clamp): the reference filter consumes the
    certainty image as given (NormalizedGaussianConvolutionImageFilter.hxx
    :40-63), and G*(c*f)/G*c is not invariant to per-voxel clipping of c.
    Only the features8 paths clamp, mirroring the reference's
    ClampImageFilter(0,1) there."""
    return fused_normalized_conv_sweep(
        image, certainty.to(image.dtype).contiguous(), float(sigma),
        tuple(spacing), truncate)


# the span each branch of fused_features8 records (utils.profiling.span)
_BRANCH_SPANS = {"sweep": "features.sweep", "xs_stream": "features.xs_stream",
                 "nc_conv+post": "features.nc_post"}


def fused_features8(image, mask, sigma, spacing=(1.0, 1.0, 1.0),
                    truncate=4.5, stack=True, branch=None):
    """features8 through the kernels (counterpart of ife_tpu's
    kernels.fused.fused_features8 dispatcher together with its sweep
    branch in features8_auto_channels), on the branch
    features8_dispatch_branch names, or on `branch` when given (one of
    "sweep", "xs_stream", "nc_conv+post": how the branches are timed against
    each other). Returns (8, X, Y, Z) when stack, else a tuple of 8. CUDA
    tensors run the CUDA kernels; CPU tensors run the kernels' plain
    twins."""
    sigma, spacing = float(sigma), tuple(spacing)
    if branch is None:
        branch = features8_dispatch_branch(sigma, spacing, image.shape,
                                           truncate)
    elif branch not in _BRANCH_SPANS:
        raise ValueError(f"fused_features8: no branch {branch!r}")
    dev, voxels = image.device, image.numel()
    with span(_BRANCH_SPANS[branch], device=dev, work=voxels):
        if branch == "sweep":
            # the sweep clamps the mask itself: no clamp pass over the volume
            with span("features.mask", device=dev, work=voxels):
                mf = mask.to(image.dtype).contiguous()
            return fused_features8_sweep(image, mf, sigma, spacing, truncate,
                                         stack=stack)
        with span("features.mask", device=dev, work=voxels):
            mf = clamp_mask(mask).to(image.dtype).contiguous()
        if branch == "xs_stream":
            num, den = fused_smooth_yz(image, mf, sigma, spacing, truncate)
            return fused_features8_xs_stream(num, den, mf, sigma, spacing,
                                             truncate, stack=stack)
        s = fused_normalized_conv_sweep(image, mf, sigma, spacing, truncate)
        return fused_features8_post_stream(s, mf, spacing, stack=stack)


def features8_auto_channels(image, mask, sigma, spacing=(1.0, 1.0, 1.0),
                            truncate=4.5):
    """The features8 pass as a TUPLE of 8 (X, Y, Z) channel tensors, without
    a channel-last stack (at 512^3 that is a 4.3 GB copy). A CUDA tensor
    runs the kernels (fused_features8); a CPU tensor the plain composition
    of ops (features8), as ife_tpu runs XLA ops off the TPU."""
    if image.is_cuda:
        return fused_features8(image, mask, sigma, spacing, truncate,
                               stack=False)
    return features8(image, mask, float(sigma), tuple(spacing),
                     truncate).unbind(-1)


def features8_auto(image, mask, sigma, spacing=(1.0, 1.0, 1.0), truncate=4.5):
    """features8_auto_channels stacked channel-last: (X, Y, Z, 8), the
    layout of features8."""
    if image.is_cuda:
        return torch.stack(
            features8_auto_channels(image, mask, sigma, spacing, truncate),
            dim=-1)
    return features8(image, mask, float(sigma), tuple(spacing), truncate)


def multiscale_features8_fused(
    image: torch.Tensor,
    mask: torch.Tensor,
    sigmas: Sequence[float],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
    stack: bool = True,
):
    """The feature passes of all `sigmas` ending in ONE kernel launch
    (counterpart of ife_tpu's multiscale_features8_fused): the mask is
    clamped, mask*image and the mask are smoothed along x and z per scale
    (fused_smooth_xz), then fused_features8_ys_multi does, for every scale,
    the y smoothing, the no-epsilon divide and the masked feature tail.
    Returns (S, 8, X, Y, Z) when stack, else a tuple of S tuples of 8.

    CUDA tensors run the kernels, CPU tensors their plain twins."""
    sigmas = tuple(float(s) for s in sigmas)
    spacing = tuple(spacing)
    mf = clamp_mask(mask).to(image.dtype).contiguous()
    pairs = [fused_smooth_xz(image, mf, s, spacing, truncate) for s in sigmas]
    return fused_features8_ys_multi(
        [num for num, _ in pairs], [den for _, den in pairs], mf, sigmas,
        spacing, truncate, stack=stack)


def multiscale_features(
    image: torch.Tensor,
    mask: torch.Tensor,
    sigmas: Sequence[float],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> torch.Tensor:
    """Features at several scales, stacked: (X, Y, Z, n_scales, 8). The
    reference loops scales at the tool level (tools/MakeBag.cxx:405-412)."""
    per_scale = [
        features8_auto(image, mask, float(s), spacing, truncate)
        for s in sigmas
    ]
    return torch.stack(per_scale, dim=-2)


def hessian_eig_features_channels(
    image: torch.Tensor, spacing: Sequence[float] = (1.0, 1.0, 1.0)
):
    """Unsmoothed Hessian -> 6 eigen features as a TUPLE of 6 (X, Y, Z)
    tensors, without a channel-last stack (at 512^3 that stack costs 16x the
    kernel): ife_tpu.ops.features.hessian_eig_features, the trig eigen path
    with the reference's diagonal branch, on every device. On a CUDA tensor
    the Hessian kernel's reference output (hessian_eig_reference_features);
    on a CPU tensor the plain ops, eigenvalue_features(hessian(...)).
    fused_hessian_eig_stream is the Pallas kernel's function instead (the
    polynomial path, no diagonal branch), which orders tied eigenvalues
    differently: on i^2 - j^2 it gives (2, -2, 0) where this gives
    (-2, 2, 0)."""
    if image.is_cuda:
        return hessian_eig_reference_features(image, tuple(spacing))
    return eigenvalue_features(hessian(image, spacing)).unbind(-1)


def hessian_eig_features(
    image: torch.Tensor, spacing: Sequence[float] = (1.0, 1.0, 1.0)
) -> torch.Tensor:
    """hessian_eig_features_channels stacked channel-last: (X, Y, Z, 6), the
    layout of ife_tpu's hessian_eig_features (the same function)."""
    if image.is_cuda:
        return torch.stack(hessian_eig_features_channels(image, spacing),
                           dim=-1)
    return eigenvalue_features(hessian(image, spacing))
