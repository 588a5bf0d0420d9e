"""Finite-difference and separable-Gaussian stencils with ZeroFluxNeumann
boundaries, in plain PyTorch (counterpart of ife_tpu/ops/stencil.py).

The reference builds these from ITK filter objects:
  * itk::DerivativeImageFilter (central differences, ZeroFluxNeumann
    boundary, spacing-scaled) — used 8x by the Hessian
    (reference: include/ife/Filters/Hessian3DImageFilter.hxx:19-59);
  * itk::GradientMagnitudeImageFilter (3-axis central difference);
  * itk::SmoothingRecursiveGaussianImageFilter (Deriche IIR, sigma in
    physical units) — here, as in ife_tpu, a truncated FIR sampled Gaussian.

Every stencil is an edge-clamped index gather plus shifted slices, with no
convolution operator: cuDNN convolutions run in TF32 by default on Hopper,
and the shifted-slice sums keep these functions exact in f32 and f64 on any
device. They are the plain versions the CUDA kernels are tested against; the
kernels' twins smooth with kernel_smooth_axis, the kernels' own order of
sums.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

Axis = int  # 0=x, 1=y, 2=z (ITK direction order)


def _edge_pad(x: torch.Tensor, axis: Axis, lo: int, hi: int) -> torch.Tensor:
    """ZeroFluxNeumann = replicate the boundary voxel (a clamped gather)."""
    n = x.shape[axis]
    idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def derivative(
    x: torch.Tensor, axis: Axis, order: int, spacing: float = 1.0,
    face=None,
) -> torch.Tensor:
    """Central-difference derivative along one axis.

    order=1: (f[i+1] - f[i-1]) / (2h);  order=2: (f[i+1] - 2 f[i] + f[i-1]) / h^2.
    ZeroFluxNeumann boundary (edge replicate). Multiplies by the reciprocal
    folded in f64 and rounded once to x's dtype, as ife_tpu and the CUDA
    kernels do.

    face = (lo, hi) moves the clamp from the array's ends to the true faces
    of a halo-extended shard block (csrc/s_ring.cuh FaceClamps): an index
    i <= lo takes f[i] for f[i-1], an index i >= hi takes f[i] for f[i+1];
    the array's own ends still clamp. None is (0, n - 1).
    """
    n = x.shape[axis]
    if face is None:
        xp = _edge_pad(x, axis, 1, 1)
        fm = xp.narrow(axis, 0, n)
        f0 = xp.narrow(axis, 1, n)
        fp = xp.narrow(axis, 2, n)
    else:
        lo, hi = (int(v) for v in face)
        i = torch.arange(n, device=x.device)
        fm = x.index_select(axis, torch.where(i <= lo, i, (i - 1).clamp_(min=0)))
        f0 = x
        fp = x.index_select(axis,
                            torch.where(i >= hi, i, (i + 1).clamp_(max=n - 1)))
    h = float(spacing)
    if order == 1:
        return (fp - fm) * (1.0 / (2.0 * h))
    elif order == 2:
        return (fp - 2 * f0 + fm) * (1.0 / (h * h))
    raise ValueError(f"order must be 1 or 2, got {order}")


def gradient_magnitude(
    x: torch.Tensor, spacing: Sequence[float] = (1.0, 1.0, 1.0),
    faces=(None, None, None),
) -> torch.Tensor:
    """sqrt(sum_d (df/dx_d)^2) with central differences
    (reference ImageToEmphysemaFeaturesFilter.hxx:27-28). `faces`: per axis,
    the `face` of derivative."""
    acc = None
    for d in range(3):
        g = derivative(x, d, 1, spacing[d], faces[d])
        acc = g * g if acc is None else acc + g * g
    return torch.sqrt(acc)


def hessian(
    x: torch.Tensor, spacing: Sequence[float] = (1.0, 1.0, 1.0),
    faces=(None, None, None),
) -> torch.Tensor:
    """6-channel Hessian, channel order [Dxx, Dxy, Dxz, Dyy, Dyz, Dzz].

    Pure second derivatives are single order-2 stencils; cross derivatives
    are CASCADED order-1 stencils (Dx then Dy, Dx then Dz, Dy then Dz), each
    pass applying its own ZeroFluxNeumann boundary — the reference wiring
    (Hessian3DImageFilter.hxx:31-59).

    `faces`: per axis, the `face` of derivative (each pass of a cascade
    clamps at its own axis's faces).

    Returns a tensor (..., 6) stacked on a new trailing axis.
    """
    fx, fy, fz = faces
    dxx = derivative(x, 0, 2, spacing[0], fx)
    dyy = derivative(x, 1, 2, spacing[1], fy)
    dzz = derivative(x, 2, 2, spacing[2], fz)
    dx = derivative(x, 0, 1, spacing[0], fx)
    dy = derivative(x, 1, 1, spacing[1], fy)
    dxy = derivative(dx, 1, 1, spacing[1], fy)
    dxz = derivative(dx, 2, 1, spacing[2], fz)
    dyz = derivative(dy, 2, 1, spacing[2], fz)
    return torch.stack([dxx, dxy, dxz, dyy, dyz, dzz], dim=-1)


# ---------------------------------------------------------------------------
# Gaussian smoothing
# ---------------------------------------------------------------------------

def gaussian_radius(sigma_vox: float, truncate: float = 4.5) -> int:
    """FIR truncation radius in voxels for a given sigma (in voxels)."""
    return max(1, int(math.ceil(truncate * sigma_vox)))


@functools.lru_cache(maxsize=256)
def _gaussian_taps(sigma_vox: float, radius: int) -> np.ndarray:
    """Normalized sampled-Gaussian taps, length 2*radius+1 (float64)."""
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma_vox * sigma_vox))
    return g / g.sum()


@functools.lru_cache(maxsize=1024)
def _band_matrix(n: int, sigma_vox: float, radius: int) -> np.ndarray:
    """(n, n) matrix W with W[o, i] = sum of taps mapping padded-in i to out o
    under edge replication. out = W @ in  along the convolved axis."""
    taps = _gaussian_taps(sigma_vox, radius)
    W = np.zeros((n, n), dtype=np.float64)
    for t_idx, t in enumerate(taps):
        offs = t_idx - radius
        for o in range(n):
            src = min(max(o + offs, 0), n - 1)  # edge replication
            W[o, src] += t
    return W


def smooth_taps(sigma: float, spacing: float, truncate: float = 4.5):
    """(taps tuple of Python floats, radius) for one axis, sigma in physical
    units; sigma <= 0 -> the identity ((1.0,), 0). The taps are the f64
    numpy taps; a tensor op or a kernel rounds each once to f32."""
    if sigma <= 0:
        return (1.0,), 0
    sigma_vox = float(sigma) / float(spacing)
    radius = gaussian_radius(sigma_vox, truncate)
    return tuple(float(t) for t in _gaussian_taps(sigma_vox, radius)), radius


def _fir(x_ext: torch.Tensor, axis: Axis, taps, n: int) -> torch.Tensor:
    """out[i] = sum_k taps[k] * x_ext[i + k] along `axis` for i < n, taps
    symmetric: each pair of samples that shares a tap is added first, and the
    pairs are summed from the outermost tap inwards (the smallest weights
    first), the centre tap last. Against a sum in tap order this halves the
    roundings and adds the terms in rising magnitude: at sigma 4.8 and
    spacing 0.78 (57 taps) the f32 features8 sits 2.3 times closer to f64,
    as close as ife_tpu's f32 ops on the CPU (PERF.md section 6)."""
    r = len(taps) // 2
    acc = None
    for d in range(r, 0, -1):
        pair = x_ext.narrow(axis, r - d, n) + x_ext.narrow(axis, r + d, n)
        acc = taps[r + d] * pair if acc is None else acc + taps[r + d] * pair
    centre = taps[r] * x_ext.narrow(axis, r, n)
    return centre if acc is None else acc + centre


def gaussian_smooth_axis(
    x: torch.Tensor, axis: Axis, sigma: float, spacing: float = 1.0,
    truncate: float = 4.5,
) -> torch.Tensor:
    """1D Gaussian along `axis`, sigma in PHYSICAL units (like ITK),
    ZeroFluxNeumann boundary: out[i] = sum_k taps[k] * x[clamp(i + k - r)],
    summed as _fir sums it. The kernels' twins sum in tap order instead
    (kernel_smooth_axis)."""
    if sigma <= 0:
        return x
    taps, radius = smooth_taps(sigma, spacing, truncate)
    return _fir(_edge_pad(x, axis, radius, radius), axis, taps,
                x.shape[axis])


def kernel_smooth_axis(
    x: torch.Tensor, axis: Axis, sigma: float, spacing: float = 1.0,
    truncate: float = 4.5,
) -> torch.Tensor:
    """gaussian_smooth_axis in the association of the CUDA kernels' FIR
    passes (csrc/fir.cuh): a sum of shifted slices of the edge-padded
    tensor in tap order, tap 0's product first, each product and each sum
    rounded. What the kernels' plain twins smooth with, so that a kernel
    equals its twin to the bit. It goes once the kernels sum pairs as _fir
    does (ROADMAP queue 2, item 10)."""
    if sigma <= 0:
        return x
    taps, radius = smooth_taps(sigma, spacing, truncate)
    n = x.shape[axis]
    xp = _edge_pad(x, axis, radius, radius)
    acc = taps[0] * xp.narrow(axis, 0, n)
    for k in range(1, len(taps)):
        acc = acc + taps[k] * xp.narrow(axis, k, n)
    return acc


def convolve_valid_axis(
    x_ext: torch.Tensor, axis: Axis, sigma_vox: float, radius: int
) -> torch.Tensor:
    """VALID Gaussian along `axis` of an already-extended tensor
    ((..., n + 2*radius, ...) -> (..., n, ...)): gaussian_smooth_axis's sum
    on a pad the caller supplied (a shard's halo)."""
    taps = tuple(float(t) for t in _gaussian_taps(float(sigma_vox),
                                                  int(radius)))
    return _fir(x_ext, axis, taps, x_ext.shape[axis] - 2 * radius)


def gaussian_smooth(
    x: torch.Tensor,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> torch.Tensor:
    """Separable isotropic (in physical units) Gaussian smoothing, axes in
    the order x, y, z (reference NormalizedGaussianConvolutionImageFilter
    .hxx:51-55 with a truncated FIR — see ife_tpu/ops/stencil.py)."""
    for d in range(3):
        x = gaussian_smooth_axis(x, d, sigma, spacing[d], truncate)
    return x


def normalized_gaussian_convolution(
    image: torch.Tensor,
    certainty: torch.Tensor,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> torch.Tensor:
    """Knutsson–Westin normalized convolution, 0th order:
    out = G_sigma*(c*T) / G_sigma*c.

    Mirrors reference NormalizedGaussianConvolutionImageFilter.hxx:40-63:
    multiply -> two Gaussians -> divide, with NO epsilon in the divide. Far
    outside the certainty support this is IEEE 0/0 = nan, exactly like the
    reference; callers mask the result.
    """
    c = certainty.to(image.dtype)
    num = gaussian_smooth(image * c, sigma, spacing, truncate)
    den = gaussian_smooth(c, sigma, spacing, truncate)
    return num / den
