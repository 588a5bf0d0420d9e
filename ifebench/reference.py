"""The plain reference of the emphysema feature pass and of the bag rows:
plain PyTorch, written from the published algorithm and independent of the
program (it imports nothing of it and takes nothing it made).

Per scale sigma (physical units), as the upstream ImageToEmphysemaFeatures
filter wires it: the mask clamped to {0, 1} is the certainty c; the
normalized convolution G*(c f) / G*c with a separable sampled Gaussian
truncated at `truncate` sigma (edge-replicating boundary, no epsilon);
central-difference gradient magnitude and Hessian (the cross terms as
cascaded first differences); the closed-form eigenvalues of the symmetric
3x3 Hessian (the diagonal branch, then the trigonometric solve), ordered
|e3| <= |e2| <= |e1|; their sum, product and Frobenius norm. Every channel
is zero outside the mask. Channel order: GaussianBlur, GradientMagnitude,
Eigenvalue1-3, LaplacianOfGaussian, GaussianCurvature, FrobeniusNorm.

The reference runs in float64. ``tf32=True`` with float32 is the control:
the same functions with every product of the Gaussian FIR taken on
operands rounded to TF32 (10 mantissa bits), as a convolution on the
tensor cores with TF32 on would take them.

``features_region`` evaluates a box of the volume from a crop with a halo
of the filter's radius + 2 on every side (cut at the volume's faces), slab
by slab along x, so that it fits the card beside the program's outputs;
every voxel of the box gets the value the whole volume gives it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_FEATURES = 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (the low 13 mantissa bits dropped,
    to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def gaussian_taps(sigma: float, spacing: float, truncate: float):
    """(f64 taps, radius) of the sampled Gaussian along one axis."""
    sigma_vox = float(sigma) / float(spacing)
    radius = max(1, int(math.ceil(truncate * sigma_vox)))
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma_vox * sigma_vox))
    return g / g.sum(), radius


def radii(sigma, spacing, truncate):
    return [gaussian_taps(sigma, h, truncate)[1] for h in spacing]


def _clamped(x, axis, lo, hi):
    n = x.shape[axis]
    idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def _smooth_axis(x, axis, sigma, spacing, truncate, tf32):
    taps, r = gaussian_taps(sigma, spacing, truncate)
    if tf32:
        x = tf32_round(x)
        taps = tf32_round(torch.tensor(taps, dtype=torch.float32)).tolist()
    xp = _clamped(x, axis, r, r)
    n = x.shape[axis]
    acc = None
    for k, t in enumerate(taps):
        term = t * xp.narrow(axis, k, n)
        acc = term if acc is None else acc + term
    return acc


def _smooth(x, sigma, spacing, truncate, tf32):
    for axis in range(3):
        x = _smooth_axis(x, axis, sigma, spacing[axis], truncate, tf32)
    return x


def _diff(x, axis, order, h):
    xp = _clamped(x, axis, 1, 1)
    n = x.shape[axis]
    fm, f0, fp = (xp.narrow(axis, k, n) for k in range(3))
    if order == 1:
        return (fp - fm) * (1.0 / (2.0 * h))
    return (fp - 2 * f0 + fm) * (1.0 / (h * h))


def _diag_order(a11, a22, a33):
    """Diagonal entries ordered by |.| descending, the upstream solver's
    strict comparisons."""
    c1 = a11.abs() > a22.abs()
    c2 = a11.abs() > a33.abs()
    c3 = a22.abs() > a33.abs()
    b1 = (a11, torch.where(c3, a22, a33), torch.where(c3, a33, a22))
    b2 = (a33, a11, a22)
    b3 = (a22, torch.where(c2, a11, a33), torch.where(c2, a33, a11))
    b4 = (a33, a22, a11)
    return tuple(torch.where(c1, torch.where(c2, b1[k], b2[k]),
                             torch.where(c3, b3[k], b4[k])) for k in range(3))


def eigenvalues(a11, a12, a13, a22, a23, a33):
    """Eigenvalues of the symmetric 3x3 matrices, |e3| <= |e2| <= |e1|."""
    p1 = a12 * a12 + a13 * a13 + a23 * a23
    q = (a11 + a22 + a33) * (1.0 / 3.0)
    d11, d22, d33 = a11 - q, a22 - q, a33 - q
    p2 = d11 * d11 + d22 * d22 + d33 * d33 + 2 * p1
    p = torch.sqrt(torch.where(p2 > 0, p2, torch.ones_like(p2)) / 6.0)
    det = (d11 * (d22 * d33 - a23 * a23) + a12 * (a23 * a13 - a12 * d33)
           + a13 * (a12 * a23 - a13 * d22))
    r = (det / (p * p * p) * 0.5).clamp(-1.0, 1.0)
    phi = torch.acos(r) / 3.0
    g0 = q + 2 * p * torch.cos(phi)
    g2 = q + 2 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    g1 = 3 * q - g0 - g2
    s1 = g0.abs() < g2.abs()
    t0, t2 = torch.where(s1, g2, g0), torch.where(s1, g0, g2)
    s2 = g1.abs() < t2.abs()
    t1, t2 = torch.where(s2, t2, g1), torch.where(s2, g1, t2)
    diag = p1 == 0
    e = _diag_order(a11, a22, a33)
    return (torch.where(diag, e[0], t0), torch.where(diag, e[1], t1),
            torch.where(diag, e[2], t2))


def features(image, mask, sigma, spacing, truncate=4.5, dtype=torch.float64,
             tf32=False):
    """(8, X, Y, Z) features of one scale over the whole of `image`."""
    c = mask.clamp(0, 1).to(dtype)
    f = image.to(dtype)
    s = (_smooth(f * c, sigma, spacing, truncate, tf32)
         / _smooth(c, sigma, spacing, truncate, tf32))
    d1 = [_diff(s, a, 1, spacing[a]) for a in range(3)]
    gm = torch.sqrt(d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2])
    hxx, hyy, hzz = (_diff(s, a, 2, spacing[a]) for a in range(3))
    hxy = _diff(d1[0], 1, 1, spacing[1])
    hxz = _diff(d1[0], 2, 1, spacing[2])
    hyz = _diff(d1[1], 2, 1, spacing[2])
    e1, e2, e3 = eigenvalues(hxx, hxy, hxz, hyy, hyz, hzz)
    out = torch.stack([s, gm, e1, e2, e3, e1 + e2 + e3, e1 * e2 * e3,
                       torch.sqrt(e1 * e1 + e2 * e2 + e3 * e3)])
    return torch.where(c != 0, out, torch.zeros((), dtype=dtype,
                                                device=out.device))


def features_region(image, mask, sigma, spacing, truncate=4.5, lo=None,
                    hi=None, dtype=torch.float64, tf32=False, slab=64):
    """(8, *(hi - lo)) features of the box [lo, hi) of the volume, equal
    to the same box of ``features`` over the whole volume."""
    shape = image.shape
    lo = [0, 0, 0] if lo is None else [int(v) for v in lo]
    hi = list(shape) if hi is None else [int(v) for v in hi]
    halo = [r + 2 for r in radii(sigma, spacing, truncate)]
    out = torch.empty((N_FEATURES, *[b - a for a, b in zip(lo, hi)]),
                      dtype=dtype, device=image.device)
    for x0 in range(lo[0], hi[0], slab):
        box_lo = [x0, lo[1], lo[2]]
        box_hi = [min(x0 + slab, hi[0]), hi[1], hi[2]]
        c_lo = [max(0, a - h) for a, h in zip(box_lo, halo)]
        c_hi = [min(n, b + h) for b, h, n in zip(box_hi, halo, shape)]
        crop = tuple(slice(a, b) for a, b in zip(c_lo, c_hi))
        feats = features(image[crop], mask[crop], sigma, spacing, truncate,
                         dtype, tf32)
        inner = tuple(slice(a - c, b - c)
                      for a, b, c in zip(box_lo, box_hi, c_lo))
        out[:, x0 - lo[0]:box_hi[0] - lo[0]] = feats[(slice(None),) + inner]
        del feats
    return out


def bag_rows(feats, mask, lo, starts, size, edges):
    """(n_rois, 8 * bins) f64 frequencies of one scale: for each box
    [start, start + size) the masked voxels of each channel binned by its
    edges (bin j holds e[j-1] < v <= e[j]), divided by the box's masked
    voxel count. `feats` (8, ...) and `mask` cover the region that starts
    at `lo`; `edges` is (8, bins - 1) f64."""
    e = torch.as_tensor(np.asarray(edges), dtype=torch.float64,
                        device=feats.device)
    bins = e.shape[1] + 1
    rows = []
    for st in np.asarray(starts, np.int64):
        box = tuple(slice(int(a - o), int(a - o + s))
                    for a, o, s in zip(st, lo, size))
        inside = mask[box] != 0
        total = int(inside.sum())
        row = []
        for k in range(N_FEATURES):
            v = feats[k][box][inside].to(torch.float64).contiguous()
            idx = torch.searchsorted(e[k].contiguous(), v, right=False)
            counts = torch.bincount(idx, minlength=bins).to(torch.float64)
            row.append(counts / total)
        rows.append(torch.cat(row))
    return torch.stack(rows).cpu().numpy()


def roi_region(starts, size, shape):
    """[lo, hi) of the smallest box that holds every ROI."""
    st = np.asarray(starts, np.int64)
    lo = st.min(axis=0)
    hi = np.minimum(st.max(axis=0) + np.asarray(size, np.int64),
                    np.asarray(shape, np.int64))
    return lo, hi
