"""Closed-form eigenvalues of symmetric 3x3 matrices, elementwise over
tensors (counterpart of ife_tpu/ops/eigen.py).

Semantics of the reference's per-voxel solver
(include/ife/Numerics/Symmetric3x3EigenvalueSolver.h:33-132), branchless
with torch.where select networks:
  * input packing [A11, A12, A13, A22, A23, A33];
  * diagonal fast path when p1 == 0 with the reference's strict-greater
    comparison tree (solver.h:45-83), unless diag_path=False;
  * general path q = tr/3, p = sqrt(p2/6), r = det(A - qI)/(2 p^3),
    phi = acos(clip(r, -1, 1))/3 — by trig (use_trig=True) or by the
    trig-free polynomial path the CUDA kernels use (use_trig=False);
  * final reorder to |e3| <= |e2| <= |e1| (solver.h:123-129).

And the feature functor (EigenvalueFeaturesFunctor.h:20-31):
[e1, e2, e3, e1+e2+e3, e1*e2*e3, sqrt(e1^2+e2^2+e3^2)].

Python-float constants in a tensor op are rounded once to the tensor's
dtype, exactly as ife_tpu's jnp.asarray(c, dtype) does.
"""
from __future__ import annotations

import math

import torch


def _ordered_by_abs_desc_diag(a11, a22, a33):
    """The reference's nested-if ordering of diagonal entries by |.| desc
    (Symmetric3x3EigenvalueSolver.h:45-83, strict '>' comparisons)."""
    c1 = torch.abs(a11) > torch.abs(a22)
    c2 = torch.abs(a11) > torch.abs(a33)
    c3 = torch.abs(a22) > torch.abs(a33)

    b1 = (a11, torch.where(c3, a22, a33), torch.where(c3, a33, a22))
    b2 = (a33, a11, a22)
    b3 = (a22, torch.where(c2, a11, a33), torch.where(c2, a33, a11))
    b4 = (a33, a22, a11)

    def pick(k):
        return torch.where(c1, torch.where(c2, b1[k], b2[k]),
                           torch.where(c3, b3[k], b4[k]))

    return pick(0), pick(1), pick(2)


# Chebyshev least-squares fit of cos(arccos(m)/3) on m in [0, 1] (power
# basis, Horner), degree 8, 4.3e-9 in f64 — below the f32 roundoff of the
# Horner evaluation itself. The same coefficients as ife_tpu and
# csrc/features8_tail.cuh.
_COS13_COEF = (
    0.8660254080410869, 0.16666626771129278, -0.04810327526051493,
    0.02459883847130328, -0.015095279415175522, 0.009372082506501525,
    -0.004929524933662343, 0.0017713776825497704, -0.0003058979258242973,
)

# divide-free Newton polish: 1/(12c^2 - 3) as a quadratic in y = c^2
_NEWTON_RECIP = (0.5951957727093505, -0.8371248718026527, 0.353440250822755)


def _horner(coef, x):
    acc = torch.full_like(x, coef[-1])
    for c in coef[-2::-1]:
        acc = acc * x + c
    return acc


def _cos_sin_third_arccos(m: torch.Tensor):
    """(cos, sin) of arccos(m)/3 for m in [0, 1], without trig.

    f32: degree-8 polynomial for c plus one divide-free Newton polish on
    4c^3 - 3c = m; f64: quadratic seed plus three Newton steps. Both derive
    s = sqrt(1 - c^2) from the ROUNDED c, snapping s to 0 where c rounds to
    1 (the reference's r >= 1 clamp, solver.h:108-116).
    """
    if m.dtype == torch.float32:
        c = _horner(_COS13_COEF, m)
        y = c * c
        g0, g1, g2 = _NEWTON_RECIP
        g = g0 + y * (g1 + g2 * y)
        c = c - ((4 * y - 3) * c - m) * g
    else:
        c = 0.86656125 + m * (0.15958996 - 0.0265687 * m)
        for _ in range(3):
            c2 = c * c
            c = c - ((4 * c2 - 3) * c - m) / (12 * c2 - 3)
    s = torch.sqrt(torch.clamp(1 - c * c, min=0))
    return c, s


def eigenvalues_from_channels(a11, a12, a13, a22, a23, a33, use_trig=True,
                              diag_path=True):
    """Channel-wise core: six same-shape tensors -> (e0, e1, e2) tuple,
    |e2| <= |e1| <= |e0|.

    diag_path=False drops the reference's exact diagonal branch and keeps
    only a scalar-matrix (p2 == 0) guard — the form the CUDA kernels (and
    ife_tpu's Pallas kernels) compute; the tie ORDER of equal-|e| channels
    may differ from the diagonal branch, the values do not."""
    p1 = a12 * a12 + a13 * a13 + a23 * a23

    q = (a11 + a22 + a33) * (1.0 / 3.0)
    d11, d22, d33 = a11 - q, a22 - q, a33 - q
    p2 = d11 * d11 + d22 * d22 + d33 * d33 + 2 * p1
    # p2 > 0 whenever p1 > 0; guard the diagonal lanes (result discarded)
    p2safe = torch.where(p2 > 0, p2, torch.ones_like(p2)) * (1.0 / 6.0)
    pinv = torch.rsqrt(p2safe)
    p = p2safe * pinv  # sqrt(p2/6)
    det = (
        d11 * (d22 * d33 - a23 * a23)
        + a12 * (a23 * a13 - a12 * d33)
        + a13 * (a12 * a23 - a13 * d22)
    )
    r = det * (pinv * pinv * pinv) * 0.5

    # clip(r) reproduces the reference's r<=-1 -> phi=pi/3, r>=1 -> 0 guards
    rc = torch.clamp(r, -1.0, 1.0)
    if use_trig:
        phi = torch.acos(rc) * (1.0 / 3.0)
        cphi = torch.cos(phi)
        # pi rounded to the dtype first, then the product, as ife_tpu does
        pi = torch.tensor(math.pi, dtype=rc.dtype)
        cphi2 = torch.cos(phi + pi * (2.0 / 3.0))
    else:
        # trig-free: arccos(r) = pi - arccos(|r|) for r < 0 and the
        # angle-difference identities, cos(phi + 2pi/3) = -c/2 - (sqrt3/2) s
        s32 = math.sqrt(3.0) / 2.0
        cm, sm = _cos_sin_third_arccos(torch.abs(rc))
        pos = rc >= 0
        cphi = torch.where(pos, cm, 0.5 * cm + s32 * sm)
        sphi = torch.where(pos, sm, s32 * cm - 0.5 * sm)
        cphi2 = -0.5 * cphi - s32 * sphi
    g0 = q + 2 * p * cphi
    g2 = q + 2 * p * cphi2
    g1 = 3 * q - g0 - g2  # trace identity

    # reorder to |e3| <= |e2| <= |e1| with the reference's two swaps
    s1 = torch.abs(g0) < torch.abs(g2)
    t0 = torch.where(s1, g2, g0)
    t2 = torch.where(s1, g0, g2)
    s2 = torch.abs(g1) < torch.abs(t2)
    t1 = torch.where(s2, t2, g1)
    t2 = torch.where(s2, g1, t2)

    if not diag_path:
        # scalar-matrix guard only: p2 == 0 means all eigenvalues are q
        scalar = p2 == 0
        return (
            torch.where(scalar, q, t0),
            torch.where(scalar, q, t1),
            torch.where(scalar, q, t2),
        )

    diag = p1 == 0
    e0d, e1d, e2d = _ordered_by_abs_desc_diag(a11, a22, a33)
    return (
        torch.where(diag, e0d, t0),
        torch.where(diag, e1d, t1),
        torch.where(diag, e2d, t2),
    )


def eigenvalues_sym3x3(A: torch.Tensor, use_trig: bool = True) -> torch.Tensor:
    """Eigenvalues of symmetric 3x3 matrices packed (..., 6) as
    [A11, A12, A13, A22, A23, A33] -> (..., 3), |e3| <= |e2| <= |e1|."""
    e0, e1, e2 = eigenvalues_from_channels(*A.unbind(-1), use_trig=use_trig)
    return torch.stack([e0, e1, e2], dim=-1)


def eigenvalue_feature_channels(a11, a12, a13, a22, a23, a33, use_trig=True,
                                diag_path=True):
    """Channel-wise feature tuple (e1, e2, e3, LoG, curvature, frobenius)."""
    e0, e1, e2 = eigenvalues_from_channels(
        a11, a12, a13, a22, a23, a33, use_trig=use_trig, diag_path=diag_path
    )
    s = e0 + e1 + e2
    prod = e0 * e1 * e2
    frob = torch.sqrt(e0 * e0 + e1 * e1 + e2 * e2)
    return e0, e1, e2, s, prod, frob


def eigenvalue_features(A: torch.Tensor, use_trig: bool = True) -> torch.Tensor:
    """Six eigenvalue-derived features per packed matrix (..., 6) ->
    (..., 6): [e1, e2, e3, sum, product, frobenius] — the reference's
    EigenvalueFeaturesFunctor (EigenvalueFeaturesFunctor.h:20-31)."""
    return torch.stack(
        eigenvalue_feature_channels(*A.unbind(-1), use_trig=use_trig), dim=-1
    )


def tie_sorted_eigenvalues(got, ref, margin):
    """The three eigenvalue channels of two computations (e1, e2, e3,
    ordered |e3| <= |e2| <= |e1|) made comparable channel by channel:
    returns (got', ref'), lists of three tensors. Where the reference's
    adjacent magnitudes differ by more than `margin` (absolute, in the
    channels' units) both keep their channels, so an eigenvalue in the
    wrong channel shows as that channel's error; where they differ by less
    (a tie or near tie, whose order follows the rounding of the field and
    differs between the trig and the polynomial eigen paths) both triples
    are sorted by value. With margin at least twice the error a comparison
    allows, an implementation within that error of the reference's values
    cannot order the channels otherwise outside the margin."""
    g = [torch.as_tensor(x) for x in got]
    r = [torch.as_tensor(x) for x in ref]
    a = [x.abs() for x in r]
    tie = ((a[0] - a[1]).abs() <= margin) | ((a[1] - a[2]).abs() <= margin)
    gs, rs = value_sorted3(*g), value_sorted3(*r)
    return ([torch.where(tie, gs[k], g[k]) for k in range(3)],
            [torch.where(tie, rs[k], r[k]) for k in range(3)])


def value_sorted3(a, b, c):
    """(lo, mid, hi) of three tensors elementwise, by min / max alone."""
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = torch.maximum(torch.minimum(a, b),
                        torch.minimum(torch.maximum(a, b), c))
    return lo, mid, hi
