"""Check of a feature pass: every channel of every scale of each kept scan
against the float64 reference over the whole volume.

Three numbers, each the worst over the kept scans and the scales:
  blur_err  GaussianBlur: max |got - ref| / max(max |ref|, 1);
  grad_err  GradientMagnitude, the same;
  eig_err   the six eigenvalue channels, each against its own scale
            (Eigenvalue1-3 share the scale of the largest |e|). The three
            eigenvalues are compared channel by channel, except where the
            reference's adjacent |e_k| lie within 2 x limit x scale of each
            other: there both triples are compared sorted by value, since
            within the limit a tie may fall either way; outside that margin
            an eigenvalue in the wrong channel fails.
A NaN anywhere reads as inf.
"""
from __future__ import annotations

import torch

from ifebench import reference

NAMES = ("blur_err", "grad_err", "eig_err")


def _scale(ref):
    return max(float(ref.abs().max()), 1.0)


def _err(got, ref, scale):
    d = (got.to(ref.dtype) - ref).abs().nan_to_num(nan=float("inf"))
    return float(d.max()) / scale


def _sorted3(a, b, c):
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = torch.maximum(torch.minimum(a, b),
                        torch.minimum(torch.maximum(a, b), c))
    return lo, mid, hi


def compare_scale(got, ref, eig_limit, chunk=64):
    """{name: reading} of one scale: `got` 8 channels (X, Y, Z), `ref`
    (8, X, Y, Z) float64."""
    out = dict.fromkeys(NAMES, 0.0)
    scales = [_scale(ref[k]) for k in range(reference.N_FEATURES)]
    s_eig = max(scales[2:5])
    margin = 2.0 * eig_limit * s_eig
    for x0 in range(0, ref.shape[1], chunk):
        sl = slice(x0, x0 + chunk)
        g = [got[k][sl].to(torch.float64) for k in range(reference.N_FEATURES)]
        r = [ref[k][sl] for k in range(reference.N_FEATURES)]
        out["blur_err"] = max(out["blur_err"], _err(g[0], r[0], scales[0]))
        out["grad_err"] = max(out["grad_err"], _err(g[1], r[1], scales[1]))
        a = [x.abs() for x in r[2:5]]
        tie = ((a[0] - a[1]).abs() <= margin) | ((a[1] - a[2]).abs() <= margin)
        gs, rs = _sorted3(*g[2:5]), _sorted3(*r[2:5])
        for k in range(3):
            ge = torch.where(tie, gs[k], g[2 + k])
            re = torch.where(tie, rs[k], r[2 + k])
            out["eig_err"] = max(out["eig_err"], _err(ge, re, s_eig))
        for k in range(5, 8):
            out["eig_err"] = max(out["eig_err"], _err(g[k], r[k], scales[k]))
    return out


def check(run, held, limits):
    """(readings, compared, failed) over the kept scans."""
    readings = dict.fromkeys(NAMES, 0.0)
    failed = 0
    for _, slot, outs in held:
        image, mask = run.scan_tensors(slot)
        worst = dict.fromkeys(NAMES, 0.0)
        for sigma, got in zip(run.sigmas, outs):
            ref = reference.features_region(image, mask, sigma, run.spacing,
                                            run.truncate)
            for k, v in compare_scale(got, ref, limits["eig_err"]).items():
                worst[k] = max(worst[k], v)
            del ref
        failed += any(not worst[k] <= limits[k] for k in NAMES)
        for k in NAMES:
            readings[k] = max(readings[k], worst[k])
    return readings, len(held), failed
