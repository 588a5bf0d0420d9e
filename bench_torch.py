#!/usr/bin/env python3
"""Benchmark of ife_tpu_torch: Hessian + closed-form eigen features,
voxels/sec on one card (the port's counterpart of bench.py).

    python3 bench_torch.py                 # the headline line (+ the gate)
    python3 bench_torch.py --verify        # the on-card verify gate alone
    python3 bench_torch.py --all [--resume] [--out PATH]   # BASELINE.md
                                           # configs 1-4 -> PATH
                                           # (BENCH_DETAIL_TORCH.json)

Runs on the card default_device() picks; a host without a card exits
non-zero unless IFE_PLATFORM=cpu asks for the CPU (smaller shapes there, as
bench.py shrinks off the TPU). Inputs come from a seeded torch.Generator on
the device.

The headline prints one JSON line with bench.py's keys: `metric` (naming
the card), `value` (voxels / s of fused_hessian_eig_stream's first channel
on a 512^3 f32 volume, by the median device ms), `unit`, `vs_baseline`
(over the pinned host-NumPy baseline of BASELINE_CPU.json), `baseline`,
`spread` (from the fastest and slowest of 5 runs) and, on a card, `verify`;
beside them `ms` (device and call (median, min, max) ms) and `device` (the
card's name and power limit). Every mode's line (and the --all artifact)
ends with `launches`, the kernels the run launched (kernels.LAUNCHES). Times are utils.profiling's: device ms, 10
back-to-back calls behind queued work, median of 5, and call ms, one call
on an idle card (on the CPU, the host clock's wall_ms).

verify_on_card holds every kernel this path dispatches, on f32 inputs,
against the port's composed plain ops in f64 on the same device, entry by
entry as bench.py's verify_on_chip, each within 1e-4 relative; the
eigenvalues also per channel outside ties. Any failure, in the gate or in a config, exits non-zero: no
fallback to another path or a smaller shape.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from ife_tpu_torch.kernels import LAUNCHES, reset_launches
from ife_tpu_torch.parallel.mesh import default_device
from ife_tpu_torch.utils.profiling import card, cuda_ms, device_ms, wall_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_FILE = os.path.join(ROOT, "BASELINE_CPU.json")
DEFAULT_OUT = "BENCH_DETAIL_TORCH.json"
SPACING = (0.78, 0.78, 1.0)
TOL = 1e-4        # bench.py's on-chip bound, relative to max(max|ref|, 1)
REPS = 5          # timed runs per measurement (median, min, max)
CALLS = 10        # back-to-back calls per timed run (device ms, wall ms)
# shapes by device type: bench.py's on the TPU for the card, its smaller
# ones off the TPU for the CPU
HEADLINE_SHAPE = {"cuda": (512, 512, 512), "cpu": (128, 128, 128)}
CONFIG1_SHAPE = (64, 64, 64, 6)
CONFIG2_SHAPE = (128, 128, 128)
CONFIG3_SHAPE = {"cuda": (256, 256, 256), "cpu": (64, 64, 64)}
CONFIG4_SHAPE = {"cuda": (512, 512, 512), "cpu": (64, 64, 64)}
GATE_SHAPE = (128, 128, 128)
CONFIG3_SCALES = (0.6, 1.2, 2.4, 4.8)
CONFIG4_EDGES = np.linspace(-1200.0, 600.0, 31)
# the gate's two sweep scales: bench.py's sigma 1.0 and, in place of its 3.5
# (x radius 21), 1.7, the largest the card's sweep takes (x radius 10,
# kernels.features8_sweep.SWEEP_MAX_RX)
GATE_SWEEP_SIGMAS = ((1.0, ""), (1.7, "_s1.7"))
GATE_AUTO_SIGMAS = (1.0, 2.4, 4.8)
GATE_HIST_EDGES = np.linspace(-1100.0, 300.0, 31).astype(np.float32)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def normal(shape, device, seed, scale=1.0, offset=0.0):
    """f32 standard normal * scale + offset, from torch.Generator(seed)."""
    x = torch.randn(shape, generator=generator(device, seed), device=device)
    return x * scale + offset


def random_mask(shape, device, seed):
    """f32 0/1, 1 where a uniform draw exceeds 0.25 (~75 % inside)."""
    u = torch.rand(shape, generator=generator(device, seed), device=device)
    return (u > 0.25).to(torch.float32)


# ---------------------------------------------------------------------------
# the timed functions
# ---------------------------------------------------------------------------

def headline_card(x, spacing=SPACING):
    """bench.py's on-chip op (bench.py:102-104): the Hessian kernel's first
    eigenvalue channel, its polynomial eigen path."""
    from ife_tpu_torch.kernels.hessian_eig import fused_hessian_eig_stream

    return fused_hessian_eig_stream(x, spacing, stack=False)[0]


def headline_cpu(x, spacing=SPACING):
    """bench.py's op off the chip (bench.py:106-107): the composed ops'
    first eigenvalue channel."""
    from ife_tpu_torch.ops.features import hessian_eig_features

    return hessian_eig_features(x, spacing)[..., 0]


def headline_op(x, spacing=SPACING):
    return (headline_card if x.is_cuda else headline_cpu)(x, spacing)


def config1_op(h):
    """Config 1: the eigen solver's six features of a packed Hessian field
    (..., 6) (bench.py:443-449)."""
    from ife_tpu_torch.ops.eigen import eigenvalue_features

    return eigenvalue_features(h)


def one_scale8(v, m, sigma, spacing=SPACING):
    """features8 at one scale as a tuple of 8 channels (bench.py:466-477):
    the sweep kernel where features8_dispatch_branch names it, else
    ops.features.fused_features8 (the xs-stream or nc + post branch). CPU
    tensors run the kernels' plain twins."""
    from ife_tpu_torch.kernels.features8_sweep import fused_features8_sweep
    from ife_tpu_torch.ops.features import (
        features8_dispatch_branch, fused_features8)

    k = (fused_features8_sweep
         if features8_dispatch_branch(sigma, spacing, v.shape) == "sweep"
         else fused_features8)
    return k(v, m, sigma, spacing, stack=False)


def config3_per_scale(v, m, spacing=SPACING):
    """Config 3, per scale: one_scale8 at each of CONFIG3_SCALES; a tuple of
    four 8-channel tuples (bench.py:489-491 keeps channel 0 of each)."""
    return tuple(one_scale8(v, m, s, spacing) for s in CONFIG3_SCALES)


def config3_fused(v, m, spacing=SPACING):
    """Config 3, bench.py's fused form (bench.py:506-513): the sweep at 0.6
    and 1.2, then multiscale_features8_fused at (2.4, 4.8), whose last
    kernel is one ys_multi launch for both scales."""
    from ife_tpu_torch.kernels.features8_sweep import fused_features8_sweep
    from ife_tpu_torch.ops.features import multiscale_features8_fused

    small = tuple(fused_features8_sweep(v, m, s, spacing, stack=False)
                  for s in CONFIG3_SCALES[:2])
    return small + tuple(multiscale_features8_fused(
        v, m, CONFIG3_SCALES[2:], spacing, stack=False))


def config4_weights(m):
    """The int32 mask weights of config 4 (bench.py:555)."""
    return m.reshape(-1).to(torch.int32)


def config4_counts(chans, v, w, edges=CONFIG4_EDGES):
    """Config 4's binning (bench.py:569-574): the 8 feature channels and the
    volume in one histogram_counts_multi pass; (9, E + 1) int32."""
    from ife_tpu_torch.kernels.histogram import histogram_counts_multi

    return histogram_counts_multi(list(chans) + [v], edges, weights=w)


def config4_composed(v, m, edges=CONFIG4_EDGES, spacing=SPACING):
    """Config 4's composed form in one Python call (bench.py:599-606): the
    features at sigma 1.0, then stats.histogram.histogram_counts of each
    channel under the mask; (8, E + 1) int32."""
    from ife_tpu_torch.stats.histogram import histogram_counts

    chans = one_scale8(v, m, 1.0, spacing)
    w = (m != 0).reshape(-1).to(torch.int32)
    return torch.stack([histogram_counts(c.reshape(-1), edges, weights=w)
                        for c in chans])


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def timed(fn, device):
    """{"device": (median, min, max) ms, "call": ...} on a card (device_ms,
    cuda_ms); {"host": ...} on the CPU (wall_ms)."""
    if device.type == "cuda":
        return {"device": device_ms(fn, CALLS, REPS),
                "call": cuda_ms(fn, REPS)}
    return {"host": wall_ms(fn, CALLS, REPS)}


def pass_ms(times):
    """(median, min, max) ms a value is computed from: device ms on a card,
    the host's ms on the CPU."""
    return times["device"] if "device" in times else times["host"]


def device_info(device):
    """The device's name and power limit (nvidia-smi's) for the artifact."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    return card()


# ---------------------------------------------------------------------------
# the verify gate
# ---------------------------------------------------------------------------

def _rel(a, b):
    """max|a - b| / max(max|b|, 1), in f64."""
    a, b = a.double(), b.double()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)


def _sorted_eig_rel(got, ref):
    """Three eigenvalue channels as value-sorted triples (bench.py:185-187)."""
    from ife_tpu_torch.ops.eigen import value_sorted3

    scale = max(max(r.double().abs().max().item() for r in ref), 1.0)
    return max((g.double() - r.double()).abs().max().item()
               for g, r in zip(value_sorted3(*got), value_sorted3(*ref))) / scale


def _channel_eig_rel(got, ref):
    """Three eigenvalue channels per channel, value-sorted only where the
    reference's adjacent |e_k| tie within 2 TOL of the triple's scale
    (ops.eigen.tie_sorted_eigenvalues): an eigenvalue in the wrong channel
    outside a tie counts."""
    from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues

    scale = max(max(r.double().abs().max().item() for r in ref), 1.0)
    g, r = tie_sorted_eigenvalues(list(got), list(ref), 2 * TOL * scale)
    return max((a.double() - b.double()).abs().max().item()
               for a, b in zip(g, r)) / scale


def _masked(chans, inside):
    zero = torch.zeros((), dtype=chans[0].dtype, device=chans[0].device)
    return [torch.where(inside, c, zero) for c in chans]


def _feature_errs(got, ref, inside=None):
    """(per-channel relative errors of the 8 channels, eigenvalues as
    sorted triples, eigenvalues per channel outside ties); got and ref are
    sequences of 8 channels, compared inside `inside` when given."""
    got, ref = list(got), list(ref)
    if inside is not None:
        got, ref = _masked(got, inside), _masked(ref, inside)
    direct = [_rel(g, r) for g, r in zip(got, ref)]
    return (direct, _sorted_eig_rel(got[2:5], ref[2:5]),
            _channel_eig_rel(got[2:5], ref[2:5]))


def _worst(got, ref):
    """bench.py's single number of a dispatch entry: the worst of the
    smoothed, gradient and symmetric channels and the sorted eigenvalues,
    here also the eigenvalues per channel outside ties."""
    direct, eig, chan = _feature_errs(got, ref)
    return max(max(direct[k] for k in (0, 1, 5, 6, 7)), eig, chan)


def _edge_layer(v):
    """v inside a one-voxel edge-replicated layer on x and y."""
    return torch.nn.functional.pad(v[None, None], (0, 0, 1, 1, 1, 1),
                                   mode="replicate")[0, 0].contiguous()


def gate_inputs(shape, device):
    """bench.py's gate inputs: normal * 200 - 600 and a uniform > 0.25 mask."""
    return (normal(shape, device, 0, 200.0, -600.0),
            random_mask(shape, device, 1))


def verify_on_card(shape=GATE_SHAPE, spacing=SPACING, device=None):
    """Every kernel the port dispatches on this path, on f32 inputs, against
    the composed plain ops on the same device (bench.py's verify_on_chip,
    entry by entry): a dict of relative errors, each < TOL, or
    AssertionError.

    Reference: ops.features.features8, ops.stencil's
    normalized_gaussian_convolution, and hessian_eig_features' composition
    eigenvalue_features(hessian(.)), in f64 where bench.py's are f32: two f32
    computations of one function in different association sit apart by the
    sum of their rounding errors, and at sigma 4.8 that sum reaches the
    bound (multiscale_features8_fused 1.03e-4 from the f32 ops on an H100,
    each of the two ~6e-5 from the f64 ops), so the gate holds each kernel's
    own error instead. Eigenvalue channels are held as sorted
    triples (bench.py's keys eig_sorted_*) and per channel outside ties (the
    keys eig_channel_* beside them). The second sweep entry runs at sigma
    1.7 (keys *_s1.7), not bench.py's 3.5, which the card's sweep refuses
    (x radius 21 > SWEEP_MAX_RX = 10). Dispatch entries are keyed by the
    branch ops.features.features8_dispatch_branch names; at least three
    distinct branches must be reached."""
    from ife_tpu_torch.kernels.features8_post import (
        fused_features8_post_stream)
    from ife_tpu_torch.kernels.features8_sweep import fused_features8_sweep
    from ife_tpu_torch.kernels.hessian_eig import (
        fused_hessian_eig, fused_hessian_eig_stream)
    from ife_tpu_torch.kernels.histogram import (
        histogram_counts_kernel, histogram_counts_multi)
    from ife_tpu_torch.kernels.normalized_conv import (
        fused_normalized_conv_sweep)
    from ife_tpu_torch.ops.eigen import eigenvalue_features
    from ife_tpu_torch.ops.features import (
        features8, features8_auto_channels, features8_dispatch_branch,
        multiscale_features8_fused)
    from ife_tpu_torch.ops.stencil import (
        hessian, normalized_gaussian_convolution)
    from ife_tpu_torch.parallel.features import sharded_features8
    from ife_tpu_torch.parallel.mesh import make_mesh, shard_volume
    from ife_tpu_torch.stats.histogram import (
        snap_pow2_grid, uniform_histogram_counts)

    dev = default_device(device)
    spacing = tuple(float(h) for h in spacing)
    img, msk = gate_inputs(tuple(shape), dev)
    inside = msk != 0
    report = {}

    refs = {}

    def plain8(v, m, sigma):
        """The composed op's 8 channels in f64, once per (volume, scale)."""
        key = (tuple(v.shape), sigma)
        if key not in refs:
            refs[key] = features8(v.double(), m.double(), sigma,
                                  spacing).unbind(-1)
        return refs[key]

    # the sweep kernel at two scales against the composed op
    for sigma, tag in GATE_SWEEP_SIGMAS:
        direct, eig, chan = _feature_errs(
            fused_features8_sweep(img, msk, sigma, spacing, stack=False),
            plain8(img, msk, sigma))
        for name, k in (("smoothed", 0), ("gradmag", 1), ("log", 5),
                        ("gausscurv", 6), ("frobenius", 7)):
            report[name + tag] = direct[k]
        report["eig_sorted_features8" + tag] = eig
        report["eig_channel_features8" + tag] = chan

    # the normalized convolution at sigma 4.8, inside the mask (NaN off
    # the certainty's support in both)
    nc = fused_normalized_conv_sweep(img, msk, 4.8, spacing)
    ncw = normalized_gaussian_convolution(img.double(), msk.double(), 4.8,
                                          spacing)
    report["nc_sweep_s48"] = _rel(*_masked([nc, ncw], inside))

    # the post kernel, whole, pre_padded and with the face rows as x_halo
    s = normalized_gaussian_convolution(img, msk, 1.0, spacing).contiguous()
    ref8 = plain8(img, msk, 1.0)
    direct, _, _ = _feature_errs(
        fused_features8_post_stream(s, msk, spacing, stack=False), ref8,
        inside)
    report["post_stream_smoothed"] = direct[0]
    report["post_stream_frobenius"] = direct[7]
    direct, eig, chan = _feature_errs(fused_features8_post_stream(
        _edge_layer(s), msk, spacing, stack=False, pre_padded=True), ref8,
        inside)
    report["post_stream_prepad_frobenius"] = direct[7]
    report["post_stream_prepad_eig_sorted"] = eig
    report["post_stream_prepad_eig_channel"] = chan
    direct, _, _ = _feature_errs(fused_features8_post_stream(
        s, msk, spacing, stack=False, x_halo=(s[:1], s[-1:])), ref8, inside)
    report["post_stream_x_halo_frobenius"] = direct[7]

    # the Hessian kernel: whole (both entries), on an edge-extended block
    # with the core sliced out, and with the face rows as x_halo
    href = eigenvalue_features(hessian(img.double(), spacing)).unbind(-1)[:3]
    ext = fused_hessian_eig_stream(_edge_layer(img), spacing, stack=False)
    for key, got in (
            ("hessian_eig", fused_hessian_eig(img, spacing, stack=False)),
            ("hessian_eig_stream",
             fused_hessian_eig_stream(img, spacing, stack=False)),
            ("stream_ext_slice", [o[1:-1, 1:-1] for o in ext]),
            ("stream_x_halo", fused_hessian_eig_stream(
                img, spacing, stack=False, x_halo=(img[:1], img[-1:])))):
        report["eig_sorted_" + key] = _sorted_eig_rel(got[:3], href)
        report["eig_channel_" + key] = _channel_eig_rel(got[:3], href)

    # the histogram kernel against searchsorted + scatter_add, and the
    # multi-channel form against the one-channel kernel: counts equal
    e = GATE_HIST_EDGES
    w = inside.reshape(-1).to(torch.int32)
    hp = histogram_counts_kernel(img.reshape(-1), e, w)
    idx = torch.searchsorted(torch.from_numpy(e).to(dev), img.reshape(-1))
    oracle = torch.zeros(e.size + 1, dtype=torch.int64, device=dev)
    oracle.scatter_add_(0, idx, w.to(torch.int64))
    report["hist_pallas_max_abs_count_err"] = float(
        (hp.to(torch.int64) - oracle).abs().max().item())
    hm = histogram_counts_multi([img.reshape(-1), s.reshape(-1)], e, w)
    hs = histogram_counts_kernel(s.reshape(-1), e, w)
    report["hist_multi_max_abs_count_err"] = float(max(
        (hm[0] - hp).abs().max().item(), (hm[1] - hs).abs().max().item()))

    # the dispatch entry at three scales, keyed by branch
    branches = {}
    for sigma in GATE_AUTO_SIGMAS:
        br = branches[sigma] = features8_dispatch_branch(sigma, spacing,
                                                         img.shape)
        report[f"auto_s{sigma}[{br}]"] = _worst(
            features8_auto_channels(img, msk, sigma, spacing),
            plain8(img, msk, sigma))
    if len(set(branches.values())) < 3:
        raise AssertionError(f"verify_on_card: the gate's scales reach "
                             f"fewer than 3 branches: {branches}")

    # an unaligned shape (bench.py's [:, :124, :120] of 128^3)
    X, Y, Z = img.shape
    img_u = img[:, :Y - 4, :Z - 8].contiguous()
    msk_u = msk[:, :Y - 4, :Z - 8].contiguous()
    br = features8_dispatch_branch(1.0, spacing, img_u.shape)
    report[f"auto_unaligned_s1.0[{br}]"] = _worst(
        features8_auto_channels(img_u, msk_u, 1.0, spacing),
        plain8(img_u, msk_u, 1.0))

    # the multi-scale path: both scales out of one ys_multi launch
    multi = multiscale_features8_fused(img, msk, (2.4, 4.8), spacing,
                                       stack=False)
    for sigma, got in zip((2.4, 4.8), multi):
        report[f"ys_multi_s{sigma}[ys_multi]"] = _worst(
            got, plain8(img, msk, sigma))

    # the block path of sharded_features8 on a one-block mesh
    mesh1 = make_mesh(1, device=dev)
    iv, mv = shard_volume(img, mesh1), shard_volume(msk, mesh1)
    for sigma in (1.0, 2.4):
        br = ("sharded_block_sweep"
              if features8_dispatch_branch(sigma, spacing, None) == "sweep"
              else "sharded_block_nc_conv+post")
        got = sharded_features8(iv, mv, sigma, mesh1, spacing,
                                use_fused=True, stack=False)
        report[f"sharded_s{sigma}[{br}]"] = _worst(
            [c.blocks[0] for c in got], plain8(img, msk, sigma))

    # the fine histogram's arithmetic binning against the kernel's counts
    # on the same snapped grid
    mfh, kfh, bounds = snap_pow2_grid(-1100.0, 500.0, 4096)
    fine = uniform_histogram_counts(img, w, mfh, math.ldexp(1.0, kfh), 4096)
    raw = histogram_counts_kernel(img.reshape(-1), bounds, w)
    merged = raw[1:4097].clone()
    merged[0] += raw[0]
    report["fine_hist_mxu_max_abs_count_err"] = float(
        (fine - merged).abs().max().item())

    bad = {k: v for k, v in report.items() if not v < TOL}
    if bad:
        raise AssertionError(f"verify_on_card: entries at or over {TOL}: "
                             f"{bad}; report {report}")
    return report


# ---------------------------------------------------------------------------
# the three modes
# ---------------------------------------------------------------------------

def pinned_baseline():
    """The pinned host-NumPy throughput of BASELINE_CPU.json (voxels / s)."""
    with open(BASELINE_FILE) as f:
        return float(json.load(f)["voxels_per_sec"])


def headline(device):
    """The headline line as a dict (bench.py's main, without its
    fallbacks)."""
    shape = HEADLINE_SHAPE[device.type]
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    x = normal(shape, device, 0)
    times = timed(lambda: headline_op(x), device)
    med, best, worst = pass_ms(times)
    n = float(np.prod(shape))
    value = n / (med * 1e-3)
    result = {
        "metric": (f"hessian_eig_voxels_per_sec_chip_{shape[0]}cubed_"
                   f"{kind.replace(' ', '_')}"),
        "value": value,
        "unit": "voxels/sec/chip",
        "vs_baseline": value / pinned_baseline(),
        "baseline": "pinned",
        "spread": {"best": n / (best * 1e-3), "worst": n / (worst * 1e-3),
                   "reps": REPS},
        "ms": times,
        "device": device_info(device),
    }
    del x
    if device.type == "cuda":
        torch.cuda.empty_cache()
        result["verify"] = verify_on_card(device=device)
    return result


def _dump(detail, out_path):
    """Write the artifact (after every config, and on a failure)."""
    with open(out_path, "w") as f:
        json.dump(detail, f, indent=1)


def bench_all(device, out_path=DEFAULT_OUT, resume=False):
    """BASELINE.md configs 1-4 and the gate before config 4, into one JSON
    artifact under bench.py's keys (plus `power_limit_w`), written after
    every config. resume: keep an existing artifact's configs and run only
    the missing ones. A failing config writes the artifact, then raises."""
    info = device_info(device)
    detail = {}
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            detail.update(json.load(f))
    detail.update(device=info["name"], power_limit_w=info["power_limit_w"],
                  platform="gpu" if device.type == "cuda" else "cpu")

    def have(name):
        return resume and any(
            (k == name or k.startswith(name + "_")) and k != name + "_error"
            for k in detail)

    def run(name, fn):
        """fn's keys into the artifact, or name_error and a raise."""
        if have(name):
            return
        try:
            detail.update(fn())
            detail.pop(name + "_error", None)
        except Exception as e:
            detail[name + "_error"] = f"{type(e).__name__}: {str(e)[:160]}"
            _dump(detail, out_path)
            raise
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"{name} done: {json.dumps(detail)}", file=sys.stderr,
              flush=True)
        _dump(detail, out_path)

    def config1():
        h = normal(CONFIG1_SHAPE, device, 0)
        med = pass_ms(timed(lambda: config1_op(h), device))[0]
        n = float(np.prod(CONFIG1_SHAPE[:3]))
        return {"config1_eigen_64cubed_voxels_per_sec": n / (med * 1e-3)}

    def config2():
        x = normal(CONFIG2_SHAPE, device, 0)
        med = pass_ms(timed(lambda: headline_op(x), device))[0]
        n = float(np.prod(CONFIG2_SHAPE))
        return {"config2_hessian_eig_128cubed_voxels_per_sec":
                n / (med * 1e-3)}

    def config3():
        shape = CONFIG3_SHAPE[device.type]
        v = normal(shape, device, 0, 200.0, -600.0)
        m = random_mask(shape, device, 1)
        per = pass_ms(timed(lambda: config3_per_scale(v, m), device))[0]
        fused = pass_ms(timed(lambda: config3_fused(v, m), device))[0]
        vox4 = float(np.prod(shape)) * len(CONFIG3_SCALES)
        return {"config3_per_scale_voxels_per_sec": vox4 / (per * 1e-3),
                "config3_fused_voxels_per_sec": vox4 / (fused * 1e-3),
                "config3_multiscale4_features8_voxels_per_sec":
                    vox4 / (min(per, fused) * 1e-3),
                "config3_shape": list(shape)}

    def gate():
        return {"verify_on_chip": verify_on_card(device=device)}

    def config4():
        shape = CONFIG4_SHAPE[device.type]
        v = normal(shape, device, 0, 200.0, -600.0)
        m = random_mask(shape, device, 2)
        feat = pass_ms(timed(lambda: one_scale8(v, m, 1.0), device))[0]
        chans = one_scale8(v, m, 1.0)
        w = config4_weights(m)
        hist = pass_ms(timed(lambda: config4_counts(chans, v, w), device))[0]
        del chans, w
        composed = pass_ms(timed(lambda: config4_composed(v, m), device))[0]
        return {"config4_feat_ms": feat, "config4_hist_ms": hist,
                "config4_features_plus_hist_512cubed_voxels_per_sec":
                    float(np.prod(shape)) / ((feat + hist) * 1e-3),
                "config4_shape": list(shape),
                "config4_composed_one_jit_ms": composed}

    run("config1", config1)
    run("config2", config2)
    run("config3", config3)
    run("verify_on_chip", gate)
    run("config4", config4)
    return detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--verify", action="store_true",
                    help="run the on-card verify gate alone")
    ap.add_argument("--all", action="store_true",
                    help="BASELINE.md configs 1-4 into --out")
    ap.add_argument("--resume", action="store_true",
                    help="with --all: run only the configs --out lacks")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"with --all: the artifact (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    try:
        device = default_device()
    except RuntimeError as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1
    reset_launches()
    if args.verify:
        out = {"verify": "ok", **verify_on_card(device=device)}
    elif args.all:
        out = bench_all(device, args.out, args.resume)
    else:
        out = headline(device)
    # the kernels this run launched (none on the CPU, where the twins run)
    out["launches"] = {k: v for k, v in LAUNCHES.items() if v}
    if args.all:
        _dump(out, args.out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
