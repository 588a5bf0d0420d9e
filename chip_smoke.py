#!/usr/bin/env python3
"""Smoke test of ife_tpu_torch on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device of compute
capability 9.0, nvcc and nvidia-smi. Phases, one line (or a few) each; any
failing phase exits non-zero:

  1. device   torch/CUDA/nvcc versions, the card's name and power limit;
  2. build    compile the CUDA kernels of ife_tpu_torch/csrc (timed);
  3. kernels  each kernel against its plain PyTorch twin on the card, at
              (128,124,120) and (64,64,64), spacing (0.78,0.78,1.0) and
              (0.7,0.9,1.2), sigma 0.6/1.2/2.4/4.8 (the sweep and xs-stream
              kernels where their rings fit shared memory); the histogram
              kernel over the features8 channels, whole-volume and box
              forms, E 1/31/4096, weighted and not, with NaN, +-inf and
              duplicate edges, once on its global-memory path;
  4. main     two paths of user entry points, the launch counters reset
              before each and read after it. Features: the CLI
              (extract-features -s 0.6 2.4, hessian-features --fused) on a
              256x256x128 NIfTI, outputs checked against the plain f64 ops,
              then features8_auto_channels at sigma 1.2 and 4.8 and
              hessian_eig_features at 512^3. Bags: the CLI generate-rois,
              determine-bin-edges -s 0.6 2.4 --bins 32 over two volumes,
              make-bag --device and make-bag with that spec; the spec
              checked against the plain twins' pipeline, the device bag
              against the host bag. Every kernel must have launched;
  5. full     512^3 f32: kernel and plain times (CUDA events, median of 5
              with spread) and kernel-vs-plain checks per kernel and sigma,
              the features8 pass per sigma, the device's copy rate, and
              the histogram kernel at the bench.py config-4 shape (8
              channels, 31 edges, mask weights: the sphere, and bench.py's
              random 75% mask), at 4096 edges, and on 50 ROIs of 41^3 per
              sigma beside the feature pass;
  6. profile  device time per CUDA kernel launch of one features8 pass per
              sigma, one Hessian+eig pass and one config-4 histogram
              (torch.profiler, 3 calls each).

Kernel vs plain twin: the kernels are built without FMA contraction and
keep their twins' association, so each must equal its twin to the bit (NaN
where the twin is NaN; the histogram kernel's integer counts exactly); the relative error bench.py defines,
max|kernel - plain| / max(max|plain|, 1) per channel with eigenvalue
channels as value-sorted triples and the normalized convolution inside the
mask, is printed beside it. The CLI outputs are held against the plain f64
ops within 1e-4 of that measure. The line before the last is
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

TOL = 1e-4
SIGMAS = (0.6, 1.2, 2.4, 4.8)
SPACINGS = ((0.78, 0.78, 1.0), (0.7, 0.9, 1.2))
FULL = (512, 512, 512)
FULL_SPACING = (0.78, 0.78, 1.0)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "hessian_eig": ("ife_tpu_torch/csrc/hessian_eig.cu",
                    "ife_tpu/kernels/fused.py:1461"),
    "normalized_conv": ("ife_tpu_torch/csrc/normalized_conv.cu",
                        "ife_tpu/kernels/fused.py:1204"),
    "features8_post": ("ife_tpu_torch/csrc/features8_post.cu",
                       "ife_tpu/kernels/fused.py:1950"),
    "features8_sweep": ("ife_tpu_torch/csrc/features8_sweep.cu",
                        "ife_tpu/kernels/fused.py:2160"),
    "features8_xs_stream": ("ife_tpu_torch/csrc/features8_sweep.cu",
                            "ife_tpu/kernels/fused.py:1545"),
    # the y/z passes ahead of the xs-stream kernel; ife_tpu runs them as
    # XLA band einsums in its fused_features8 (no Pallas kernel there)
    "smooth_yz": ("ife_tpu_torch/csrc/normalized_conv.cu",
                  "ife_tpu/kernels/fused.py:1839"),
    "histogram": ("ife_tpu_torch/csrc/histogram.cu",
                  "ife_tpu/kernels/histogram.py:83"),
}
# the kernels each main path must launch
FEATURE_PATH = ("hessian_eig", "normalized_conv", "features8_post",
                "features8_sweep", "features8_xs_stream", "smooth_yz")
BAG_PATH = ("features8_sweep", "features8_xs_stream", "smooth_yz", "histogram")
# the sigma whose 512^3 times stand in the {"kernels": ...} line: one the
# dispatcher sends to the kernel at 0.78 mm
REPORT_SIGMA = {"normalized_conv": 4.8, "features8_post": 4.8,
                "features8_sweep": 1.2, "features8_xs_stream": 2.4,
                "smooth_yz": 2.4}


class PhaseError(RuntimeError):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _sorted3(a, b, c):
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))
    return lo, mid, hi


def _rel(got, ref):
    """(max|got-ref| / max(max|ref|, 1), max|got-ref|) as floats, in f64."""
    d = (got.double() - ref.double()).abs().max().item()
    return d / max(ref.double().abs().max().item(), 1.0), d


def feature_errors(got, ref, eig=(0, 1, 2)):
    """Worst (relative, absolute) error over a channel tuple; the channels
    at positions `eig` (none or three) are compared as value-sorted
    triples."""
    rel = ab = 0.0
    pairs = [(got[i], ref[i]) for i in range(len(ref)) if i not in eig]
    if eig:
        pairs += zip(_sorted3(*(got[i] for i in eig)),
                     _sorted3(*(ref[i] for i in eig)))
    for g, r in pairs:
        e_rel, e_abs = _rel(g, r)
        rel, ab = max(rel, e_rel), max(ab, e_abs)
    return rel, ab


def bit_equal(got, ref):
    """Every channel equal to the bit, NaN exactly where ref is NaN."""
    return all(bool(((g == r) | (torch.isnan(g) & torch.isnan(r))).all())
               for g, r in zip(got, ref))


def kernel_check(name, got, ref, inside=None):
    """(relative error, absolute error) of a kernel's outputs against its
    twin's; raises unless they are bit-equal. `inside` masks the
    normalized convolution (NaN off the certainty support)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if not bit_equal(got, ref):
        raise PhaseError(f"{name}: kernel differs from its plain twin")
    if inside is not None:
        zero = torch.zeros((), dtype=got[0].dtype, device=got[0].device)
        return _rel(torch.where(inside, got[0], zero),
                    torch.where(inside, ref[0], zero))
    eig = {6: (0, 1, 2), 8: (2, 3, 4)}.get(len(ref), ())
    return feature_errors(got, ref, eig)


def cuda_ms(fn, reps=5):
    """(median, min, max) ms of fn() by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
        del out
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false")
    cc = torch.cuda.get_device_capability(0)
    if cc != (9, 0):
        raise PhaseError(f"compute capability {cc}, need (9, 0) for sm_90a")
    from ife_tpu_torch.kernels._build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {nvcc[-1] if nvcc else 'nvcc ?'}")
    say("device", f"{torch.cuda.get_device_name(0)} cc {cc} "
        f"count {torch.cuda.device_count()}")
    print(card_line(), flush=True)


def phase_build():
    from ife_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    say("build", f"{time.perf_counter() - t0:.1f} s -> {path}")
    log = path.parent / "build.log"
    for line in log.read_text().splitlines() if log.is_file() else []:
        if "registers" in line or "spill" in line or "stack frame" in line:
            say("build", line.strip())


def _inputs(shape, seed, device):
    """A synthetic CT with a sphere mask (the repo's test volumes), f32."""
    from ife_tpu_torch.core.volume import sphere_mask, synthetic_ct

    img = synthetic_ct(shape, seed=seed, device=device).data.contiguous()
    mask = sphere_mask(shape, 0.4, dtype=torch.float32, device=device).data
    return img, mask.contiguous()


def kernel_pairs(img, mask, sigma, sp):
    """(name, kernel call, plain twin call, inside-mask or None) for every
    kernel that takes this scale (the sweep and xs-stream rings must fit a
    block's shared memory), on the inputs the main path gives each: the
    post and xs-stream kernels take the twins' smoothed volumes."""
    from ife_tpu_torch import kernels as K

    s_ref = K.normalized_conv_plain(img, mask, sigma, sp)
    num, den = K.smooth_yz_plain(img, mask, sigma, sp)
    fits = {"features8_sweep": K.sweep_fits(sigma, sp),
            "features8_xs_stream": K.xs_stream_fits(sigma, sp)}
    pairs = [
        ("normalized_conv",
         lambda: K.fused_normalized_conv_sweep(img, mask, sigma, sp),
         lambda: K.normalized_conv_plain(img, mask, sigma, sp), mask != 0),
        ("features8_post",
         lambda: K.fused_features8_post_stream(s_ref, mask, sp, stack=False),
         lambda: K.features8_post_plain(s_ref, mask, sp), None),
        ("features8_sweep",
         lambda: K.fused_features8_sweep(img, mask, sigma, sp, stack=False),
         lambda: K.features8_sweep_plain(img, mask, sigma, sp), None),
        ("smooth_yz",
         lambda: K.fused_smooth_yz(img, mask, sigma, sp),
         lambda: K.smooth_yz_plain(img, mask, sigma, sp), None),
        ("features8_xs_stream",
         lambda: K.fused_features8_xs_stream(num, den, mask, sigma, sp,
                                             stack=False),
         lambda: K.features8_xs_stream_plain(num, den, mask, sigma, sp), None),
    ]
    return [pair for pair in pairs if fits.get(pair[0], True)]


def phase_kernels(errs):
    from ife_tpu_torch import kernels as K

    dev = torch.device("cuda")
    for shape in ((128, 124, 120), (64, 64, 64)):
        img, mask = _inputs(shape, 0, dev)
        for sp in SPACINGS:
            rel, _ = kernel_check("hessian_eig",
                                  K.fused_hessian_eig_stream(img, sp, stack=False),
                                  K.hessian_eig_plain(img, sp))
            errs["hessian_eig"].append(rel)
            line = [f"hessian_eig {rel:.2e}"]
            for sigma in SIGMAS:
                part = []
                for name, kern, plain, inside in kernel_pairs(img, mask, sigma, sp):
                    rel, _ = kernel_check(f"{name} {shape} {sp} s={sigma}",
                                          kern(), plain(), inside)
                    errs[name].append(rel)
                    part.append(f"{name} {rel:.1e}")
                line.append(f"s={sigma}: " + " ".join(part))
            torch.cuda.synchronize()
            say("kernels", f"{shape} spacing {sp}, bit-equal to the twins: "
                + "; ".join(line))
        hist_kernel_checks(img, mask, shape, errs)


def hist_edges(chans, E):
    """(C, E) f64 edges: per channel, evenly spaced order statistics of a
    strided sample, scaled by 1 + 2^-30 so that they are not f32 values
    (they round down to f32), with a run of duplicates and +-inf at the
    ends when E >= 8."""
    rows = []
    for c in chans:
        v = c.reshape(-1)[:: max(1, c.numel() // 65536)]
        v = v[torch.isfinite(v)].double().sort().values
        idx = torch.linspace(0, v.numel() - 1, E, device=v.device).round().long()
        rows.append(v[idx])
    e = torch.stack(rows).cpu() * (1.0 + 2.0 ** -30)
    if E >= 8:
        e[:, 2:6] = e[:, 2:3]
        e[:, 0], e[:, -1] = -float("inf"), float("inf")
    return e


def hist_kernel_checks(img, mask, shape, errs):
    """The histogram kernel against its twin on the features8 channels of
    img (sigma 1.2, the kernels' output, with NaN and +-inf planted):
    whole-volume and box forms, E 1/31/4096, unweighted, mask (uint8) and
    integer (int32) weights; at (64,64,64) also 64 channels x 4097 bins,
    over a block's shared memory: the kernel's global-memory path."""
    import numpy as np

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.kernels.histogram import _plan
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi import generate_random_rois

    chans = list(features8_auto_channels(img, mask, 1.2, SPACINGS[0]))
    chans[1] = chans[1].clone()
    chans[1].view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                          -float("inf")], device=img.device)
    g = torch.Generator(device=img.device).manual_seed(0)
    weights = {"none": None, "mask": (mask != 0).to(torch.uint8),
               "int": torch.randint(0, 4, shape, device=img.device,
                                    dtype=torch.int32, generator=g)}
    size = (17, 15, 13)
    rois = generate_random_rois((mask != 0).cpu().numpy(), 12, size, seed=0)
    starts = [r.index for r in rois] + [(0, 0, 0)]  # the corner: no mask
    line = []
    for E in (1, 31, 4096):
        e = hist_edges(chans, E)
        for wname, w in weights.items():
            got = K.histogram_counts_multi(chans, e, w)
            rel, _ = kernel_check(f"histogram {shape} E={E} w={wname}", got,
                                  K.histogram_counts_multi_plain(chans, e, w))
            errs["histogram"].append(rel)
            got = K.histogram_boxes(chans, w, starts, size, e)
            rel, _ = kernel_check(f"histogram boxes {shape} E={E} w={wname}",
                                  got, K.histogram_boxes_plain(chans, w, starts,
                                                               size, e))
            errs["histogram"].append(rel)
            if wname == "mask" and int(got[-1].sum()) != 0:
                raise PhaseError("histogram: a box with no mask counted voxels")
        line.append(f"E={E} (copies {_plan(8, E, img.numel(), 1, img.device)[0]})")
    if shape == (64, 64, 64):
        wide = chans * 8
        e = hist_edges(wide, 4096)
        if _plan(64, 4096, img.numel(), 1, img.device)[0] != 0:
            raise PhaseError("64 x 4097 bins should take the global path")
        rel, _ = kernel_check("histogram global path 64 x 4096",
                              K.histogram_counts_multi(wide, e, weights["mask"]),
                              K.histogram_counts_multi_plain(wide, e,
                                                             weights["mask"]))
        errs["histogram"].append(rel)
        line.append("64 channels x 4096 edges (global path)")
    torch.cuda.synchronize()
    say("kernels", f"{shape} histogram equal to its twin, whole volume and "
        f"{len(starts)} boxes, unweighted/mask/int32 weights: " + ", ".join(line))


def branch_twin(img, m, sigma, sp):
    """The plain twins of the kernels features8 dispatches to at sigma."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import features8_dispatch_branch

    branch = features8_dispatch_branch(sigma, sp, img.shape)
    if branch == "sweep":
        return K.features8_sweep_plain(img, m, sigma, sp)
    if branch == "xs_stream":
        return K.features8_xs_stream_plain(*K.smooth_yz_plain(img, m, sigma, sp),
                                           m, sigma, sp)
    return K.features8_post_plain(K.normalized_conv_plain(img, m, sigma, sp),
                                  m, sp)


def phase_main(tmp):
    """The user entry points, counters reset first; returns the counts."""
    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.io import read_volume, write_volume
    from ife_tpu_torch.kernels import LAUNCHES, hessian_eig_plain, reset_launches
    from ife_tpu_torch.ops.eigen import eigenvalue_features
    from ife_tpu_torch.ops.features import (
        FEATURE_NAMES, features8, features8_auto_channels,
        features8_dispatch_branch, hessian_eig_features,
    )
    from ife_tpu_torch.ops.stencil import hessian

    shape, sp = (256, 256, 128), FULL_SPACING
    img, mask = _inputs(shape, 1, "cpu")
    img_path, mask_path = os.path.join(tmp, "img.nii.gz"), os.path.join(tmp, "mask.nii.gz")
    write_volume(img_path, Volume(img, spacing=sp))
    write_volume(mask_path, Volume(mask.to(torch.uint8), spacing=sp))
    big_img, big_mask = _inputs(FULL, 2, "cuda")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    for argv in (["extract-features", "-i", img_path, "-m", mask_path,
                  "-o", os.path.join(tmp, "feat"), "-s", "0.6", "2.4"],
                 ["hessian-features", "--fused", "-i", img_path, "-m",
                  mask_path, "-o", os.path.join(tmp, "hess_")]):
        rc = main(argv)
        if rc != 0:
            raise PhaseError(f"CLI {argv[0]} exited {rc}")
    t_cli = time.perf_counter() - t0
    for sigma in (1.2, 4.8):
        feats = features8_auto_channels(big_img, big_mask, sigma, FULL_SPACING)
        del feats
    hess = hessian_eig_features(big_img, FULL_SPACING)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    del hess
    branches = {s: features8_dispatch_branch(s, FULL_SPACING, FULL)
                for s in (0.6, 1.2, 2.4, 4.8)}
    say("main", f"CLI {t_cli:.1f} s on {shape}; branches {branches}; "
        f"launches {launches}")
    missing = [k for k in FEATURE_PATH if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"feature path launched no {missing} kernel")

    # The CLI's files against the plain ops in f64 (the reference
    # semantics, trig eigen path). Every channel but the eigenvalues must be
    # within TOL. Value-sorted eigenvalues of an f32 Hessian carry a
    # sqrt(ulp) noise floor near repeated eigenvalues (docs/design.md
    # "Precision policy"; the synthetic CT has exact ties), so for them the
    # criterion is the repo's own (tests/test_kernels.py): within TOL, or no
    # farther from f64 than twice the kernels' algorithm run as plain ops
    # in f32 (the kernels' twins).
    dev = torch.device("cuda")
    img32, m = img.to(dev), mask.to(dev)
    inside = m != 0
    sp = read_volume(img_path).spacing  # as the CLI saw it: f32 in NIfTI
    checks = []
    for sigma in (0.6, 2.4):
        got = [read_volume(os.path.join(tmp, f"feat_scale_{sigma:g}{n}.nii.gz")
                           ).data.to(dev) for n in FEATURE_NAMES]
        checks.append((
            f"extract-features s={sigma}", got, (2, 3, 4),
            features8(img32.double(), m, sigma, sp).unbind(-1),
            branch_twin(img32, m, sigma, sp)))
    hess_names = ("Eigenvalue1", "Eigenvalue2", "Eigenvalue3",
                  "LaplacianOfGaussian", "GaussianCurvature", "FrobeniusNorm")
    got = [read_volume(os.path.join(tmp, f"hess_{n}.nii.gz")).data.to(dev)
           for n in hess_names]
    checks.append((
        "hessian-features --fused", got, (0, 1, 2),
        [c * inside for c in eigenvalue_features(
            hessian(img32.double(), sp)).unbind(-1)],
        [c * inside for c in hessian_eig_plain(img32, sp)]))
    for name, got, eig, want, twin in checks:
        for g in got:
            if tuple(g.shape) != shape or not bool(torch.isfinite(g).all()):
                raise PhaseError(f"{name}: output not finite or not {shape}")
            if bool((g[~inside] != 0).any()):
                raise PhaseError(f"{name}: nonzero output outside the mask")
        rest = [i for i in range(len(want)) if i not in eig]
        e_rest, _ = feature_errors([got[i] for i in rest],
                                   [want[i] for i in rest], ())
        e_eig, _ = feature_errors([got[i] for i in eig],
                                  [want[i] for i in eig])
        e_twin, _ = feature_errors([twin[i] for i in eig],
                                   [want[i] for i in eig])
        say("main", f"{name}: {len(got)} files finite, zero outside the "
            f"mask; from the f64 plain ops: other channels {e_rest:.2e}, "
            f"sorted eigenvalues {e_eig:.2e} (the kernels' f32 twins: "
            f"{e_twin:.2e})")
        if e_rest > TOL or e_eig > max(TOL, 2 * e_twin):
            raise PhaseError(f"{name}: too far from the f64 plain ops")
    return launches, big_img, big_mask


def phase_bags(tmp):
    """The bag path of user entry points on the 256x256x128 NIfTI pair of
    phase_main and a second volume (seed 3), counters reset first; returns
    the counts."""
    import numpy as np

    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.io import read_hist_spec, read_rois, read_volume, write_volume
    from ife_tpu_torch.kernels import LAUNCHES, reset_launches
    from ife_tpu_torch.roi.bag import make_bag, make_bag_device
    from ife_tpu_torch.stats.equalize import determine_edges_for_equalized_histogram

    shape = (256, 256, 128)
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    img3, _ = _inputs(shape, 3, "cpu")
    write_volume(path("img3.nii.gz"), Volume(img3, spacing=FULL_SPACING))
    with open(path("pairs.txt"), "w") as f:
        f.write(f"{path('img.nii.gz')},{path('mask.nii.gz')}\n"
                f"{path('img3.nii.gz')},{path('mask.nii.gz')}\n")
    bag_args = ["-i", path("img.nii.gz"), "-m", path("mask.nii.gz"), "-b",
                path("spec.txt"), "-s", "0.6", "2.4", "-n", "50",
                "--roi-size", "41,41,41", "--seed", "0"]
    runs = [["generate-rois", "-m", path("mask.nii.gz"), "-o", path("gen.roi"),
             "-n", "50", "--size", "41,41,41", "--seed", "0"],
            ["determine-bin-edges", "-l", path("pairs.txt"), "-o",
             path("spec.txt"), "-s", "0.6", "2.4", "--bins", "32"],
            ["make-bag", "--device", *bag_args, "-o", path("dev")],
            ["make-bag", *bag_args, "-o", path("host")]]
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for argv in runs:
        t0 = time.perf_counter()
        if main(argv) != 0:
            raise PhaseError(f"CLI {argv[0]} exited non-zero")
        torch.cuda.synchronize()
        secs.append(f"{' '.join(argv[:2])} {time.perf_counter() - t0:.1f} s")
    launches = dict(LAUNCHES)
    say("bags", "; ".join(secs) + f"; launches {launches}")
    missing = [k for k in BAG_PATH if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"bag path launched no {missing} kernel")

    # the spec against the same pipeline through the plain twins
    spec = read_hist_spec(path("spec.txt"))
    if len(spec) != 16 or any(r.size != 31 or not np.isfinite(r).all()
                              or (np.diff(r) < 0).any() for r in spec):
        raise PhaseError("spec: not 16 finite non-decreasing rows of 31 edges")
    samples = [[] for _ in range(16)]
    for name in ("img.nii.gz", "img3.nii.gz"):
        vol = read_volume(path(name))
        fg = read_volume(path("mask.nii.gz")).data.cuda() == 1
        x = vol.data.cuda().float().contiguous()
        for i, sigma in enumerate((0.6, 2.4)):
            twin = branch_twin(x, fg.float(), sigma, vol.spacing)
            for k in range(8):
                samples[i * 8 + k].append(twin[k][fg].cpu().numpy())
    want = [determine_edges_for_equalized_histogram(
        np.sort(np.concatenate(v)), 32) for v in samples]
    if not all(np.array_equal(a, b) for a, b in zip(spec, want)):
        raise PhaseError("spec differs from the plain twins' pipeline")

    # the bags: the CLI's ROIs are generate-rois'; the device bag equals
    # the host bag within the f32 division; every histogram sums to 1
    with open(path("gen.roi")) as a, open(path("dev.ROIInfo")) as b:
        if a.read() != b.read():
            raise PhaseError("make-bag drew other ROIs than generate-rois")
    vol, mask = read_volume(path("img.nii.gz")), read_volume(path("mask.nii.gz"))
    rois = read_rois(path("dev.ROIInfo"))
    args = (vol.numpy(), mask.numpy(), [0.6, 2.4], spec, rois)
    dev_bag = make_bag_device(*args, spacing=vol.spacing)
    host_bag = make_bag(*args, spacing=vol.spacing)
    d = float(np.abs(dev_bag - host_bag).max())
    sums = dev_bag.reshape(len(rois), 16, 32).sum(-1)
    masked = np.asarray([(mask.numpy()[r.slices()] != 0).any() for r in rois])
    s_err = float(np.abs(sums[masked] - 1.0).max())
    csv = [np.loadtxt(path(f"{n}.bag"), delimiter=",") for n in ("dev", "host")]
    c_err = max(float((np.abs(c - b) / np.maximum(np.abs(b), 1e-30)).max())
                for c, b in zip(csv, (dev_bag, host_bag)))
    say("bags", f"spec equal to the plain twins' pipeline; bag {dev_bag.shape}, "
        f"device vs host max |d| {d:.3g} (<= 2^-23), histogram sums within "
        f"{s_err:.3g} of 1 ({int(masked.sum())} ROIs with mask), CSV files "
        f"within {c_err:.3g} (relative) of the bags")
    if d > 2.0 ** -23 or s_err > 1e-5 or c_err > 5.01e-6 or not masked.any():
        raise PhaseError("bags: device and host bags disagree, a histogram "
                         "does not sum to 1, or a CSV file is off")
    return launches


def timed(label, fn):
    med, lo, hi = cuda_ms(fn)
    say("full", f"{label}: {med:.3f} ms (min {lo:.3f}, max {hi:.3f})")
    return med


def phase_full(img, mask, errs, results):
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import (
        features8_auto_channels, features8_dispatch_branch,
    )

    sp = FULL_SPACING
    nvox = img.numel()

    copy_ms = timed("copy_ of one 512^3 f32 volume (device copy rate)",
                    lambda: torch.empty_like(img).copy_(img))
    say("full", f"copy rate {2 * 4 * nvox / (copy_ms * 1e-3) / 1e9:.0f} GB/s "
        "(read + write)")

    k_ms = timed("hessian_eig kernel 512^3",
                 lambda: K.fused_hessian_eig_stream(img, sp, stack=False))
    p_ms = timed("hessian_eig plain 512^3", lambda: K.hessian_eig_plain(img, sp))
    rel, ab = kernel_check("hessian_eig 512^3",
                           K.fused_hessian_eig_stream(img, sp, stack=False),
                           K.hessian_eig_plain(img, sp))
    errs["hessian_eig"].append(rel)
    results["hessian_eig"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=ab)
    say("full", f"hessian_eig 512^3 bit-equal to plain, rel {rel:.2e}; "
        f"{nvox / (k_ms * 1e-3) / 1e9:.2f} Gvox/s kernel")
    torch.cuda.empty_cache()

    for sigma in SIGMAS:
        for name, kern, plain, inside in kernel_pairs(img, mask, sigma, sp):
            km = timed(f"s={sigma} {name} kernel", kern)
            pm = timed(f"s={sigma} {name} plain", plain)
            rel, ab = kernel_check(f"{name} 512^3 s={sigma}", kern(), plain(),
                                   inside)
            errs[name].append(rel)
            say("full", f"s={sigma} {name}: bit-equal to plain, rel {rel:.2e}")
            if REPORT_SIGMA[name] == sigma:
                results[name] = dict(ms=km, plain_ms=pm, max_abs_err=ab)
            torch.cuda.empty_cache()
        branch = features8_dispatch_branch(sigma, sp, img.shape)
        f8_k = timed(f"s={sigma} features8 pass ({branch} kernels)",
                     lambda: features8_auto_channels(img, mask, sigma, sp))
        f8_p = timed(f"s={sigma} features8 pass (their plain twins)",
                     lambda: branch_twin(img, mask, sigma, sp))
        say("full", f"s={sigma} features8 {f8_k:.3f} ms kernels vs "
            f"{f8_p:.3f} ms plain")
        torch.cuda.empty_cache()
    say("full", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(card_line(), flush=True)


def config4_inputs(img, mask):
    """bench.py config 4 (:537-574) on the card: the 8 channels of one
    features8 pass at sigma 1.2 in its order (f8[1:] + f8[0]), 31 shared
    edges linspace(-1200, 600), the mask as uint8 weights."""
    from ife_tpu_torch.ops.features import features8_auto_channels

    f8 = features8_auto_channels(img, mask, 1.2, FULL_SPACING)
    edges = torch.linspace(-1200.0, 600.0, 31, dtype=torch.float64)
    return list(f8[1:]) + [f8[0]], edges, (mask != 0).to(torch.uint8)


def phase_full_hist(img, mask, errs, results):
    """The histogram kernel at 512^3 against its twin: the config-4 shape,
    one 4096-edge channel, and 50 ROIs of 41^3 per sigma beside the
    feature pass that feeds them."""
    import numpy as np

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi import generate_random_rois
    from ife_tpu_torch.roi.bag import roi_feature_histograms_device

    chans, edges, w = config4_inputs(img, mask)
    inside = int(w.sum())
    km = timed("histogram kernel, config 4 (8 x 512^3, 31 edges, mask)",
               lambda: K.histogram_counts_multi(chans, edges, w))
    pm = timed("histogram plain, config 4",
               lambda: K.histogram_counts_multi_plain(chans, edges, w))
    rel, ab = kernel_check("histogram config 4",
                           K.histogram_counts_multi(chans, edges, w),
                           K.histogram_counts_multi_plain(chans, edges, w))
    errs["histogram"].append(rel)
    results["histogram"] = dict(ms=km, plain_ms=pm, max_abs_err=ab)
    # bytes the kernel must move: the uint8 mask, and the 8 channels of
    # every 32-voxel warp that holds a masked voxel
    warps = int(w.view(-1, 32).any(1).sum())
    gb = (w.numel() + warps * 32 * 4 * 8) / 1e9
    say("full", f"histogram config 4 equal to plain; {inside} masked voxels, "
        f"~{gb:.2f} GB moved -> {gb / (km * 1e-3):.0f} GB/s; "
        f"{8 * inside / (km * 1e-3) / 1e9:.2f} G binnings/s")

    # bench.py's own config-4 mask: uniform > 0.25, 75% of the voxels
    g = torch.Generator(device=img.device).manual_seed(2)
    wr = (torch.rand(img.shape, device=img.device, generator=g) > 0.25
          ).to(torch.uint8)
    timed("histogram kernel, config 4 with a random 75% mask",
          lambda: K.histogram_counts_multi(chans, edges, wr))
    timed("histogram plain, config 4 with a random 75% mask",
          lambda: K.histogram_counts_multi_plain(chans, edges, wr))
    rel, _ = kernel_check("histogram config 4, random mask",
                          K.histogram_counts_multi(chans, edges, wr),
                          K.histogram_counts_multi_plain(chans, edges, wr))
    errs["histogram"].append(rel)
    del wr

    c0 = chans[-1]  # GaussianBlur
    lo, hi = float(c0[w != 0].min()), float(c0[w != 0].max())
    fine = torch.linspace(lo, hi, 4096, dtype=torch.float64)
    timed("histogram kernel, 1 x 512^3, 4096 edges, mask",
          lambda: K.histogram_counts_kernel(c0, fine, w))
    timed("histogram plain, 1 x 512^3, 4096 edges",
          lambda: K.histogram_counts_multi_plain([c0], fine, w))
    rel, _ = kernel_check("histogram 4096 edges",
                          K.histogram_counts_kernel(c0, fine, w),
                          K.histogram_counts_multi_plain([c0], fine, w)[0])
    errs["histogram"].append(rel)
    del chans, c0
    torch.cuda.empty_cache()

    size = (41, 41, 41)
    rois = generate_random_rois(w.cpu().numpy(), 50, size, seed=0)
    starts = np.asarray([r.index for r in rois])
    for sigma in SIGMAS:
        feats = features8_auto_channels(img, mask, sigma, FULL_SPACING)
        e = hist_edges(feats, 31)
        f_ms = timed(f"s={sigma} features8 pass",
                     lambda: features8_auto_channels(img, mask, sigma,
                                                     FULL_SPACING))
        b_ms = timed(f"s={sigma} binning 50 ROIs of 41^3 "
                     "(roi_feature_histograms_device)",
                     lambda: roi_feature_histograms_device(feats, mask, starts,
                                                           e, size))
        k_ms = timed(f"s={sigma} histogram kernel, 50 boxes",
                     lambda: K.histogram_boxes(feats, w, starts, size, e))
        p_ms = timed(f"s={sigma} histogram plain, 50 boxes",
                     lambda: K.histogram_boxes_plain(feats, w, starts, size, e))
        rel, _ = kernel_check(f"histogram boxes 512^3 s={sigma}",
                              K.histogram_boxes(feats, w, starts, size, e),
                              K.histogram_boxes_plain(feats, w, starts, size, e))
        errs["histogram"].append(rel)
        say("full", f"s={sigma} make_bag_device stages: features8 {f_ms:.3f} ms, "
            f"binning {b_ms:.3f} ms (kernel {k_ms:.3f} vs plain {p_ms:.3f} ms, "
            "equal)")
        del feats
        torch.cuda.empty_cache()
    print(card_line(), flush=True)


def phase_profile(img, mask):
    """Device time per CUDA kernel of each pass, from torch.profiler; a
    profiler that records no device time prints "not measured"."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    from ife_tpu_torch.ops.features import (
        features8_auto_channels, hessian_eig_features,
    )

    if ProfilerActivity.CUDA not in supported_activities():
        say("profile", "not measured (this torch cannot profile CUDA)")
        return

    passes = [("hessian_eig", lambda: hessian_eig_features(img, FULL_SPACING))]
    passes += [(f"features8 s={s}",
                lambda s=s: features8_auto_channels(img, mask, s, FULL_SPACING))
               for s in SIGMAS]
    from ife_tpu_torch.kernels import histogram_counts_multi

    chans, edges, w = config4_inputs(img, mask)
    passes.append(("histogram config 4",
                   lambda: histogram_counts_multi(chans, edges, w)))
    for label, fn in passes:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0 and ev.count:
                rows.append((ev.key[:60], ev.count // 3, us / 3 / 1e3))
        if not rows:
            say("profile", f"{label}: not measured (no device time recorded)")
            continue
        total = sum(ms for _, _, ms in rows)
        say("profile", f"{label}: device {total:.3f} ms per pass = "
            + "; ".join(f"{k} x{n} {ms:.3f}" for k, n, ms in
                        sorted(rows, key=lambda r: -r[2])))
        torch.cuda.empty_cache()


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ife_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repo "
              "(ife_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    phase = "device"
    try:
        phase_device()
        phase = "build"
        phase_build()
        errs = {k: [] for k in KERNELS}
        phase = "kernels"
        phase_kernels(errs)
        phase = "main"
        with tempfile.TemporaryDirectory(prefix="ife_chip_smoke_") as tmp:
            launches, img, mask = phase_main(tmp)
            phase = "bags"
            bag_launches = phase_bags(tmp)
        launches = {k: launches[k] + bag_launches[k] for k in launches}
        phase = "full"
        results = {}
        phase_full(img, mask, errs, results)
        phase_full_hist(img, mask, errs, results)
        phase = "profile"
        phase_profile(img, mask)
    except PhaseError as e:
        print(f"chip_smoke: phase {phase} failed: {e}", file=sys.stderr)
        return 1
    # every number below was measured in this run: launches in phase 4
    # (the feature path's and the bag path's runs added);
    # ms, plain_ms and max_abs_err at 512^3 (at REPORT_SIGMA for the
    # smoothing kernels, the config-4 shape for the histogram); max_rel_err
    # the worst of phases 3 and 5
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **results[name],
             max_rel_err=max(errs[name]))
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
