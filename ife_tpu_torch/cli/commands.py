"""Subcommand implementations for the port's CLI (counterpart of
ife_tpu/cli/commands.py): every ife_tpu subcommand.

REGISTRY maps subcommand name -> (configure(parser), run(args), help). The
compute runs on this process's CUDA device; IFE_PLATFORM=cpu asks for the
CPU, and without it a host that has no card raises (parallel.mesh
default_device). Volumes are read and written on the host.

--sharded cuts the volume into a mesh of blocks (parallel/): --blocks of them
in this process, or, with --coordinator / --num-processes / --process-id,
dealt to the processes of torch.distributed, each on its own device.
"""
from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch


def _triple(s: str, cast=int):
    parts = [p for p in s.replace(",", " ").split() if p]
    if len(parts) != 3:
        raise ValueError(f"expected 3 comma-separated values, got {s!r}")
    return tuple(cast(p) for p in parts)


def _pair(s: str, cast=int):
    parts = [p for p in s.replace(",", " ").split() if p]
    if len(parts) != 2:
        raise ValueError(f"expected 2 comma-separated values, got {s!r}")
    return tuple(cast(p) for p in parts)


def _device() -> torch.device:
    from ife_tpu_torch.parallel.mesh import default_device

    return default_device()


def _load(path):
    from ife_tpu_torch.io import read_volume

    return read_volume(path)


def _save(path, vol):
    from ife_tpu_torch.io import write_volume

    write_volume(path, vol)


def _progress(msg: str):
    # reference tools print progress lines to stdout (MakeBag.cxx:406)
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# feature tools
# ---------------------------------------------------------------------------

def _init_distributed(args):
    """Shared --sharded runtime setup: process-group init (no-op without a
    coordinator), the block mesh, optional restart manifest. Returns
    (mesh, manifest, primary).

    ife_tpu shards over "all devices"; a process of the port drives one
    device, so the mesh has --blocks blocks (default: one per process), 2D
    when there are several, dealt evenly to the processes."""
    from ife_tpu_torch.parallel import make_mesh, mesh_dims
    from ife_tpu_torch.parallel.launcher import (
        ShardManifest,
        distributed_init_from_args,
        is_primary,
    )

    pid, nprocs = distributed_init_from_args(args)
    n = getattr(args, "blocks", None) or nprocs
    mesh = make_mesh(n, ("x", "y") if n > 1 else ("x",))
    _progress(f"process {pid}/{nprocs}: sharding over {n} blocks on "
              f"{mesh.device}: {dict(zip(mesh.axis_names, mesh_dims(mesh)))}")
    manifest_path = getattr(args, "manifest", None)
    if manifest_path and nprocs > 1:
        # per-process manifest (and caches derived from it): restartable
        # WITHOUT assuming a shared filesystem across hosts
        manifest_path = f"{manifest_path}.p{pid}"
    manifest = ShardManifest(manifest_path) if manifest_path else None
    return mesh, manifest, is_primary()


def _add_distributed_flags(p):
    """Flags shared by every --sharded-capable subcommand."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process coordinator address "
                   "(or env IFE_COORDINATOR); single-process if unset")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (or env IFE_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index (or env IFE_PROCESS_ID)")
    p.add_argument("--blocks", type=int, default=None,
                   help="blocks of the --sharded mesh (default: one per "
                   "process; a multiple of the process count)")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="shard-manifest JSON: completed blocks are skipped "
                   "on restart (failure recovery)")


def conf_extract_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--sharded", action="store_true",
                   help="cut the volume into --blocks blocks, in this process "
                   "or over several with --coordinator (halo-exchange path)")
    _add_distributed_flags(p)


def run_extract_features(args):
    """Reference tools/ExtractFeatures.cxx: per scale, 8 feature volumes
    written as <out>_scale_<s><FeatureName>.nii.gz.

    --sharded runs each scale over the block mesh; --manifest makes the run
    restartable (completed scales are skipped)."""
    from ife_tpu_torch.ops.features import FEATURE_NAMES, features8_auto_channels
    from ife_tpu_torch.utils import stage_timer

    mesh = manifest = None
    primary = True
    if args.sharded:
        mesh, manifest, primary = _init_distributed(args)
    dev = _device()
    vol = _load(args.image)
    mask = _load(args.mask)
    img = vol.data.to(device=dev, dtype=torch.float32).contiguous()
    msk = mask.data.to(dev)
    for s in args.scales:
        key = f"scale_{s:g}"
        if manifest is not None and manifest.is_done(key):
            _progress(f"Skipping completed scale {s:g} (manifest)")
            continue
        _progress(f"Processing scale {s:g}")

        def write(k, ch, s=s):
            _save(f"{args.out}_scale_{s:g}{FEATURE_NAMES[k]}.nii.gz",
                  vol.with_data(ch.cpu().contiguous()))

        if mesh is not None:
            from ife_tpu_torch.parallel import features8_sharded_channels_to

            # each channel is gathered to the primary alone and written
            # there before the next is gathered
            with stage_timer(f"features8[s={s:g}] sharded, gathered and "
                             "written", work=img.numel(), emit=True):
                features8_sharded_channels_to(img, msk, float(s), mesh, write,
                                              vol.spacing)
        else:
            with stage_timer(f"features8[s={s:g}]", work=img.numel(),
                             emit=True):
                feats = [c.cpu() for c in features8_auto_channels(
                    img, msk, float(s), vol.spacing)]
            for k, ch in enumerate(feats):
                write(k, ch)
        if manifest is not None:
            # every process records completion in its OWN manifest so a
            # restart keeps the collective schedule in lockstep
            manifest.mark_done(
                key, f"{args.out}_scale_{s:g}{FEATURE_NAMES[-1]}.nii.gz"
                if primary else None)
    _shutdown_distributed(args)


def _shutdown_distributed(args):
    if getattr(args, "sharded", False):
        from ife_tpu_torch.parallel.launcher import distributed_shutdown

        distributed_shutdown()


def conf_masked_normalized_convolution(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-c", "--certainty", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--mask-output", action="store_true",
                   help="zero the output outside the certainty support")


def run_masked_normalized_convolution(args):
    """Reference tools/MaskedNormalizedConvolution.cxx:141-203."""
    from ife_tpu_torch.ops.features import normalized_convolution_auto

    dev = _device()
    vol = _load(args.image)
    cert = _load(args.certainty)
    img = vol.data.to(device=dev, dtype=torch.float32).contiguous()
    c = cert.data.to(device=dev, dtype=torch.float32).contiguous()
    for s in args.scales:
        _progress(f"Processing scale {s:g}")
        out = normalized_convolution_auto(img, c, float(s), vol.spacing)
        if args.mask_output:
            out = torch.where(c != 0, out, torch.zeros((), device=dev))
        else:
            out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
        _save(f"{args.out}scale_{s:g}.nii.gz", vol.with_data(out.cpu()))


def conf_hessian_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", default=None)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("--fused", action="store_true",
                   help="write the fused kernel's function (the polynomial "
                   "eigen path, as ife_tpu's --fused) instead of "
                   "hessian_eig_features' (the reference's trig path with "
                   "its diagonal branch); on CUDA both run the hessian_eig "
                   "kernel")


def run_hessian_features(args):
    """Raw (unsmoothed) Hessian eigen-feature volumes. Capability of the
    dead reference tool FiniteDifference_HessianFeatures (its Dy-direction
    bug at :153-156 is NOT replicated — the live Hessian3DImageFilter wiring
    is the spec)."""
    dev = _device()
    vol = _load(args.image)
    img = vol.data.to(device=dev, dtype=torch.float32).contiguous()
    names = ("Eigenvalue1", "Eigenvalue2", "Eigenvalue3",
             "LaplacianOfGaussian", "GaussianCurvature", "FrobeniusNorm")
    if args.fused:
        from ife_tpu_torch.kernels import fused_hessian_eig

        feats = fused_hessian_eig(img, vol.spacing, stack=False)
    else:
        from ife_tpu_torch.ops.features import hessian_eig_features_channels

        feats = hessian_eig_features_channels(img, vol.spacing)
    inside = None
    if args.mask:
        inside = _load(args.mask).data.to(dev) != 0
    for name, ch in zip(names, feats):
        if inside is not None:
            # a multiply, as ife_tpu's tool does: the features of a finite
            # image are finite
            ch = ch * inside
        _save(f"{args.out}{name}.nii.gz", vol.with_data(ch.cpu()))


def conf_gradient_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)


def run_gradient_features(args):
    """Reference tools/FiniteDifference_GradientFeatures.cxx:104-137:
    masked central-difference gradient magnitude."""
    from ife_tpu_torch.ops.stencil import gradient_magnitude

    dev = _device()
    vol = _load(args.image)
    mask = _load(args.mask)
    gm = gradient_magnitude(vol.data.to(device=dev, dtype=torch.float32),
                            vol.spacing)
    gm = torch.where(mask.data.to(dev) != 0, gm, torch.zeros((), device=dev))
    _save(args.out, vol.with_data(gm.cpu()))


# ---------------------------------------------------------------------------
# bag tools
# ---------------------------------------------------------------------------

def _get_rois(args, mask_np, default_size=(41, 41, 41)):
    """ROI source resolution shared by the bag tools: explicit ROI file, or
    random generation (MakeBag.cxx:272-317)."""
    from ife_tpu_torch.io import read_rois
    from ife_tpu_torch.roi import generate_random_rois

    if getattr(args, "roi_file", None):
        return read_rois(args.roi_file, header=getattr(args, "roi_header", False))
    size = getattr(args, "roi_size", None) or default_size
    return generate_random_rois(
        mask_np, n=args.num_rois, size=size, seed=getattr(args, "seed", None)
    )


def _conf_bag_common(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-b", "--bins", dest="hist_spec", required=True,
                   help="histogram spec file (bin edges)")
    p.add_argument("-o", "--out", required=True, help="output prefix")


def conf_make_bag(p):
    _conf_bag_common(p)
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("-r", "--roi-file", default=None)
    p.add_argument("--roi-header", action="store_true")
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", action="store_true",
                   help="histogram the ROIs on the device (the histogram "
                   "kernel on CUDA; mixed ROI sizes run per size class)")
    p.add_argument("--sharded", action="store_true",
                   help="run the feature pass over the block mesh; the "
                   "feature volume never touches the host (mixed ROI sizes "
                   "run per size class)")
    _add_distributed_flags(p)


def run_make_bag(args):
    """Reference tools/MakeBag.cxx: per-ROI concatenated feature histograms
    -> <prefix>.bag CSV + <prefix>.ROIInfo.

    --sharded keeps the per-scale feature volumes in blocks on the device
    and fetches only the (n_rois, 8, bins) frequency block."""
    from ife_tpu_torch.io import read_hist_spec, write_matrix_csv, write_rois
    from ife_tpu_torch.roi.bag import make_bag, make_bag_device, make_bag_sharded

    primary = True
    vol = _load(args.image)
    mask = _load(args.mask)
    edges = read_hist_spec(args.hist_spec)
    mask_np = mask.numpy()
    if args.sharded:
        mesh, _, primary = _init_distributed(args)
        if getattr(args, "roi_file", None) is None and args.seed is None:
            # every process must draw IDENTICAL ROIs, but the default must
            # stay a fresh random sampling like the unsharded run: the
            # primary draws entropy and broadcasts it. The seed is printed
            # so the run is reproducible after the fact.
            import secrets

            from ife_tpu_torch.parallel.launcher import broadcast_int

            args.seed = broadcast_int(secrets.randbits(31))
            _progress(f"--sharded ROI seed {args.seed} "
                      "(drawn on primary, broadcast to all processes; "
                      "pass --seed to reproduce)")
        rois = _get_rois(args, mask_np)
        bag = make_bag_sharded(vol.numpy(), mask_np, args.scales, edges, rois,
                               mesh, spacing=vol.spacing)
    else:
        rois = _get_rois(args, mask_np)
        bag_fn = make_bag_device if args.device else make_bag
        bag = bag_fn(vol.numpy(), mask_np, args.scales, edges, rois,
                     spacing=vol.spacing)
    if primary:
        write_matrix_csv(f"{args.out}.bag", bag)
        write_rois(f"{args.out}.ROIInfo", rois)
    _progress(f"Wrote {bag.shape[0]} ROIs x {bag.shape[1]} columns")
    _shutdown_distributed(args)


def conf_make_bag_dense(p):
    _conf_bag_common(p)
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--device", action="store_true",
                   help="bin every ROI on the device (the dense box-histogram "
                   "kernels on CUDA); the rows are fetched in chunks")


# rows a dense bag fetches from the device at a time for its CSV
DENSE_FETCH_ROWS = 65536


def run_make_bag_dense(args):
    """Reference tools/MakeBagDense.cxx: every foreground voxel is an ROI
    center (DenseROIGenerator). make_bag bins every ROI on the host, so that
    route is for small masks; --device runs make_bag_dense_device and
    writes the same files from its rows, fetched DENSE_FETCH_ROWS at a
    time."""
    from ife_tpu_torch.io import read_hist_spec, write_matrix_csv, write_rois
    from ife_tpu_torch.roi import ROI, generate_dense_rois, make_bag
    from ife_tpu_torch.roi.bag import make_bag_dense_device

    vol = _load(args.image)
    mask = _load(args.mask)
    edges = read_hist_spec(args.hist_spec)
    mask_np = mask.numpy()
    if args.device:
        starts, rows = make_bag_dense_device(vol.numpy(), mask_np, args.scales,
                                             edges, args.roi_size,
                                             spacing=vol.spacing)
        size = tuple(int(s) for s in args.roi_size)
        rois = [ROI(tuple(st), size) for st in starts.cpu().tolist()]
        write_matrix_csv(f"{args.out}.bag", (
            rows[i:i + DENSE_FETCH_ROWS].cpu().numpy()
            for i in range(0, rows.shape[0], DENSE_FETCH_ROWS)))
        n, cols = rows.shape
    else:
        rois = generate_dense_rois(mask_np, args.roi_size)
        bag = make_bag(vol.numpy(), mask_np, args.scales, edges, rois,
                       spacing=vol.spacing)
        write_matrix_csv(f"{args.out}.bag", bag)
        n, cols = bag.shape
    write_rois(f"{args.out}.ROIInfo", rois)
    _progress(f"Wrote {n} ROIs x {cols} columns")


def conf_make_bag_only_intensity(p):
    _conf_bag_common(p)
    p.add_argument("-r", "--roi-file", default=None)
    p.add_argument("--roi-header", action="store_true")
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--seed", type=int, default=None)


def run_make_bag_only_intensity(args):
    """Reference tools/MakeBagOnlyIntensity.cxx: raw intensity, single
    histogram (check at :326-330); host numpy, as in ife_tpu."""
    from ife_tpu_torch.io import read_hist_spec, write_matrix_csv, write_rois
    from ife_tpu_torch.roi.bag import make_bag_intensity

    vol = _load(args.image)
    mask = _load(args.mask)
    edges = read_hist_spec(args.hist_spec)
    if len(edges) != 1:
        raise ValueError("intensity bags use exactly one histogram row")
    mask_np = mask.numpy()
    rois = _get_rois(args, mask_np)
    bag = make_bag_intensity(vol.numpy(), mask_np, edges[0], rois)
    write_matrix_csv(f"{args.out}.bag", bag)
    write_rois(f"{args.out}.ROIInfo", rois)


def conf_determine_bin_edges(p):
    p.add_argument("-l", "--pair-list", required=True,
                   help="text file: image,mask per line")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--bins", type=int, required=True)
    p.add_argument("--samples", type=int, default=0,
                   help="random samples per image (0 = all masked voxels)")
    p.add_argument("--foreground", type=int, nargs="+", default=[1],
                   help="mask labels counted as foreground")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sharded", action="store_true",
                   help="scalable path: features stay in blocks on the "
                   "device, per-image fine histograms all-reduce, edges come "
                   "from CDF inversion (approximate; replaces the global sort)")
    p.add_argument("--fine-bins", type=int, default=4096,
                   help="fine pre-histogram resolution for --sharded")
    _add_distributed_flags(p)


def _foreground_mask(arr: np.ndarray, labels) -> np.ndarray:
    """Membership of arr values in the (small) foreground label list: a
    per-label equality OR (np.isin's sort-based path is slow on a 512^3
    volume)."""
    fg = np.zeros(np.shape(arr), bool)
    for v in labels:
        fg |= (arr == v)
    return fg


def _run_determine_bin_edges_sharded(args):
    """Scalable bin-edge path: per image, per (scale, feature), a fine
    histogram over the block mesh (min/max and dense counts all-reduced,
    parallel/stats.py); per-image histograms merge across images by
    piecewise-linear CDF resampling; the equalized edges invert the merged
    CDF. Replaces the reference's all-samples global sort, which needs every
    sample in one address space. --manifest caches per-image histograms in
    <manifest>.<image-index>.npz so restarts skip completed images."""
    from ife_tpu_torch.io import read_pair_list, write_hist_spec
    from ife_tpu_torch.ops.features import FEATURE_NAMES, NUM_FEATURES
    from ife_tpu_torch.parallel.stats import (
        merge_fine_histograms,
        sharded_feature_fine_histograms,
    )
    from ife_tpu_torch.stats.equalize import edges_from_dense_counts

    mesh, manifest, primary = _init_distributed(args)
    pairs = read_pair_list(args.pair_list)
    n_hists = NUM_FEATURES * len(args.scales)
    per_hist = [[] for _ in range(n_hists)]
    for idx, (img_path, mask_path) in enumerate(pairs):
        key = f"image_{idx}"
        # the cache path derives from the manifest's (per-process) path, so
        # multi-host restarts never read another host's files
        cache = f"{manifest.path}.{idx}.npz" if manifest is not None else None
        if manifest is not None and manifest.is_done(key):
            _progress(f"Loading cached histograms for {img_path} (manifest)")
            z = np.load(cache)
            for h in range(n_hists):
                per_hist[h].append((z[f"bounds_{h}"], z[f"counts_{h}"]))
            continue
        _progress(f"Processing {img_path} / {mask_path}")
        vol = _load(img_path)
        mask = _load(mask_path)
        fg = _foreground_mask(mask.numpy(), args.foreground)
        hists = sharded_feature_fine_histograms(
            vol.numpy(), fg.astype(np.uint8), args.scales, mesh,
            vol.spacing, n_fine=args.fine_bins)
        for h, bc in enumerate(hists):
            per_hist[h].append(bc)
        if manifest is not None:
            np.savez(
                cache,
                **{f"bounds_{h}": b for h, (b, _) in enumerate(hists)},
                **{f"counts_{h}": c for h, (_, c) in enumerate(hists)},
            )
            manifest.mark_done(key, cache)
    edge_rows = []
    for vals in per_hist:
        bounds, counts = merge_fine_histograms(vals)
        edge_rows.append(edges_from_dense_counts(bounds, counts, args.bins))
    if primary:
        write_hist_spec(args.out, edge_rows, scales=args.scales,
                        feature_names=FEATURE_NAMES)
    _shutdown_distributed(args)


def run_determine_bin_edges(args):
    """Reference tools/DetermineHistogramBinEdges_MultiScaleEigenvalue
    Features.cxx: per (scale, feature) equal-frequency edges over a sample
    of masked feature voxels from all listed images. The foreground voxels
    are gathered on the device; sampling (numpy default_rng, as ife_tpu),
    the sort and the edge search run on the host."""
    from ife_tpu_torch.io import read_pair_list, write_hist_spec
    from ife_tpu_torch.ops.features import (
        FEATURE_NAMES, NUM_FEATURES, features8_auto_channels,
    )
    from ife_tpu_torch.stats.equalize import determine_edges_for_equalized_histogram

    if args.sharded:
        return _run_determine_bin_edges_sharded(args)
    dev = _device()
    pairs = read_pair_list(args.pair_list)
    rng = np.random.default_rng(args.seed)
    samples = [[] for _ in range(NUM_FEATURES * len(args.scales))]
    for img_path, mask_path in pairs:
        _progress(f"Processing {img_path} / {mask_path}")
        vol = _load(img_path)
        mask = _load(mask_path)
        fg = torch.from_numpy(_foreground_mask(mask.numpy(), args.foreground)
                              ).to(dev)
        img = vol.data.to(device=dev, dtype=torch.float32).contiguous()
        msk = fg.to(torch.uint8)
        for i, s in enumerate(args.scales):
            feats = features8_auto_channels(img, msk, float(s), vol.spacing)
            sel = torch.stack([c[fg] for c in feats], dim=1).cpu().numpy()
            if args.samples > 0 and sel.shape[0] > args.samples:
                sel = sel[rng.choice(sel.shape[0], args.samples, replace=False)]
            for k in range(NUM_FEATURES):
                samples[i * NUM_FEATURES + k].append(sel[:, k])
    edge_rows = []
    for vals in samples:
        v = np.sort(np.concatenate(vals))
        edge_rows.append(determine_edges_for_equalized_histogram(v, args.bins))
    write_hist_spec(args.out, edge_rows, scales=args.scales,
                    feature_names=FEATURE_NAMES)


# ---------------------------------------------------------------------------
# ROI tools
# ---------------------------------------------------------------------------

def conf_generate_rois(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--size", type=_triple, default=(53, 53, 41), metavar="X,Y,Z")
    p.add_argument("--mask-value", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)


def run_generate_rois(args):
    """Reference tools/GenerateROIs.cxx:127-163."""
    from ife_tpu_torch.io import write_rois
    from ife_tpu_torch.roi import generate_random_rois

    mask = _load(args.mask)
    binary = (mask.numpy() == args.mask_value).astype(np.uint8)
    rois = generate_random_rois(binary, n=args.num_rois, size=args.size,
                                seed=args.seed)
    write_rois(args.out, rois)


def conf_generate_rois_many_regions(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--size", type=_triple, default=(53, 53, 41), metavar="X,Y,Z")
    p.add_argument("--labels", type=int, nargs="+", default=None,
                   help="default: every nonzero label present")
    p.add_argument("--seed", type=int, default=None)


def run_generate_rois_many_regions(args):
    """Reference tools/GenerateROIsManyRegions.cxx:151-176: one ROI file
    per mask label."""
    from ife_tpu_torch.io import write_rois
    from ife_tpu_torch.roi import generate_random_rois

    m = _load(args.mask).numpy()
    labels = args.labels or sorted(int(v) for v in np.unique(m) if v != 0)
    for lab in labels:
        binary = (m == lab).astype(np.uint8)
        rois = generate_random_rois(binary, n=args.num_rois, size=args.size,
                                    seed=args.seed)
        write_rois(f"{args.out}_{lab}.ROIInfo", rois)
        _progress(f"label {lab}: {len(rois)} ROIs")


def conf_sample_rois(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-r", "--roi-file", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--roi-header", action="store_true")


def run_sample_rois(args):
    """Reference tools/SampleROIs.cxx:104-170."""
    from ife_tpu_torch.io import read_rois, write_matrix_csv
    from ife_tpu_torch.roi.bag import sample_rois

    vol = _load(args.image)
    rois = read_rois(args.roi_file, header=args.roi_header)
    write_matrix_csv(args.out, sample_rois(vol.numpy(), rois))


def conf_extract_labels(p):
    p.add_argument("-l", "--label-image", required=True)
    p.add_argument("-r", "--roi-file", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--ignore", type=int, nargs="+", default=[])
    p.add_argument("--dominant", type=int, default=None)
    p.add_argument("--dominant-threshold", type=float, default=0.0)
    p.add_argument("--roi-header", action="store_true")


def run_extract_labels(args):
    """Reference tools/ExtractLabels.cxx:165-210."""
    from ife_tpu_torch.io import read_rois
    from ife_tpu_torch.roi.bag import extract_labels

    vol = _load(args.label_image)
    rois = read_rois(args.roi_file, header=args.roi_header)
    labels = extract_labels(vol.numpy(), rois, ignore=args.ignore,
                            dominant=args.dominant,
                            dominant_threshold=args.dominant_threshold)
    with open(args.out, "w") as f:
        for lab in labels:
            f.write(f"{lab}\n")


# ---------------------------------------------------------------------------
# image utility tools (ops/transform.py: the masks, the window and the
# resamplers on the device, the rest on the host)
# ---------------------------------------------------------------------------

def conf_masked_image_filter(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--outside", type=float, default=0.0)


def run_masked_image_filter(args):
    """Reference tools/MaskedImageFilter.cxx: the image's dtype is kept."""
    from ife_tpu_torch.ops.transform import mask_image

    vol = _load(args.image)
    mask = _load(args.mask)
    out = mask_image(vol.data, mask.data, args.outside, device=_device())
    _save(args.out, vol.with_data(out.cpu()))


def conf_extract_masked_region(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--include", type=int, nargs="+", required=True)
    p.add_argument("--inside", type=int, default=1)
    p.add_argument("--outside", type=int, default=0)


def run_extract_masked_region(args):
    """Reference tools/ExtractMaskedRegion.cxx: the mask's dtype is kept."""
    from ife_tpu_torch.ops.transform import relabel_mask

    mask = _load(args.mask)
    out = relabel_mask(mask.data, args.include, args.inside, args.outside,
                       device=_device())
    _save(args.out, mask.with_data(out.cpu()))


def conf_extract_bounding_box(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)


def run_extract_bounding_box(args):
    """Reference tools/ExtractBoundingBox.cxx."""
    from ife_tpu_torch.ops.transform import crop_to_bounding_box

    vol = _load(args.image)
    mask = _load(args.mask)
    _save(args.out, crop_to_bounding_box(vol, mask.numpy()))


def conf_extract_slices(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("--axis", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--indices", type=int, nargs="*", default=[])
    p.add_argument("--fractions", type=float, nargs="*", default=[])
    p.add_argument("--window", type=int, default=0)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--mask", default=None,
                   help="crop to this mask's bounding box first")
    p.add_argument("--no-flip", action="store_true")


def run_extract_slices(args):
    """Reference tools/ExtractSlices.cxx."""
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.ops.transform import (
        crop_to_bounding_box,
        extract_slice,
        slice_indices,
    )

    vol = _load(args.image)
    if args.mask:
        vol = crop_to_bounding_box(vol, _load(args.mask).numpy())
    n = vol.shape[args.axis]
    idxs = slice_indices(n, args.indices, args.fractions, args.window,
                         args.stride)
    if not idxs:
        raise ValueError("no slice indices selected")
    data = vol.numpy()
    sp = [vol.spacing[d] for d in range(3) if d != args.axis]
    for i in idxs:
        # a flipped slice is a negative-stride view
        plane = np.ascontiguousarray(
            extract_slice(data, args.axis, i, flip=not args.no_flip))
        _save(f"{args.out}_{i}.nii.gz",
              Volume.from_numpy(plane[..., None], spacing=(*sp, 1.0)))


def conf_extract_window(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--level", type=float, default=-500.0)
    p.add_argument("--width", type=float, default=1500.0)
    p.add_argument("--out-spacing", type=float, default=0.25)
    p.add_argument("--mask", default=None)
    p.add_argument("-b", "--spline-order", type=int, default=3,
                   choices=range(6), metavar="[0-5]",
                   help="B-spline interpolation order "
                   "(reference ExtractWindow.cxx:43, default 3)")


def run_extract_window(args):
    """Reference tools/ExtractWindow.cxx: resample 2D to isotropic spacing
    (B-spline interpolation, ceil sizing, NN extrapolation; the mask rides
    nearest-neighbor, :230-232) then window to uint8."""
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.ops.transform import (
        intensity_window,
        resample_to_spacing_2d,
    )

    dev = _device()
    vol = _load(args.image)
    data = vol.numpy()
    if data.ndim == 3 and data.shape[2] == 1:
        data = data[..., 0]
    if data.ndim != 2:
        raise ValueError("extract-window expects a 2D image")
    res = resample_to_spacing_2d(data, vol.spacing[:2], args.out_spacing,
                                 order=args.spline_order, device=dev)
    win = intensity_window(res, args.level, args.width, device=dev)
    if args.mask:
        mask = _load(args.mask)
        m = mask.numpy()
        if m.ndim == 3:
            m = m[..., 0]
        # mask rides nearest-neighbor so it stays binary (reference
        # ExtractWindow.cxx:230-232)
        mres = resample_to_spacing_2d(m.astype(np.float32),
                                      mask.spacing[:2], args.out_spacing,
                                      order=0, device=dev)
        win = torch.where(mres > 0.5, win, torch.zeros((), dtype=win.dtype,
                                                       device=dev))
    _save(args.out, Volume(win.cpu()[..., None],
                           spacing=(args.out_spacing, args.out_spacing, 1.0)))


def conf_pad_image(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--size", type=_pair, required=True, metavar="X,Y")
    p.add_argument("--value", type=float, default=0.0)


def run_pad_image(args):
    """Reference tools/PadImage.cxx:60-76."""
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.ops.transform import pad_to_size_2d

    vol = _load(args.image)
    data = vol.numpy()
    if data.ndim == 3 and data.shape[2] == 1:
        data = data[..., 0]
    out = pad_to_size_2d(data, args.size, args.value)
    _save(args.out, Volume.from_numpy(out[..., None], spacing=vol.spacing))


def conf_resample(p):
    p.add_argument("-s", "--source", required=True)
    p.add_argument("-t", "--target", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--nearest", action="store_true",
                   help="nearest-neighbor interpolation (for masks)")
    p.add_argument("--default-value", type=float, default=0.0)


def run_resample(args):
    """Reference tools/Resample.cxx:83-103."""
    from ife_tpu_torch.ops.transform import resample_to_grid

    src = _load(args.source)
    tgt = _load(args.target)
    out = resample_to_grid(src, tgt, order=0 if args.nearest else 1,
                           default_value=args.default_value, device=_device())
    _save(args.out, out)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def conf_convert_hr2(p):
    p.add_argument("input")
    p.add_argument("output")


def run_convert_hr2(args):
    """Reference tools/ConvertHR2.cxx:23-95."""
    from ife_tpu_torch.io import read_hr2

    _save(args.output, read_hr2(args.input))


def conf_convert_dicom(p):
    p.description = (
        "Supported transfer syntaxes: Implicit VR LE (1.2.840.10008.1.2), "
        "Explicit VR LE (1.2.840.10008.1.2.1), RLE Lossless "
        "(1.2.840.10008.1.2.5), JPEG Lossless SV1 (1.2.840.10008.1.2.4.70), "
        "JPEG-LS (1.2.840.10008.1.2.4.80 / .81). Lossy JPEG and JPEG 2000 "
        "files must be transcoded first."
    )
    p.add_argument("-d", "--dicom-dir", required=True)
    p.add_argument("-o", "--out-dir", required=True)


def run_convert_dicom(args):
    """Reference tools/ConvertDICOM.cxx:70-131: one volume per series,
    named from PatientID/StudyDate/ConvolutionKernel/SliceSpacing tags;
    decoded on the host."""
    from ife_tpu_torch.io.dicom import convert_dicom_dir

    written = convert_dicom_dir(args.dicom_dir, args.out_dir)
    for path in written:
        _progress(f"wrote {path}")


def conf_convert_from_octave(p):
    p.add_argument("input")
    p.add_argument("output")


def run_convert_from_octave(args):
    """Reference tools/ConvertFromOctave.cxx:56-75."""
    from ife_tpu_torch.io import read_octave

    _save(args.output, read_octave(args.input))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def conf_merge_bags(p):
    p.add_argument("-b", "--bags", nargs="+", required=True,
                   help="per-image .bag CSV files")
    p.add_argument("-o", "--out", required=True, help="output .npz")
    p.add_argument("--bag-labels", default=None,
                   help="CSV: one label row per bag")
    p.add_argument("--instance-labels", nargs="+", default=None,
                   help="per-bag CSVs of instance labels")


def run_merge_bags(args):
    """Fixed MakeBaggedDataset capability (reference
    tools/MakeBaggedDataset.cxx:73-149, dead code there)."""
    from ife_tpu_torch.io import read_text_matrix
    from ife_tpu_torch.roi.bagged_dataset import merge_bags, save_bagged_dataset

    bag_labels = (
        read_text_matrix(args.bag_labels) if args.bag_labels else None
    )
    if args.instance_labels and len(args.instance_labels) != len(args.bags):
        raise ValueError("need one instance-label file per bag")
    data = merge_bags(args.bags, bag_labels, args.instance_labels)
    save_bagged_dataset(args.out, data)
    _progress(
        f"wrote {data['instances'].shape[0]} instances in "
        f"{len(args.bags)} bags -> {args.out}"
    )


def conf_expected_distance(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-p", "--prob", required=True,
                   help="interest-point probability image")


def run_expected_distance(args):
    """Reference tools/CalculateExpectedDistanceFromCenterToInterestPoints
    .cxx:76-79 — prints the scalar."""
    from ife_tpu_torch.stats.distance import (
        expected_distance_from_center_to_interest_point,
    )

    mask = _load(args.mask)
    prob = _load(args.prob)
    print(expected_distance_from_center_to_interest_point(
        mask.numpy(), prob.numpy(), mask.spacing))


def conf_image_browser(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("--cmd", default=None,
                   help="run one command non-interactively (info|hist|coverage)")
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--coverage-samples", type=int, default=1000)


def run_image_browser(args):
    """Reference tools/ImageBrowser.cxx: info, unique-value histogram, and
    Monte-Carlo ROI-coverage estimation (:24-100)."""
    vol = _load(args.image)
    data = vol.numpy()

    def cmd_info():
        print(f"shape: {vol.shape}")
        print(f"spacing: {vol.spacing}")
        print(f"origin: {vol.origin}")
        print(f"dtype: {data.dtype}")  # numpy's name, as ife_tpu prints it
        print(f"min/max: {data.min():g} {data.max():g}")

    def cmd_hist():
        vals, counts = np.unique(data, return_counts=True)
        if vals.size > 64:
            print(f"{vals.size} unique values; showing 64 quantile bins")
            qs = np.quantile(data.reshape(-1), np.linspace(0, 1, 65))
            hist, _ = np.histogram(data, bins=np.unique(qs))
            for lo, hi, c in zip(qs[:-1], qs[1:], hist):
                print(f"[{lo:g}, {hi:g}): {c}")
        else:
            for v, c in zip(vals, counts):
                print(f"{v:g}: {c}")

    def cmd_coverage():
        from ife_tpu_torch.roi import generate_random_rois

        binary = (data != 0).astype(np.uint8)
        covered = np.zeros_like(binary, dtype=bool)
        rois = generate_random_rois(binary, n=args.coverage_samples,
                                    size=args.roi_size, seed=0)
        for r in rois:
            covered[r.slices()] = True
        frac = covered[binary != 0].mean() if binary.any() else 0.0
        print(f"coverage: {frac:.4f} with {len(rois)} ROIs of {args.roi_size}")

    cmds = {"info": cmd_info, "hist": cmd_hist, "coverage": cmd_coverage}
    if args.cmd:
        cmds[args.cmd]()
        return
    print("commands: info hist coverage quit")
    for line in sys.stdin:
        c = line.strip()
        if c in ("quit", "q", "exit"):
            break
        if c in cmds:
            cmds[c]()
        elif c:
            print(f"unknown command {c!r}; commands: info hist coverage quit")


# ---------------------------------------------------------------------------
# registry (ife_tpu's)
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Tuple] = {
    "extract-features": (conf_extract_features, run_extract_features,
                         "8-channel multi-scale feature volumes (ExtractFeatures)"),
    "make-bag": (conf_make_bag, run_make_bag,
                 "per-ROI feature histogram bag CSV (MakeBag)"),
    "make-bag-dense": (conf_make_bag_dense, run_make_bag_dense,
                       "bag with an ROI at every foreground voxel (MakeBagDense)"),
    "make-bag-only-intensity": (conf_make_bag_only_intensity,
                                run_make_bag_only_intensity,
                                "raw-intensity bag (MakeBagOnlyIntensity)"),
    "determine-bin-edges": (conf_determine_bin_edges, run_determine_bin_edges,
                            "equalized histogram bin edges over an image list "
                            "(DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures)"),
    "masked-normalized-convolution": (conf_masked_normalized_convolution,
                                      run_masked_normalized_convolution,
                                      "normalized Gaussian convolution (MaskedNormalizedConvolution)"),
    "gradient-features": (conf_gradient_features, run_gradient_features,
                          "masked gradient magnitude (FiniteDifference_GradientFeatures)"),
    "hessian-features": (conf_hessian_features, run_hessian_features,
                         "raw Hessian eigen-feature volumes "
                         "(FiniteDifference_HessianFeatures, fixed)"),
    "generate-rois": (conf_generate_rois, run_generate_rois,
                      "random ROI boxes from a mask (GenerateROIs)"),
    "generate-rois-many-regions": (conf_generate_rois_many_regions,
                                   run_generate_rois_many_regions,
                                   "random ROIs per mask label (GenerateROIsManyRegions)"),
    "sample-rois": (conf_sample_rois, run_sample_rois,
                    "raw voxel matrix per ROI (SampleROIs)"),
    "extract-labels": (conf_extract_labels, run_extract_labels,
                       "per-ROI mode label (ExtractLabels)"),
    "masked-image-filter": (conf_masked_image_filter, run_masked_image_filter,
                            "mask an image (MaskedImageFilter)"),
    "extract-masked-region": (conf_extract_masked_region,
                              run_extract_masked_region,
                              "relabel mask by include-set (ExtractMaskedRegion)"),
    "extract-bounding-box": (conf_extract_bounding_box, run_extract_bounding_box,
                             "crop to mask bounding box (ExtractBoundingBox)"),
    "extract-slices": (conf_extract_slices, run_extract_slices,
                       "2D slices along an axis (ExtractSlices)"),
    "extract-window": (conf_extract_window, run_extract_window,
                       "resample + intensity window to uint8 (ExtractWindow)"),
    "pad-image": (conf_pad_image, run_pad_image,
                  "centered constant pad of a 2D image (PadImage)"),
    "resample": (conf_resample, run_resample,
                 "resample source onto target grid (Resample)"),
    "convert-hr2": (conf_convert_hr2, run_convert_hr2,
                    "convert .hr2 to a standard volume (ConvertHR2)"),
    "convert-dicom": (conf_convert_dicom, run_convert_dicom,
                      "convert DICOM series directory (ConvertDICOM)"),
    "convert-from-octave": (conf_convert_from_octave, run_convert_from_octave,
                            "convert Octave ASCII matrix (ConvertFromOctave)"),
    "merge-bags": (conf_merge_bags, run_merge_bags,
                   "merge per-image bags + labels into a bagged dataset "
                   "(MakeBaggedDataset, fixed)"),
    "expected-distance": (conf_expected_distance, run_expected_distance,
                          "E[signed distance x probability] over a mask "
                          "(CalculateExpectedDistanceFromCenterToInterestPoints)"),
    "image-browser": (conf_image_browser, run_image_browser,
                      "image info / histogram / ROI coverage REPL (ImageBrowser)"),
}
