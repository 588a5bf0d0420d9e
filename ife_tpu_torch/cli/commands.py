"""Subcommand implementations for the port's CLI (counterpart of
ife_tpu/cli/commands.py): the feature subcommands, determine-bin-edges,
make-bag and generate-rois.

REGISTRY maps subcommand name -> (configure(parser), run(args), help). The
compute runs on this process's CUDA device; IFE_PLATFORM=cpu asks for the
CPU, and without it a host that has no card raises (parallel.mesh
default_device). Volumes are read and written on the host.

--sharded cuts the volume into a mesh of blocks (parallel/): --blocks of them
in this process, or, with --coordinator / --num-processes / --process-id,
dealt to the processes of torch.distributed, each on its own device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _triple(s: str, cast=int):
    parts = [p for p in s.replace(",", " ").split() if p]
    if len(parts) != 3:
        raise ValueError(f"expected 3 comma-separated values, got {s!r}")
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
                             "written", voxels=img.numel(), emit=True):
                features8_sharded_channels_to(img, msk, float(s), mesh, write,
                                              vol.spacing)
        else:
            with stage_timer(f"features8[s={s:g}]", voxels=img.numel(),
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


def conf_make_bag(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-b", "--bins", dest="hist_spec", required=True,
                   help="histogram spec file (bin edges)")
    p.add_argument("-o", "--out", required=True, help="output prefix")
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


# ---------------------------------------------------------------------------
# registry (the other ife_tpu subcommands are not ported yet)
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Tuple] = {
    "extract-features": (conf_extract_features, run_extract_features,
                         "8-channel multi-scale feature volumes (ExtractFeatures)"),
    "masked-normalized-convolution": (conf_masked_normalized_convolution,
                                      run_masked_normalized_convolution,
                                      "normalized Gaussian convolution (MaskedNormalizedConvolution)"),
    "gradient-features": (conf_gradient_features, run_gradient_features,
                          "masked gradient magnitude (FiniteDifference_GradientFeatures)"),
    "hessian-features": (conf_hessian_features, run_hessian_features,
                         "raw Hessian eigen-feature volumes "
                         "(FiniteDifference_HessianFeatures, fixed)"),
    "make-bag": (conf_make_bag, run_make_bag,
                 "per-ROI feature histogram bag CSV (MakeBag)"),
    "determine-bin-edges": (conf_determine_bin_edges, run_determine_bin_edges,
                            "equalized histogram bin edges over an image list "
                            "(DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures)"),
    "generate-rois": (conf_generate_rois, run_generate_rois,
                      "random ROI boxes from a mask (GenerateROIs)"),
}
