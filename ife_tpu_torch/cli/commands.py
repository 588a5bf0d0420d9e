"""Subcommand implementations for the port's CLI (counterpart of
ife_tpu/cli/commands.py, first slice: the feature subcommands).

REGISTRY maps subcommand name -> (configure(parser), run(args), help). The
compute runs on the first CUDA device when there is one, else on the CPU;
volumes are read and written on the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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

def conf_extract_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--sharded", action="store_true",
                   help="block-shard the volume over all devices "
                   "(not yet ported: raises)")


def run_extract_features(args):
    """Reference tools/ExtractFeatures.cxx: per scale, 8 feature volumes
    written as <out>_scale_<s><FeatureName>.nii.gz."""
    from ife_tpu_torch.ops.features import FEATURE_NAMES, features8_auto_channels
    from ife_tpu_torch.utils import stage_timer

    if args.sharded:
        raise NotImplementedError(
            "extract-features --sharded is not yet ported to ife_tpu_torch")
    dev = _device()
    vol = _load(args.image)
    mask = _load(args.mask)
    img = vol.data.to(device=dev, dtype=torch.float32).contiguous()
    msk = mask.data.to(dev)
    for s in args.scales:
        _progress(f"Processing scale {s:g}")
        with stage_timer(f"features8[s={s:g}]", voxels=img.numel(), emit=True):
            feats = [c.cpu() for c in features8_auto_channels(
                img, msk, float(s), vol.spacing)]
        for name, ch in zip(FEATURE_NAMES, feats):
            _save(f"{args.out}_scale_{s:g}{name}.nii.gz", vol.with_data(ch))


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
                   help="call the fused kernel entry point (on CUDA both "
                   "forms run the hessian_eig kernel)")


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
        from ife_tpu_torch.ops.features import hessian_eig_features

        feats = hessian_eig_features(img, vol.spacing).unbind(-1)
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
}
