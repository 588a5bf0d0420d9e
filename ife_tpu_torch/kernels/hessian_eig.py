"""Hessian + eigen features of the unsmoothed volume: the CUDA kernel
``csrc/hessian_eig.cu`` and its plain PyTorch twins.

Replaces ife_tpu/kernels/fused.py:fused_hessian_eig_stream (and
fused_hessian_eig, the same math through TPU DMA windows — here one kernel
under both names), with their shard modes x_halo and pre_padded. Bound by
bytes on the H100 (1 read + 6 writes of f32 per voxel); see the source for
the design, and ``hessian_plan`` for its launch. The kernel's other outputs
(``HESSIAN_OUTPUTS``) are counted apart in LAUNCHES: the reference's eigen
path (``hessian_eig_reference_features``, the function of
ife_tpu.ops.features.hessian_eig_features), the copy floor of
fused_hessian_eig's variant="copyfloor", and probe_fused's copy6 and
stencil6 (kernels/probes.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import (
    check_cuda_volume, launch, use_plain_twin,
)
from ife_tpu_torch.ops.eigen import eigenvalue_feature_channels
from ife_tpu_torch.ops.stencil import hessian


def stencil_reciprocals(spacing: Sequence[float]):
    """(1/2hx, 1/2hy, 1/2hz, 1/hx^2, 1/hy^2, 1/hz^2) folded in f64 — the
    constants ops.stencil.derivative multiplies by (ife_tpu
    kernels/fused.py:172-177); ctypes rounds each once to f32."""
    hx, hy, hz = (float(v) for v in spacing)
    return (1.0 / (2.0 * hx), 1.0 / (2.0 * hy), 1.0 / (2.0 * hz),
            1.0 / (hx * hx), 1.0 / (hy * hy), 1.0 / (hz * hz))


def halo_rows(name: str, x_halo, shape, like: torch.Tensor):
    """The (lo, hi) pair of an x_halo operand, checked: each a (1, Y, Z)
    tensor of `like`'s dtype and device."""
    lo, hi = x_halo
    for side, h in (("lo", lo), ("hi", hi)):
        if (tuple(h.shape) != (1,) + tuple(shape[1:]) or h.dtype != like.dtype
                or h.device != like.device):
            raise ValueError(
                f"{name}: x_halo {side} row must be {(1,) + tuple(shape[1:])} "
                f"{like.dtype} on {like.device}, got {tuple(h.shape)} "
                f"{h.dtype} on {h.device}")
    return lo, hi


def with_shard_halo(plain, x: torch.Tensor, x_halo, pre_padded: bool):
    """The shard modes of a plain twin `plain(volume) -> channels`: run it on
    the block extended by its halo rows (x_halo), or on the block that
    already carries its boundary layer (pre_padded), and keep the core.
    The extension's outer clamp touches only what is cropped."""
    if x_halo is not None:
        lo, hi = x_halo
        return tuple(c[1:-1] for c in plain(torch.cat([lo, x, hi], dim=0)))
    if pre_padded:
        return tuple(c[1:-1, 1:-1] for c in plain(x))
    return tuple(plain(x))


def stencil_mode(name: str, x_halo, pre_padded: bool) -> int:
    """csrc/features8_tail.cuh StencilMode of a call."""
    if x_halo is not None and pre_padded:
        raise ValueError(f"{name}: x_halo and pre_padded are mutually exclusive")
    return 1 if x_halo is not None else (2 if pre_padded else 0)


def hessian_eig_plain(x: torch.Tensor,
                      spacing: Sequence[float] = (1.0, 1.0, 1.0),
                      x_halo=None, pre_padded: bool = False):
    """The kernel's plain twin: the six eigen features of the
    central-difference Hessian, on the polynomial no-diagonal eigen path the
    kernel computes, in the kernel's shard modes. Tuple of six tensors of
    the core's shape."""
    def plain(v):
        return eigenvalue_feature_channels(
            *hessian(v, spacing).unbind(-1), use_trig=False, diag_path=False)

    return with_shard_halo(plain, x, x_halo, pre_padded)


def hessian_eig_reference_plain(x: torch.Tensor,
                                spacing: Sequence[float] = (1.0, 1.0, 1.0)):
    """The reference output's plain twin: the six eigen features of the
    central-difference Hessian on the reference's path (trig, with the exact
    diagonal branch: eigenvalue_feature_channels' defaults), the function of
    ife_tpu.ops.features.hessian_eig_features. Tuple of six tensors."""
    return eigenvalue_feature_channels(*hessian(x, spacing).unbind(-1))


# csrc/hessian_eig.cu HessianOutput: what the kernel writes per voxel
HESSIAN_OUTPUTS = {"features": 0, "copyfloor": 1, "copy6": 2, "stencil6": 3,
                   "reference": 4}
# csrc/hessian_eig.cu's block: a thread owns a run of `run` voxels along z,
# a warp one row of 32 runs, a block `tile_y` rows of one x plane
HESSIAN_TILE = {"run": 4, "tile_z": 128, "tile_y": 8, "threads": 256}


@dataclass(frozen=True)
class HessianPlan:
    """A launch of csrc/hessian_eig.cu on an (X, Y, Z) core: grid (z tiles,
    y tiles, X) of `threads` threads (no shared memory). Block (bz, by, bx)
    writes plane x = bx, rows [by tile_y, +tile_y) and columns
    [bz tile_z, +tile_z), each clipped to the core; a thread the run of
    `run` voxels at z = bz tile_z + run lane of row by tile_y + warp."""
    grid: tuple
    threads: int
    run: int
    tile_y: int
    tile_z: int


def hessian_plan(X: int, Y: int, Z: int) -> HessianPlan:
    """The Hessian kernel's launch on an (X, Y, Z) core, the same in every
    mode and output (a shard mode changes where a row is read, not which
    voxels a block writes): the grid its launcher computes
    (launch_hessian)."""
    t = HESSIAN_TILE
    return HessianPlan((-(-Z // t["tile_z"]), -(-Y // t["tile_y"]), X),
                       t["threads"], t["run"], t["tile_y"], t["tile_z"])


def _launch(name: str, x: torch.Tensor, lo, hi, core, mode: int, output: str,
            spacing, count_as):
    """Launch csrc/hessian_eig.cu on x (checked by the caller) for the core
    shape `core`; the (6, X, Y, Z) output."""
    X, Y, Z = core
    if (Y + 2) * Z >= 2**31:
        raise ValueError(f"{name}: a plane of {Y} x {Z} voxels (its layer "
                         "included) must hold < 2^31 of them: the kernel "
                         "offsets within a plane in 32 bits")
    out = torch.empty((6, X, Y, Z), dtype=x.dtype, device=x.device)
    launch("hessian_eig", x.device, x.data_ptr(),
           None if lo is None else lo.data_ptr(),
           None if hi is None else hi.data_ptr(), out.data_ptr(), X, Y, Z,
           mode, HESSIAN_OUTPUTS[output], *stencil_reciprocals(spacing),
           count_as=count_as)
    return out


def hessian_eig_copyfloor_plain(x: torch.Tensor):
    """The copy floor's plain twin: x + k, k = 0..5 (the add kept at k = 0,
    so -0 turns +0 as in the kernel). Tuple of six tensors."""
    return tuple(x + float(k) for k in range(6))


def hessian_output_kernel(name: str, x: torch.Tensor, output: str,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0)):
    """Launch the Hessian kernel on the whole volume x (a CUDA tensor) with
    the output `output` of HESSIAN_OUTPUTS other than the features; a
    (6, X, Y, Z) tensor. Counted in LAUNCHES as hessian_eig_<output>."""
    check_cuda_volume(name, x)
    return _launch(name, x, None, None, x.shape, 0, output, spacing,
                   f"hessian_eig_{output}")


def hessian_eig_reference_features(x: torch.Tensor,
                                   spacing: Sequence[float] = (1.0, 1.0, 1.0)):
    """[e1, e2, e3, LoG, GaussianCurvature, FrobeniusNorm] of the Hessian of
    x on the reference's eigen path (hessian_eig_reference_plain): the
    function of ife_tpu.ops.features.hessian_eig_features, where
    fused_hessian_eig_stream computes the Pallas kernel's polynomial path
    without the diagonal branch (the two order tied eigenvalues
    differently). Whole volume; a tuple of six (X, Y, Z) tensors.

    A CUDA tensor (contiguous float32) launches the kernel's reference
    output, counted as hessian_eig_reference; a CPU tensor runs the twin."""
    name = "hessian_eig_reference_features"
    if use_plain_twin(name, x):
        return hessian_eig_reference_plain(x, spacing)
    return tuple(hessian_output_kernel(name, x, "reference", spacing).unbind(0))


def fused_hessian_eig_stream(x: torch.Tensor,
                             spacing: Sequence[float] = (1.0, 1.0, 1.0),
                             stack: bool = True, x_halo=None,
                             pre_padded: bool = False):
    """[e1, e2, e3, LoG, GaussianCurvature, FrobeniusNorm] of the Hessian of
    x, eigenvalues ordered |e3| <= |e2| <= |e1|: a (6, X, Y, Z) tensor when
    stack, else a tuple of six (X, Y, Z) tensors.

    x_halo: a ((1, Y, Z), (1, Y, Z)) pair, the rows -1 and X of x (a
    neighbouring shard's rows); the kernel reads them at the x faces instead
    of clamping, so no extended block is built. pre_padded: x is
    (X + 2, Y + 2, Z) and carries a one-voxel boundary layer on x and y
    around the (X, Y, Z) core, which alone is computed and written. The two
    exclude each other.

    A CUDA tensor (contiguous float32) launches the kernel; a CPU tensor runs
    the plain twin (any float dtype); any other input raises.
    """
    name = "fused_hessian_eig_stream"
    mode = stencil_mode(name, x_halo, pre_padded)
    if use_plain_twin(name, x):
        feats = hessian_eig_plain(x, spacing, x_halo, pre_padded)
        return torch.stack(feats, dim=0) if stack else feats
    check_cuda_volume(name, x)
    X, Y, Z = x.shape
    lo = hi = None
    if mode == 1:
        lo, hi = (h.contiguous() for h in halo_rows(name, x_halo, x.shape, x))
    elif mode == 2:
        X, Y = X - 2, Y - 2
        if min(X, Y) < 1:
            raise ValueError(f"{name}: pre_padded needs a core of >= 1 voxel, "
                             f"got a block of {tuple(x.shape)}")
    out = _launch(name, x, lo, hi, (X, Y, Z), mode, "features", spacing,
                  (None, "hessian_eig_x_halo", "hessian_eig_pre_padded")[mode])
    return out if stack else tuple(out.unbind(0))


def fused_hessian_eig(x: torch.Tensor,
                      spacing: Sequence[float] = (1.0, 1.0, 1.0),
                      stack: bool = True, x_halo=None,
                      pre_padded: bool = False, variant: str = "features"):
    """ife_tpu's windowed fused_hessian_eig: the same function as
    fused_hessian_eig_stream (its DMA window was a TPU artefact, so on the
    card it is the one kernel; ife_tpu's has pre_padded alone of the two
    shard modes), plus its roofline probe.

    variant: "features" (the default) computes the features;
    "copyfloor" writes x + k as channel k = 0..5 through the kernel's own
    loads and stores (ife_tpu/kernels/fused.py:472-478), whole volume only.
    ife_tpu's "concat" and "roll" choose how Mosaic shifts lanes, with the
    same outputs: the card has no counterpart, and they raise here like any
    other value.
    """
    name = "fused_hessian_eig"
    if variant == "features":
        return fused_hessian_eig_stream(x, spacing, stack, x_halo, pre_padded)
    if variant != "copyfloor":
        raise ValueError(f"{name}: variant must be 'features' or 'copyfloor', "
                         f"got {variant!r}")
    if x_halo is not None or pre_padded:
        raise ValueError(f"{name}: variant='copyfloor' takes the whole volume "
                         "(no x_halo, no pre_padded)")
    if use_plain_twin(name, x):
        feats = hessian_eig_copyfloor_plain(x)
        return torch.stack(feats, dim=0) if stack else feats
    out = hessian_output_kernel(name, x, "copyfloor", spacing)
    return out if stack else tuple(out.unbind(0))
