"""The roofline probes of the TPU kernels, as kernels of the card, under the
names of the scripts they come from, each with its plain PyTorch twin.

  trivial6      benchmarks/probe10.py:56 and benchmarks/probe11.py:63 (one
                function at two call sites)  -> csrc/probes.cu ife_trivial6
  pcopy1        benchmarks/probe11.py:84     -> csrc/probes.cu ife_pcopy1
  floor_window  benchmarks/probe11.py:99, the function of
                ife_tpu/kernels/fused.py:472-478 (fused_hessian_eig's
                variant="copyfloor")   -> csrc/hessian_eig.cu, kCopyFloor
  variant       benchmarks/probe_fused.py:45 (_variant_kernel :29): "copy6"
                and "stencil6"  -> csrc/hessian_eig.cu, kCopy6 / kStencil6;
                "full" is fused_hessian_eig

The scripts' timing loops are chip_smoke.py's (`--probes`). A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain twin
(`use_plain_twin`); there is no other path.

Divergence, documented: the TPU probes tile (8, 128) blocks of x and y and
are defined only where X % 8 == 0 and Y % 128 == 0 (elsewhere they leave the
outputs unwritten); these run on any (X, Y, Z) shape. And XLA folds
`x + 0.0` to `x`, so ife_tpu's copy floor keeps a -0 input at k = 0 where
these (kernel and twin, IEEE) give +0.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ife_tpu_torch.kernels._build import check_cuda_volume, launch, use_plain_twin
from ife_tpu_torch.kernels.hessian_eig import (
    fused_hessian_eig, hessian_eig_copyfloor_plain, hessian_eig_plain,
    hessian_output_kernel,
)
from ife_tpu_torch.ops.stencil import hessian

# probe_fused.py's spacing
PROBE_SPACING = (0.78, 0.78, 1.0)
VARIANT_MODES = ("copy6", "stencil6", "full")
# (Dxx, Dyy, Dzz, Dxy, Dxz, Dyz) from ops.stencil.hessian's packed
# (xx, xy, xz, yy, yz, zz)
_STENCIL6_ORDER = (0, 3, 5, 1, 2, 4)


def _f32(c: float) -> float:
    """c rounded once to float32, as jnp.asarray(c, float32) does: the
    multiplier the TPU probe's kernel applies."""
    return float(torch.tensor(c, dtype=torch.float64).float())


PCOPY1_SCALE = _f32(1.000001)
TRIVIAL6_SCALES = tuple(_f32(1.0 + 1e-6 * k) for k in range(6))


_MAX_N = 0x7FFF0000  # csrc/probes.cu kProbeMaxN: the kernels index in 32 bits


def _check_width(name: str, width: int) -> None:
    if width not in (1, 4):
        raise ValueError(f"{name}: width must be 1 (a float a thread) or 4 "
                         f"(float4), got {width!r}")


def _scaled_copies(name: str, x: torch.Tensor, scales, width: int):
    """Launch ife_pcopy1 / ife_trivial6 on x: one output per scale, each
    its own (16-byte aligned) allocation."""
    check_cuda_volume(name, x)
    if width == 4 and x.data_ptr() % 16:
        raise ValueError(f"{name}: width 4 needs a 16-byte aligned tensor "
                         "(a view at an offset is not)")
    if x.numel() > _MAX_N:
        raise ValueError(f"{name}: at most {_MAX_N} voxels, got {x.numel()}")
    outs = tuple(torch.empty_like(x) for _ in scales)
    entry = "pcopy1" if len(scales) == 1 else "trivial6"
    launch(entry, x.device, x.data_ptr(), *(o.data_ptr() for o in outs),
           x.numel(), width, *scales)
    return outs


def pcopy1_plain(x: torch.Tensor) -> torch.Tensor:
    """x * f32(1.000001)."""
    return x * PCOPY1_SCALE


def pcopy1(x: torch.Tensor, width: int = 4) -> torch.Tensor:
    """out = x * f32(1.000001): one read, one write (probe11's pcopy1).
    width: 1 float or a float4 a thread, on the card."""
    _check_width("pcopy1", width)
    if use_plain_twin("pcopy1", x):
        return pcopy1_plain(x)
    return _scaled_copies("pcopy1", x, (PCOPY1_SCALE,), width)[0]


def trivial6_plain(x: torch.Tensor):
    """x * f32(1 + 1e-6 k), k = 0..5."""
    return tuple(x * c for c in TRIVIAL6_SCALES)


def trivial6(x: torch.Tensor, width: int = 4):
    """Six outputs x * f32(1 + 1e-6 k) from one read (probe10's and
    probe11's trivial6). Tuple of six; width as pcopy1."""
    _check_width("trivial6", width)
    if use_plain_twin("trivial6", x):
        return trivial6_plain(x)
    return _scaled_copies("trivial6", x, TRIVIAL6_SCALES, width)


# probe11's floor_window computes fused_hessian_eig's copy floor
floor_window_plain = hessian_eig_copyfloor_plain


def floor_window(x: torch.Tensor):
    """x + k, k = 0..5, through the Hessian kernel's neighbourhood loads and
    stores (probe11's floor_window): the copy floor of that kernel shape.
    Tuple of six."""
    return fused_hessian_eig(x, stack=False, variant="copyfloor")


def variant_plain(x: torch.Tensor, mode: str,
                  spacing: Sequence[float] = PROBE_SPACING):
    """The twin of `variant`: x six times, the six second derivatives
    (Dxx, Dyy, Dzz, Dxy, Dxz, Dyz) of ops.stencil.hessian, or the Hessian
    kernel's twin."""
    if mode == "copy6":
        return tuple(x.clone() for _ in range(6))
    if mode == "stencil6":
        h = hessian(x, spacing)
        return tuple(h[..., c] for c in _STENCIL6_ORDER)
    if mode == "full":
        return hessian_eig_plain(x, spacing)
    raise ValueError(f"variant: mode must be one of {VARIANT_MODES}, "
                     f"got {mode!r}")


def variant(x: torch.Tensor, mode: str,
            spacing: Sequence[float] = PROBE_SPACING):
    """probe_fused's variant: the Hessian kernel's loads and stores with
    "copy6" (the centre, six times), "stencil6" (Dxx, Dyy, Dzz, Dxy, Dxz, Dyz,
    no eigen solve) or "full" (fused_hessian_eig). Tuple of six."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"variant: mode must be one of {VARIANT_MODES}, "
                         f"got {mode!r}")
    if mode == "full":
        return fused_hessian_eig(x, spacing, stack=False)
    if use_plain_twin("variant", x):
        return variant_plain(x, mode, spacing)
    return tuple(hessian_output_kernel("variant", x, mode, spacing).unbind(0))
