"""Sharded feature ops: the single-device ops of ife_tpu_torch.ops
re-expressed over a block-sharded voxel grid (counterpart of
ife_tpu/parallel/features.py).

Design, as in ife_tpu:
  * the volume is cut into blocks along X (1D mesh) or X, Y (2D mesh); Z
    stays whole;
  * Gaussian smoothing along a cut axis = a radius-R halo exchange + a VALID
    FIR that produces exactly the kept region (the halo's edge replication
    reproduces the ZeroFluxNeumann clamp);
  * the finite differences after smoothing need radius 1 per axis — one more
    halo exchange of the smoothed field;
  * eigen features and masking are local to a voxel;
  * the blocks compose into the same global array as ops.features.features8.

Two routes per op, chosen by `use_fused` (None: the kernels when the blocks
are CUDA tensors, the plain ops on the CPU):
  * the kernels in their shard modes: fused_features8_sweep with `clamps`
    on the block extended by (radius + 1), or fused_normalized_conv_sweep
    on the block extended by the radius and then the post kernel with
    `x_halo` (1D) or `pre_padded` (2D); fused_hessian_eig_stream alike.
    Given CPU blocks they run their plain twins, so the clamp and halo
    logic is tested without a card;
  * the plain ops, exchange by exchange as ife_tpu's XLA route.

Every function takes and returns ShardedVolumes (this process's blocks); the
exchanges inside are collective, so every process of the mesh calls them
together.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ife_tpu_torch.kernels.features8_post import fused_features8_post_stream
from ife_tpu_torch.kernels.features8_sweep import NO_FACE, fused_features8_sweep
from ife_tpu_torch.kernels.hessian_eig import fused_hessian_eig_stream
from ife_tpu_torch.kernels.normalized_conv import fused_normalized_conv_sweep
from ife_tpu_torch.ops import stencil
from ife_tpu_torch.ops.eigen import eigenvalue_features
from ife_tpu_torch.ops.features import clamp_mask, features8_dispatch_branch
from ife_tpu_torch.parallel.halo import _slab, halo_exchange, halo_slabs
from ife_tpu_torch.parallel.mesh import (
    BlockMesh, ShardedVolume, crop_from_mesh, gather_volume, gather_volume_to,
    pad_to_mesh, shard_volume,
)


def _cut_axes(mesh: BlockMesh) -> Tuple[int, ...]:
    """The volume axes the mesh cuts (an axis with one block is whole)."""
    return tuple(a for a, n in enumerate(mesh.dims) if n > 1)


def _radius(sigma: float, spacing: float, truncate: float) -> int:
    return stencil.gaussian_radius(float(sigma) / float(spacing), truncate)


# ---------------------------------------------------------------------------
# plain route: Gaussian and finite differences on halo-extended blocks
# ---------------------------------------------------------------------------

def _smooth_axis_block(x: ShardedVolume, axis: int, sigma: float,
                       spacing: float, truncate: float) -> ShardedVolume:
    """Gaussian along a CUT axis: halo exchange + VALID FIR — the halo
    (neighbours' planes / edge replication at true faces) plays the role of
    stencil.gaussian_smooth_axis's edge pad, so results match the
    single-device op."""
    if sigma <= 0:
        return x
    sigma_vox = float(sigma) / float(spacing)
    radius = stencil.gaussian_radius(sigma_vox, truncate)
    ext = halo_exchange(x, axis, radius)
    return ext.map(
        lambda b: stencil.convolve_valid_axis(b, axis, sigma_vox, radius))


Exts = Dict[int, int]  # axis -> halo width the array still carries


def _d(arr: torch.Tensor, exts: Exts, axis: int, order: int, h: float
       ) -> Tuple[torch.Tensor, Exts]:
    """Central difference along `axis`. Consumes the axis's halo level if it
    has one; otherwise ZeroFluxNeumann edge padding (right only for uncut
    axes — callers guarantee that)."""
    if exts.get(axis, 0) > 0:
        n_out = arr.shape[axis] - 2
        fm = _slab(arr, axis, 0, n_out)
        f0 = _slab(arr, axis, 1, n_out)
        fp = _slab(arr, axis, 2, n_out)
        # the f64-folded reciprocals of stencil.derivative
        hf = float(h)
        if order == 1:
            out = (fp - fm) * (1.0 / (2.0 * hf))
        else:
            out = (fp - 2 * f0 + fm) * (1.0 / (hf * hf))
        new = dict(exts)
        new.pop(axis)
        return out, new
    return stencil.derivative(arr, axis, order, h), dict(exts)


def _crop(arr: torch.Tensor, exts: Exts) -> torch.Tensor:
    """Drop any remaining halo extensions, yielding the kept block."""
    for axis, hh in exts.items():
        if hh > 0:
            arr = _slab(arr, axis, hh, arr.shape[axis] - 2 * hh)
    return arr


def _grad_hessian_block(s: ShardedVolume, spacing: Sequence[float]
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per local block, (gradient magnitude, 6-channel Hessian), matching
    stencil.gradient_magnitude / stencil.hessian globally."""
    E = s
    exts: Exts = {}
    for axis in _cut_axes(s.mesh):
        E = halo_exchange(E, axis, 1)
        exts[axis] = 1

    def one(e):
        def D(arr, ex, axis, order):
            return _d(arr, ex, axis, order, spacing[axis])

        gs = []
        for axis in range(3):
            g, rem = D(e, exts, axis, 1)
            gs.append(_crop(g, rem))
        gm = torch.sqrt(gs[0] * gs[0] + gs[1] * gs[1] + gs[2] * gs[2])
        pure = []
        for axis in range(3):
            dd, rem = D(e, exts, axis, 2)
            pure.append(_crop(dd, rem))
        dx, ex1 = D(e, exts, 0, 1)
        dxy, rem = D(dx, ex1, 1, 1)
        dxy = _crop(dxy, rem)
        dxz, rem = D(dx, ex1, 2, 1)
        dxz = _crop(dxz, rem)
        dy, ex2 = D(e, exts, 1, 1)
        dyz, rem = D(dy, ex2, 2, 1)
        dyz = _crop(dyz, rem)
        H = torch.stack([pure[0], dxy, dxz, pure[1], dyz, pure[2]], dim=-1)
        return gm, H

    return [one(e) for e in E.blocks]


def _halo_or_edge_pad(arr: ShardedVolume, radius=1) -> ShardedVolume:
    """Extend X and Y by `radius` (an int or per-axis (rx, ry)): neighbours'
    planes on cut axes (true faces edge-replicated), edge pad on whole ones —
    the boundary layer the pre_padded kernels consume. halo_exchange does
    both: an axis with one block has only true faces."""
    radii = (radius, radius) if isinstance(radius, int) else radius
    for axis in (0, 1):
        arr = halo_exchange(arr, axis, radii[axis])
    return arr


# ---------------------------------------------------------------------------
# features8 per block
# ---------------------------------------------------------------------------

def _features8_block(img: ShardedVolume, msk: ShardedVolume, sigma: float,
                     spacing: Sequence[float], truncate: float,
                     use_fused: bool) -> List[Tuple[torch.Tensor, ...]]:
    """The staged features8 of every local block: smoothing, divide, then the
    tail. Per block a tuple of 8 channels."""
    mesh = img.mesh
    cut = _cut_axes(mesh)
    m = msk.map(clamp_mask)
    mf = ShardedVolume(mesh, [b.to(img.dtype) for b in m.blocks])

    if use_fused:
        # the normalized-convolution kernel on the block extended by the
        # smoothing radius along the cut axes: its own clamp then touches
        # only halo planes, whose values are cropped, and the core equals
        # the single-device kernel to the bit (same taps in the same order)
        radii = [_radius(sigma, spacing[a], truncate) if a in cut else 0
                 for a in (0, 1)]
        img_e = _halo_or_edge_pad(img, radii)
        mf_e = _halo_or_edge_pad(mf, radii)
        core = img.blocks[0].shape
        s = ShardedVolume(mesh, [
            fused_normalized_conv_sweep(
                i.contiguous(), c.contiguous(), float(sigma), tuple(spacing),
                truncate)[radii[0]:radii[0] + core[0],
                          radii[1]:radii[1] + core[1]]
            for i, c in zip(img_e.blocks, mf_e.blocks)])
        if set(cut) <= {0}:
            # 1D mesh: the two neighbour ROWS of the smoothed field ride into
            # the kernel as x_halo, no extended block is built (the x crop
            # above is a contiguous view)
            if 0 in cut:
                los, his = halo_slabs(s, 0, 1)
                halos = list(zip(los, his))
            else:
                halos = [None] * len(s.blocks)
            return [fused_features8_post_stream(
                b, c.contiguous(), tuple(spacing), stack=False, x_halo=h)
                for b, c, h in zip(s.blocks, mf.blocks, halos)]
        s_ext = _halo_or_edge_pad(s)
        return [fused_features8_post_stream(
            b.contiguous(), c.contiguous(), tuple(spacing), stack=False,
            pre_padded=True) for b, c in zip(s_ext.blocks, mf.blocks)]

    def smooth(vol: ShardedVolume) -> ShardedVolume:
        for axis in range(3):
            if axis in cut:
                vol = _smooth_axis_block(vol, axis, sigma, spacing[axis],
                                         truncate)
            else:
                vol = vol.map(lambda b: stencil.gaussian_smooth_axis(
                    b, axis, sigma, spacing[axis], truncate))
        return vol

    num = smooth(ShardedVolume(mesh, [i * c for i, c in
                                      zip(img.blocks, mf.blocks)]))
    den = smooth(mf)
    s = ShardedVolume(mesh, [n / d for n, d in zip(num.blocks, den.blocks)])
    out = []
    for sb, mb, (gm, H) in zip(s.blocks, m.blocks,
                               _grad_hessian_block(s, spacing)):
        eig = eigenvalue_features(H)
        inside = mb != 0
        zero = torch.zeros((), dtype=sb.dtype, device=sb.device)
        out.append(tuple(torch.where(inside, c, zero)
                         for c in (sb, gm, *eig.unbind(-1))))
    return out


def _features8_block_sweep(img: ShardedVolume, msk: ShardedVolume,
                           sigma: float, spacing: Sequence[float],
                           truncate: float, radii: Tuple[int, int]
                           ) -> List[Tuple[torch.Tensor, ...]]:
    """features8 of every local block through the whole-pass sweep kernel:
    exchange a (smoothing radius + 1)-deep halo on the cut axes, run
    fused_features8_sweep on the extended block, keep the core.

    SMOOTHING composes exactly through the halo (neighbours' data inside the
    volume; edge replication at true faces IS clamp smoothing). The STENCIL
    does not: at a true face its phantom must clamp to the SMOOTHED field
    (s(-1) := s(0)), which is NOT the smoothing of the replicated raw rows the
    halo holds there (ife_tpu measured 35-50% error on the derivative
    channels of the outermost layers before its kernel took clamp rows). The
    kernel therefore takes the kept core's faces on true-volume sides and
    -/+NO_FACE on interior block boundaries, where the halo data is real."""
    mesh = img.mesh
    cut = _cut_axes(mesh)
    core = img.blocks[0].shape
    lo = [0, 0]
    mf = ShardedVolume(mesh, [b.to(img.dtype) for b in msk.blocks])
    for axis in (0, 1):
        if axis in cut:
            lo[axis] = radii[axis] + 1
            img = halo_exchange(img, axis, lo[axis])
            mf = halo_exchange(mf, axis, lo[axis])
    out = []
    for b, i, c in zip(mesh.local_blocks, img.blocks, mf.blocks):
        coords = mesh.coords(b)
        cl = []
        for axis in (0, 1):
            if axis in cut:
                first = coords[axis] == 0
                last = coords[axis] == mesh.dims[axis] - 1
                cl += [lo[axis] if first else -NO_FACE,
                       lo[axis] + core[axis] - 1 if last else NO_FACE]
            else:
                cl += [0, core[axis] - 1]
        feats = fused_features8_sweep(
            i.contiguous(), c.contiguous(), float(sigma), tuple(spacing),
            float(truncate), stack=False, clamps=cl)
        out.append(tuple(f[lo[0]:lo[0] + core[0], lo[1]:lo[1] + core[1]]
                         for f in feats))
    return out


def _sweep_block_plan(mesh: BlockMesh, sigma, spacing, truncate):
    """(fits, radii): whether the blocks go through the sweep kernel — the
    scale within its shared memory and within the x radius up to which
    ops.features dispatches it — and the smoothing radii (rx, ry). The
    block's extent does not matter on the card: the sweep tiles y and z."""
    rx, ry = (_radius(sigma, spacing[a], truncate) for a in (0, 1))
    fits = features8_dispatch_branch(sigma, spacing, None, truncate) == "sweep"
    return fits, (rx, ry)


# ---------------------------------------------------------------------------
# public sharded ops
# ---------------------------------------------------------------------------

def _resolve_use_fused(use_fused, x: ShardedVolume) -> bool:
    """None -> the kernels when the blocks are CUDA tensors, the plain ops
    on the CPU."""
    if use_fused is None:
        return x.blocks[0].is_cuda
    return bool(use_fused)


def sharded_features8(
    image: ShardedVolume,
    mask: ShardedVolume,
    sigma: float,
    mesh: BlockMesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
    use_fused=None,
    stack: bool = True,
):
    """features8 over a block-sharded volume. Returns a ShardedVolume of
    (x, y, Z, 8) blocks (stack=True), or a tuple of 8 ShardedVolumes of
    (x, y, Z) blocks (stack=False — no channel-last copy; preferred when
    consumers read channels independently, e.g. the histogram pipelines)."""
    spacing = tuple(float(v) for v in spacing)
    fused = _resolve_use_fused(use_fused, image)
    fits, radii = (_sweep_block_plan(mesh, sigma, spacing, truncate)
                   if fused else (False, None))
    if fits:
        per_block = _features8_block_sweep(image, mask, float(sigma), spacing,
                                           float(truncate), radii)
    else:
        per_block = _features8_block(image, mask, float(sigma), spacing,
                                     float(truncate), fused)
    if stack:
        return ShardedVolume(mesh, [torch.stack(f, dim=-1) for f in per_block])
    return tuple(ShardedVolume(mesh, [f[k] for f in per_block])
                 for k in range(8))


def sharded_hessian_eig(
    image: ShardedVolume,
    mesh: BlockMesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    use_fused=None,
    stack: bool = True,
):
    """Hessian -> 6 eigen features of a sharded raw volume. Returns a
    ShardedVolume of (x, y, Z, 6) blocks when stack, else a tuple of 6
    ShardedVolumes.

    The kernel route reads a 1D mesh's neighbour rows as x_halo (no extended
    block) and runs pre_padded on a 2D mesh's halo-extended blocks, writing
    the core alone."""
    spacing = tuple(float(v) for v in spacing)
    cut = _cut_axes(mesh)
    if _resolve_use_fused(use_fused, image):
        if set(cut) <= {0}:
            if 0 in cut:
                los, his = halo_slabs(image, 0, 1)
                halos = list(zip(los, his))
            else:
                halos = [None] * len(image.blocks)  # the kernel's own clamp
            per_block = [fused_hessian_eig_stream(b, spacing, stack=False,
                                                  x_halo=h)
                         for b, h in zip(image.blocks, halos)]
        else:
            ext = _halo_or_edge_pad(image)
            per_block = [fused_hessian_eig_stream(b.contiguous(), spacing,
                                                  stack=False, pre_padded=True)
                         for b in ext.blocks]
    else:
        per_block = [tuple(eigenvalue_features(H).unbind(-1))
                     for _, H in _grad_hessian_block(image, spacing)]
    if stack:
        return ShardedVolume(mesh, [torch.stack(f, dim=-1) for f in per_block])
    return tuple(ShardedVolume(mesh, [f[k] for f in per_block])
                 for k in range(6))


def features8_sharded_auto(
    image,
    mask,
    sigma: float,
    mesh: BlockMesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> torch.Tensor:
    """sharded_features8 for arbitrary volume sizes, from whole arrays (numpy
    or tensors): edge-pads to the mesh grid (see pad_to_mesh), runs the
    sharded op, gathers and crops back. Returns the whole (X, Y, Z, 8)
    tensor on mesh.device, on every process."""
    img_p, orig = pad_to_mesh(image, mesh)
    msk_p, _ = pad_to_mesh(mask, mesh)
    out = sharded_features8(shard_volume(img_p, mesh),
                            shard_volume(msk_p, mesh), sigma, mesh, spacing,
                            truncate)
    return crop_from_mesh(gather_volume(out), orig)


def features8_sharded_channels_to(
    image,
    mask,
    sigma: float,
    mesh: BlockMesh,
    consume,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
    dst: int = 0,
) -> None:
    """sharded_features8 for arbitrary volume sizes, from whole arrays (numpy
    or tensors), ending on ONE process a channel at a time: each of the 8
    channels is gathered to process `dst` only (gather_volume_to), cropped
    back, and handed to consume(k, channel) there; the next is gathered once
    consume has returned and the channel is dropped, so `dst` holds at most
    one gathered (X, Y, Z) channel and the other processes none. Every
    process of the mesh calls it (the exchanges and gathers are
    collective); consume runs on `dst` alone."""
    img_p, orig = pad_to_mesh(image, mesh)
    msk_p, _ = pad_to_mesh(mask, mesh)
    chans = sharded_features8(shard_volume(img_p, mesh),
                              shard_volume(msk_p, mesh), sigma, mesh,
                              spacing, truncate, stack=False)
    for k, c in enumerate(chans):
        whole = gather_volume_to(c, dst)
        if whole is not None:
            consume(k, crop_from_mesh(whole, orig))
        del whole


def sharded_multiscale_features(
    image: ShardedVolume,
    mask: ShardedVolume,
    sigmas: Sequence[float],
    mesh: BlockMesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> ShardedVolume:
    """Stacked scales, blocks of (x, y, Z, n_scales, 8), computed on-mesh."""
    per = [sharded_features8(image, mask, float(s), mesh, spacing, truncate)
           for s in sigmas]
    return ShardedVolume(mesh, [torch.stack(bs, dim=-2)
                                for bs in zip(*(p.blocks for p in per))])
