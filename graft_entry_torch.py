"""The port's counterpart of ife_tpu's `__graft_entry__.py`: the same two
functions on ife_tpu_torch, run on the card through its kernels.

entry(): the single-device features8 pass at sigma 1.0, spacing (0.78,
0.78, 1.0), on a 64^3 synthetic CT and a sphere mask: (fn, (image, mask)),
where fn(image, mask) is the (64, 64, 64, 8) feature volume. fn takes the
kernel route (ops.features.fused_features8): at this scale it dispatches to
the features8_sweep kernel on a CUDA tensor, and to that kernel's plain twin
on a CPU tensor.

dryrun_multichip(n): the whole sharded step on an n-block mesh (2D when n >
1): multi-scale features at sigma (0.8, 1.6) and the all-reduced histogram of
the first scale's smoothed channel, on a (4 mx, 4 my, 16) volume; it
asserts the shape and that the counts sum to the mask's voxels. On one card
the n blocks live in one process; under torch.distributed, make_mesh deals
them to the ranks. dryrun_step(n) is the step itself and returns what it
computed.

Both pick their device with parallel.mesh.default_device: the card, or the
CPU only when IFE_PLATFORM=cpu asks for it; a host without a card raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ife_tpu_torch.core.volume import sphere_mask, synthetic_ct
from ife_tpu_torch.ops.features import fused_features8
from ife_tpu_torch.parallel import (
    default_device,
    gather_volume,
    make_mesh,
    mesh_dims,
    shard_volume,
    sharded_masked_histogram,
    sharded_multiscale_features,
)

ENTRY_SHAPE = (64, 64, 64)
ENTRY_SIGMA = 1.0
ENTRY_SPACING = (0.78, 0.78, 1.0)
DRYRUN_SIGMAS = (0.8, 1.6)
DRYRUN_SPACING = (1.0, 1.0, 1.0)
# host data: the histogram wrappers refuse edges on a device
DRYRUN_EDGES = np.linspace(-900.0, -100.0, 5).astype(np.float32)


def entry():
    """(fn, (image, mask)): fn(image, mask) is features8 of the 64^3
    synthetic CT (seed 0) under a sphere mask (radius 0.4), (X, Y, Z, 8),
    through the kernels. The kernel writes one (8, X, Y, Z) tensor; fn
    returns it as an (X, Y, Z, 8) view, features8's shape, without a
    channel-last copy."""
    device = default_device()
    img = synthetic_ct(ENTRY_SHAPE, seed=0, device=device).data
    mask = sphere_mask(ENTRY_SHAPE, 0.4, device=device).data

    def fn(image, mask):
        return fused_features8(image, mask, ENTRY_SIGMA, ENTRY_SPACING,
                               stack=True).permute(1, 2, 3, 0)

    return fn, (img, mask)


def dryrun_step(n_blocks: int, device=None):
    """One sharded step on an n_blocks mesh: (features, counts, dims) — the
    gathered (X, Y, Z, 2, 8) features at DRYRUN_SIGMAS, the (6,) int32
    counts of the first scale's smoothed channel inside the mask over
    DRYRUN_EDGES, and the mesh's block grid."""
    axes = ("x", "y") if n_blocks > 1 else ("x",)
    mesh = make_mesh(n_blocks, axes, device=device)
    mx, my = mesh_dims(mesh)
    shape = (4 * mx, 4 * my, 16)
    img = shard_volume(synthetic_ct(shape, seed=1, device=mesh.device).data,
                       mesh)
    mask = shard_volume(sphere_mask(shape, 0.45, device=mesh.device).data,
                        mesh)
    feats = sharded_multiscale_features(img, mask, DRYRUN_SIGMAS, mesh,
                                        spacing=DRYRUN_SPACING)
    counts = sharded_masked_histogram(feats.map(lambda b: b[..., 0, 0]),
                                      mask, DRYRUN_EDGES, mesh)
    return gather_volume(feats), counts, mesh.dims


def dryrun_multichip(n_devices: int) -> None:
    """dryrun_step(n_devices), checked: the features' shape and counts that
    sum to the mask's voxels."""
    feats, counts, dims = dryrun_step(n_devices)
    mx, my = dims[0], (dims[1] if len(dims) > 1 else 1)
    shape = (4 * mx, 4 * my, 16)
    assert tuple(feats.shape) == shape + (2, 8), feats.shape
    inside = int((sphere_mask(shape, 0.45).data != 0).sum())
    assert int(counts.sum()) == inside, (int(counts.sum()), inside)
