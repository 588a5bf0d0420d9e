"""Block meshes and volume sharding (counterpart of ife_tpu/parallel/mesh.py).

Volumes are (X, Y, Z) tensors; the leading spatial axes are cut into a 1D
("x",) or 2D ("x", "y") grid of equal blocks. Z, the contiguous axis of
every kernel, is never cut.

Where ife_tpu lays a jax Mesh over devices and lets shard_map run one
program per device, the port has a mesh of BLOCKS. Each process owns a
contiguous run of them on its own device and loops over them; blocks of one
process exchange halos by slicing, blocks of different processes through
torch.distributed (parallel/halo.py). One process that owns every block on
one card is the counterpart of ife_tpu's single-controller run; one block per
process is its multi-host run.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def default_device(device=None) -> torch.device:
    """This process's compute device: `device` when the caller names one;
    else the CPU only when IFE_PLATFORM=cpu asks for it, otherwise the card
    of its rank (rank modulo the cards of the host). A host without a card
    raises: nothing moves to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if os.environ.get("IFE_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ife_tpu_torch: no CUDA device is available "
            "(torch.cuda.is_available() is false). Set IFE_PLATFORM=cpu, or "
            "pass device=\"cpu\", to run on the CPU on purpose.")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(frozen=True)
class BlockMesh:
    """A grid of `dims` blocks over volume axes 0 (and 1). Block b, in
    row-major order of its grid coordinates, belongs to process
    b // (n_blocks // world_size), which keeps it on `device`."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int = 0
    world_size: int = 1

    @property
    def n_blocks(self) -> int:
        return int(np.prod(self.dims))

    def coords(self, b: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(b, self.dims))

    def index(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.dims))

    def owner(self, b: int) -> int:
        return b // (self.n_blocks // self.world_size)

    @property
    def local_blocks(self) -> List[int]:
        return [b for b in range(self.n_blocks) if self.owner(b) == self.rank]


def make_mesh(
    n_blocks: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("x",),
    device=None,
) -> BlockMesh:
    """A 1D ("x") or 2D ("x", "y") block mesh of `n_blocks` blocks (default:
    one per process). For 2D the count is factored as close to square as
    possible (a square decomposition has the least halo surface), the larger
    factor on x, as ife_tpu factors its devices. The blocks are dealt to the
    processes of torch.distributed when it is initialized, else all to this
    one; `device` defaults to default_device(), which raises on a host
    without a card unless IFE_PLATFORM=cpu."""
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    if n_blocks is None:
        n_blocks = world
    n_blocks = int(n_blocks)
    if n_blocks < 1 or n_blocks % world:
        raise ValueError(f"{n_blocks} blocks cannot be dealt evenly to "
                         f"{world} processes")
    if len(axis_names) == 1:
        dims: Tuple[int, ...] = (n_blocks,)
    elif len(axis_names) == 2:
        a = int(np.floor(np.sqrt(n_blocks)))
        while n_blocks % a:
            a -= 1
        dims = (n_blocks // a, a)
    else:
        raise ValueError("mesh must be 1D ('x',) or 2D ('x','y')")
    return BlockMesh(dims, tuple(axis_names), default_device(device), rank,
                     world)


def mesh_dims(mesh: BlockMesh) -> Tuple[int, int]:
    """(mx, my): block-grid extents along volume axes 0 and 1."""
    return mesh.dims[0], (mesh.dims[1] if len(mesh.dims) > 1 else 1)


@dataclass
class ShardedVolume:
    """This process's blocks of a block-sharded array: blocks[i] is block
    mesh.local_blocks[i], every block of one shape (leading axes the block's
    x, y extent; trailing axes whole)."""

    mesh: BlockMesh
    blocks: List[torch.Tensor]

    def map(self, fn) -> "ShardedVolume":
        return ShardedVolume(self.mesh, [fn(b) for b in self.blocks])

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape."""
        mx, my = mesh_dims(self.mesh)
        b = self.blocks[0].shape
        return (b[0] * mx, b[1] * my) + tuple(b[2:])


def _block_slices(mesh: BlockMesh, b: int, shape):
    mx, my = mesh_dims(mesh)
    c = mesh.coords(b)
    i, j = c[0], (c[1] if len(c) > 1 else 0)
    bx, by = shape[0] // mx, shape[1] // my
    return slice(i * bx, (i + 1) * bx), slice(j * by, (j + 1) * by)


def shard_volume(data, mesh: BlockMesh) -> ShardedVolume:
    """Cut a whole array (numpy or tensor, on any device; every process
    holds the same one) into the mesh's blocks and keep this process's, as
    contiguous tensors on mesh.device.

    Requires each cut axis to divide by its mesh extent — use pad_to_mesh /
    crop_from_mesh for arbitrary sizes."""
    t = torch.from_numpy(np.ascontiguousarray(data)) if isinstance(
        data, np.ndarray) else data
    mx, my = mesh_dims(mesh)
    if t.shape[0] % mx or t.shape[1] % my:
        raise ValueError(f"shape {tuple(t.shape)} does not divide by the "
                         f"mesh grid {(mx, my)}: pad_to_mesh first")
    # .contiguous() of a slice that is the whole array would alias the
    # caller's tensor; a block is always its own copy
    return ShardedVolume(mesh, [
        t[_block_slices(mesh, b, t.shape)].to(mesh.device, copy=True)
        .contiguous() for b in mesh.local_blocks])


def gather_volume(sv: ShardedVolume) -> torch.Tensor:
    """The whole array on mesh.device, on EVERY process: this process's
    blocks written into place and, across processes, an all_gather of the
    others'."""
    mesh = sv.mesh
    shape = sv.shape
    out = torch.empty(shape, dtype=sv.dtype, device=mesh.device)
    if mesh.world_size == 1:
        owned = {b: t for b, t in zip(mesh.local_blocks, sv.blocks)}
    else:
        mine = torch.stack([b.contiguous() for b in sv.blocks])
        parts = [torch.empty_like(mine) for _ in range(mesh.world_size)]
        dist.all_gather(parts, mine)
        per = mesh.n_blocks // mesh.world_size
        owned = {r * per + i: parts[r][i]
                 for r in range(mesh.world_size) for i in range(per)}
    for b, t in owned.items():
        out[_block_slices(mesh, b, shape)] = t
    return out


def gather_volume_to(sv: ShardedVolume, dst: int = 0):
    """The whole array on mesh.device of process `dst` only, None on every
    other process: the other processes send their blocks to `dst`
    (torch.distributed send / recv), one process's blocks in flight at a
    time, each written into place as it arrives. Beside the whole array,
    `dst` holds at most one process's blocks of it."""
    mesh = sv.mesh
    if mesh.world_size == 1:
        return gather_volume(sv)
    mine = torch.stack([b.contiguous() for b in sv.blocks])
    if mesh.rank != dst:
        dist.send(mine, dst)
        return None
    shape = sv.shape
    out = torch.empty(shape, dtype=sv.dtype, device=mesh.device)
    per = mesh.n_blocks // mesh.world_size
    for r in range(mesh.world_size):
        if r == dst:
            part = mine
        else:
            part = torch.empty_like(mine)
            dist.recv(part, r)
        for i in range(per):
            out[_block_slices(mesh, r * per + i, shape)] = part[i]
        del part
    return out


def pad_to_mesh(data, mesh: BlockMesh, mode: str = "edge"):
    """Edge-pad the leading spatial dims up to multiples of the mesh grid.

    Edge replication composes with the ops' ZeroFluxNeumann boundary (every
    out-of-volume access clamps to the edge voxel either way), so
    compute-then-crop_from_mesh matches the unpadded result wherever
    ife_tpu's does. mode="constant" pads with zeros (a counting mask).
    Returns (padded array of the input's kind, original_shape).
    """
    mx, my = mesh_dims(mesh)
    shape = tuple(data.shape)
    px = (-shape[0]) % mx
    py = (-shape[1]) % my
    if px == 0 and py == 0:
        return data, shape
    if isinstance(data, np.ndarray):
        pad = [(0, px), (0, py)] + [(0, 0)] * (len(shape) - 2)
        return np.pad(data, pad, mode=mode), shape
    if mode == "edge":
        ix = torch.arange(shape[0] + px, device=data.device).clamp_(max=shape[0] - 1)
        iy = torch.arange(shape[1] + py, device=data.device).clamp_(max=shape[1] - 1)
        return data.index_select(0, ix).index_select(1, iy), shape
    out = data.new_zeros((shape[0] + px, shape[1] + py) + shape[2:])
    out[: shape[0], : shape[1]] = data
    return out, shape


def crop_from_mesh(data, original_shape):
    """Undo pad_to_mesh on a result (leading dims only)."""
    return data[: original_shape[0], : original_shape[1]]
