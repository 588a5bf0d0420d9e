"""Halo exchange: the stencil-parallel primitive (counterpart of
ife_tpu/parallel/halo.py).

A block needs `h` neighbour planes along each cut axis before a radius-`h`
stencil can produce its kept region. Interior block faces receive the
neighbouring blocks' planes; true volume faces replicate the boundary plane —
ITK's ZeroFluxNeumann condition — so a sharded stencil computes what the
single-device ops of ife_tpu_torch.ops.stencil compute.

Where ife_tpu permutes slabs between devices with lax.ppermute, the planes
of a block this process owns are a slice, and the planes of another
process's block arrive through torch.distributed point-to-point (NCCL for
CUDA blocks, gloo for CPU blocks). Every process walks the same plan in the
same order, so sends and receives pair up without tags.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from ife_tpu_torch.parallel.mesh import BlockMesh, ShardedVolume


def _slab(x: torch.Tensor, axis: int, start: int, size: int) -> torch.Tensor:
    return x.narrow(axis, start, size)


def _edge(x: torch.Tensor, axis: int, h: int, lo: bool) -> torch.Tensor:
    """h replicated copies of the boundary plane (ZeroFluxNeumann)."""
    plane = _slab(x, axis, 0 if lo else x.shape[axis] - 1, 1)
    return plane.expand(*[h if d == axis else -1 for d in range(x.dim())])


def halo_pad(x: torch.Tensor, axis: int, h: int) -> torch.Tensor:
    """A block with no neighbour on `axis`: pure edge replication."""
    return torch.cat([_edge(x, axis, h, True), x, _edge(x, axis, h, False)],
                     dim=axis)


def _pieces(i: int, m: int, n_local: int, h: int, lo: bool):
    """The planes block i of m along an axis needs on one side: ([(j, start,
    size), ...] from the nearest block outwards, replicas), the pieces of the
    blocks j that hold them and the count of planes beyond the volume, which
    replicate the global edge plane. h > n_local reaches over several
    blocks (ife_tpu's multi-hop path)."""
    pieces, need = [], h
    j = i - 1 if lo else i + 1
    while need > 0 and 0 <= j < m:
        take = min(n_local, need)
        pieces.append((j, n_local - take if lo else 0, take))
        need -= take
        j += -1 if lo else 1
    return pieces, need


def halo_slabs(x: ShardedVolume, axis: int, h: int
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per local block, the (lo, hi) slabs of h planes beside it along
    `axis`, WITHOUT the concatenated extended block — for kernels that take
    halo rows as separate inputs. Interior faces: the neighbours' planes;
    true faces: edge replication, of the GLOBAL edge plane however many
    blocks away the face is."""
    mesh: BlockMesh = x.mesh
    m = mesh.dims[axis] if axis < len(mesh.dims) else 1
    local = dict(zip(mesh.local_blocks, x.blocks))
    n_local = x.blocks[0].shape[axis]

    def neighbour(b: int, j: int) -> int:
        c = list(mesh.coords(b))
        c[axis] = j
        return mesh.index(c)

    # the plan, identical on every process: (dst block, side, src block,
    # start, size), by destination block, lo before hi, nearest piece first
    plan = []
    for b in range(mesh.n_blocks):
        i = mesh.coords(b)[axis] if axis < len(mesh.dims) else 0
        for lo in (True, False):
            pieces, _ = _pieces(i, m, n_local, h, lo)
            plan += [(b, lo, neighbour(b, j), start, size)
                     for j, start, size in pieces]

    got, ops = {}, []
    for k, (dst, lo, src, start, size) in enumerate(plan):
        src_here, dst_here = src in local, dst in local
        if src_here and dst_here:
            got[k] = _slab(local[src], axis, start, size)
        elif src_here:
            ops.append(dist.P2POp(
                dist.isend, _slab(local[src], axis, start, size).contiguous(),
                mesh.owner(dst)))
        elif dst_here:
            shape = list(x.blocks[0].shape)
            shape[axis] = size
            got[k] = torch.empty(shape, dtype=x.dtype, device=mesh.device)
            ops.append(dist.P2POp(dist.irecv, got[k], mesh.owner(src)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    los, his = [], []
    for b in mesh.local_blocks:
        i = mesh.coords(b)[axis] if axis < len(mesh.dims) else 0
        for lo, dest in ((True, los), (False, his)):
            parts = [got[k] for k, p in enumerate(plan)
                     if p[0] == b and p[1] == lo]
            _, replicas = _pieces(i, m, n_local, h, lo)
            if replicas:
                # the farthest piece ends at the volume's face (else this
                # block itself does): its outer plane is the global edge
                parts.append(_edge(parts[-1] if parts else local[b], axis,
                                   replicas, lo))
            dest.append(torch.cat(parts[::-1] if lo else parts, dim=axis))
    return los, his


def halo_exchange(x: ShardedVolume, axis: int, h: int) -> ShardedVolume:
    """Extend every block by h planes per side along `axis`: neighbours'
    planes inside the volume, edge replication at its faces."""
    if h <= 0:
        return x
    los, his = halo_slabs(x, axis, h)
    return ShardedVolume(x.mesh, [
        torch.cat([lo, b, hi], dim=axis)
        for lo, b, hi in zip(los, x.blocks, his)])
