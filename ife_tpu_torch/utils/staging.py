"""Host arrays to the card through a ring of page-locked buffers.

A pageable copy (`torch.from_numpy(a).to("cuda")`) runs at the pace of the
CUDA runtime's own staging: one thread fills a small pinned bounce buffer
and waits for each transfer. `to_device` sends a C-contiguous array through
RING_SLOTS page-locked buffers of SLOT_BYTES each, allocated at the first
CUDA call and kept for the life of the process. For each chunk it waits on
the slot's event from its last use, fills the slot with ATen's threaded CPU
copy, enqueues the slot's transfer on the current stream and records the
slot's event; so the host fills the next slot while the card takes this
one, and work enqueued after the call on the same stream runs after the
copies without a synchronisation. The caller's array is read only inside
the call: nothing keyed to it outlives the call.

An array crosses once, in the narrower of its dtype and the wanted one:
a narrower wanted dtype is cast on the host while the slot fills, a
narrower source on the device after the copy (the same IEEE conversion on
either side). On the CPU an array is taken as it is (no copy where the
dtype agrees); on the card an array that is not C-contiguous takes the
pageable copy, and `ring_nbytes` counts it out.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

# On an NVIDIA H100's 8-core host, 3 slots of 16 MiB staged a 512 x 512 x 400
# f32 scan and its uint8 mask fastest of 2-8 slots of 8-64 MiB, in turns
RING_SLOTS = 3
SLOT_BYTES = 16 << 20


def chunk_plan(total: int, size: int) -> List[Tuple[int, int]]:
    """(offset, length) pairs that cover range(total) once, in order, each
    at most `size` long."""
    return [(off, min(size, total - off)) for off in range(0, total, size)]


def staged_nbytes(arr: np.ndarray,
                  dtype: Optional[torch.dtype] = None) -> int:
    """The bytes of `arr` that cross to the device when it is wanted as
    `dtype` (None: its own dtype)."""
    if dtype is None:
        return arr.nbytes
    return arr.size * min(arr.itemsize, dtype.itemsize)


def _uses_ring(arr: np.ndarray, device) -> bool:
    return (torch.device(device).type == "cuda" and arr.size > 0
            and arr.flags.c_contiguous)


def ring_nbytes(arr: np.ndarray, device,
                dtype: Optional[torch.dtype] = None) -> int:
    """Of staged_nbytes, the bytes that to_device sends through the ring."""
    return staged_nbytes(arr, dtype) if _uses_ring(arr, device) else 0


def to_device(arr: np.ndarray, device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`arr` on `device` as `dtype` (None: its own dtype)."""
    device = torch.device(device)
    if not _uses_ring(arr, device):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=device, dtype=dtype or t.dtype)
    src = torch.from_numpy(arr).reshape(-1)
    want = dtype or src.dtype
    wire = want if want.itemsize < src.dtype.itemsize else src.dtype
    out = torch.empty(src.numel(), dtype=wire, device=device)
    _ring.copy(out, src)
    return out.view(arr.shape).to(want)


class _Ring:
    """`slots` page-locked buffers of `slot_bytes`, allocated at the first
    copy, and the event of each one's last copy to the card."""

    def __init__(self, slots: int = RING_SLOTS, slot_bytes: int = SLOT_BYTES):
        self.slot_bytes = slot_bytes
        self.bufs: list = []
        self.events: list = [None] * slots
        self.next = 0
        self.lock = threading.Lock()

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """dst (1-D, on the card) = src (1-D, on the host), slot by slot."""
        stream = torch.cuda.current_stream(dst.device)
        with self.lock:
            if not self.bufs:
                self.bufs = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                         pin_memory=True)
                             for _ in self.events]
            per = self.slot_bytes // dst.element_size()
            for off, n in chunk_plan(src.numel(), per):
                k, self.next = self.next, (self.next + 1) % len(self.bufs)
                if self.events[k] is not None:
                    self.events[k].synchronize()
                buf = self.bufs[k].view(dst.dtype)[:n]
                buf.copy_(src[off:off + n])
                dst[off:off + n].copy_(buf, non_blocking=True)
                self.events[k] = torch.cuda.Event()
                self.events[k].record(stream)


_ring = _Ring()
