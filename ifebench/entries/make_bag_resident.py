"""Entry: one scan through ``make-bag --device`` on a scan already on the
card, with ROIs tiling the lungs:
``ife_tpu_torch.roi.bag.make_bag_device(image, mask, sigmas, edges, rois,
spacing)`` on the pool's tensors (f32 image, uint8 mask), the bag of the
scan's ROIs back on the host as an (n_rois, bins * 8 * n_scales) array.

The ROIs (`tiling`) are boxes of the configuration's size centred on a grid
of half the box (20 voxels for 41^3) in each axis, anchored at the low
corner of the mask's bounding box, at every grid point in the mask whose box
lies inside the volume: whole lungs tiled into overlapping instances for
MIL training. They replace the harness's random draw in ``run.rois``, so
checks/bag.py checks exactly these ROIs."""
from __future__ import annotations

import numpy as np
import torch

from ife_tpu_torch.roi.bag import make_bag_device
from ife_tpu_torch.roi.generate import ROI

CHECK_OUTPUT = "bag"


def tiling(mask: torch.Tensor, size) -> np.ndarray:
    """(n, 3) int64 start corners (centre - size // 2) of the tiling of
    `mask`, ordered z, then y, then x fastest."""
    size = [int(s) for s in size]
    m = mask != 0
    if not bool(m.any()):
        return np.zeros((0, 3), np.int64)
    lo = [int(torch.nonzero(m.any(dim=tuple(d for d in range(3) if d != a)))
              [0, 0]) for a in range(3)]
    stride = [max(1, s // 2) for s in size]
    grid = m[tuple(slice(a, None, st) for a, st in zip(lo, stride))]
    zyx = grid.permute(2, 1, 0).nonzero().cpu().numpy()
    centres = np.asarray(lo) + zyx[:, ::-1] * np.asarray(stride)
    starts = centres - np.asarray(size) // 2
    fits = ((starts >= 0) & (starts + size <= np.asarray(m.shape))).all(axis=1)
    return starts[fits].astype(np.int64)


class Entry:
    def __init__(self, run):
        self.run = run
        size = tuple(int(s) for s in run.roi_size)
        for slot in range(run.pool_size):
            run.rois[slot] = tiling(run.scan_tensors(slot)[1], size)
        self.rois = {slot: [ROI(tuple(int(v) for v in st), size)
                            for st in starts]
                     for slot, starts in run.rois.items()}

    def scan(self, slot: int, keep: bool):
        image, mask = self.run.scan_tensors(slot)
        return make_bag_device(image, mask, self.run.sigmas, self.run.edges,
                               self.rois[slot], tuple(self.run.spacing),
                               device=self.run.device)
