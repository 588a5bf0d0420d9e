"""Entry: one scan through ``make-bag --device``:
``ife_tpu_torch.roi.bag.make_bag_device(image, mask, sigmas, edges, rois,
spacing)`` on host numpy arrays (f32 image, uint8 mask), the bag of the
scan's ROIs back on the host as an (n_rois, bins * 8 * n_scales) array."""
from __future__ import annotations

from ife_tpu_torch.roi.bag import make_bag_device
from ife_tpu_torch.roi.generate import ROI

CHECK_OUTPUT = "bag"


class Entry:
    def __init__(self, run):
        self.run = run
        size = tuple(int(s) for s in run.roi_size)
        self.rois = {slot: [ROI(tuple(int(v) for v in st), size)
                            for st in starts]
                     for slot, starts in run.rois.items()}

    def scan(self, slot: int, keep: bool):
        image, mask = self.run.host_pool[slot]
        return make_bag_device(image, mask, self.run.sigmas, self.run.edges,
                               self.rois[slot], tuple(self.run.spacing),
                               device=self.run.device)
