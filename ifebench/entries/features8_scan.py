"""Entry: one scan's feature pass at every scale of the configuration, on a
scan already on the card, as ``extract-features`` (and the device stage of
``make-bag`` and ``determine-bin-edges``) runs it:
``ife_tpu_torch.ops.features.features8_auto_channels(img, msk, sigma,
spacing)`` for each sigma. The 8 channels of a scale stay on the card until
the next scale; the scan ends with ``torch.cuda.synchronize()``. A kept
scan returns [scale][channel] tensors, any other scan None."""
from __future__ import annotations

import torch

from ife_tpu_torch.ops.features import features8_auto_channels

CHECK_OUTPUT = "features8"


class Entry:
    def __init__(self, run):
        self.run = run
        self.spacing = tuple(run.spacing)

    def scan(self, slot: int, keep: bool):
        image, mask = self.run.scan_tensors(slot)
        kept = []
        chans = None
        for sigma in self.run.sigmas:
            chans = features8_auto_channels(image, mask, float(sigma),
                                            self.spacing, self.run.truncate)
            if keep:
                kept.append(chans)
        del chans
        if image.is_cuda:
            torch.cuda.synchronize(image.device)
        return kept if keep else None
