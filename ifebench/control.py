"""The controls of the checks: the reference put in the program's place,
computed one precision below the configuration's float32 (the FIR
products in TF32, as a tensor-core convolution with TF32 on would take
them; the configuration keeps TF32 off). Each control entry has the
interface of the entry it replaces; a run with it has to come out not
correct. calibrate.py reads them at the cells' own size, and the tests at a
small one."""
from __future__ import annotations

import torch

from ifebench import reference
from ifebench.checks.bag import reference_bag


class Features8Control:
    """features8_scan's place: the 8 float32 channels of every scale."""

    def __init__(self, run):
        self.run = run

    def scan(self, slot, keep):
        image, mask = self.run.scan_tensors(slot)
        kept = []
        for sigma in self.run.sigmas:
            f = reference.features_region(image, mask, sigma, self.run.spacing,
                                          self.run.truncate,
                                          dtype=torch.float32, tf32=True)
            if keep:
                kept.append(tuple(f.unbind(0)))
            del f
        return kept if keep else None


class BagControl:
    """make_bag_device's place: the bag of float32 TF32 features."""

    def __init__(self, run):
        self.run = run

    def scan(self, slot, keep):
        return reference_bag(self.run, slot, torch.float32, tf32=True)


CONTROLS = {"features8": Features8Control, "bag": BagControl}
