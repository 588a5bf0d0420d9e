"""Entry: one lung of a scan through ``make-bag-dense`` on the card:
``ife_tpu_torch.roi.bag.make_bag_dense_device(image, mask, sigmas, edges,
roi_size, spacing)`` on the pool's tensors, an ROI at every voxel of the
lung, its rows left on the card. The lung is the one at x < X / 2: the
entry clears the x >= X / 2 half of every pool mask once, before any scan.

A kept scan returns (N, sel, starts[sel], rows[sel]) on the host, sel being
the sorted indices of SAMPLE_ROWS rows drawn from (seed, slot) after the
call (`sample_rows`): the program never learns which rows are read. Any
other scan returns None once its rows are made."""
from __future__ import annotations

import numpy as np
import torch

from ife_tpu_torch.roi.bag import make_bag_dense_device

CHECK_OUTPUT = "bag_dense"
SAMPLE_ROWS = 1024


def sample_rows(seed: int, slot: int, n: int) -> np.ndarray:
    """Sorted indices of min(SAMPLE_ROWS, n) of n rows, drawn from
    (seed, slot)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(slot),
                                                        22]))
    return np.sort(rng.choice(n, size=min(SAMPLE_ROWS, n), replace=False))


class Entry:
    def __init__(self, run):
        self.run = run
        self.size = tuple(int(s) for s in run.roi_size)
        for slot in range(run.pool_size):
            mask = run.scan_tensors(slot)[1]
            mask[mask.shape[0] // 2:] = 0

    def scan(self, slot: int, keep: bool):
        image, mask = self.run.scan_tensors(slot)
        starts, rows = make_bag_dense_device(
            image, mask, self.run.sigmas, self.run.edges, self.size,
            tuple(self.run.spacing), device=self.run.device)
        if not keep:
            if rows.is_cuda:
                torch.cuda.synchronize(rows.device)
            return None
        n = int(starts.shape[0])
        sel = sample_rows(self.run.seed, slot, n)
        at = torch.from_numpy(sel).to(rows.device)
        return n, sel, starts[at].cpu().numpy(), rows[at].cpu().numpy()
