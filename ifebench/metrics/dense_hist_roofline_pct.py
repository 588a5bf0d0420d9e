"""dense_hist_roofline_pct (device trace): the least time the card could
take for the traced scans' dense binning, as a share of the device time of
the dense kernels in the traced window (the profiler's kernel records whose
name holds KERNEL). None where the trace holds no such kernel.

The least time of one scale of one scan is the larger of two terms
(floor_ms), counted from the work the pass must do whatever implements it:
  * bytes / 3.35 TB/s: the 8 f32 channels and the 1 B mask read once over
    the region that holds every box, and N rows of 8 x bins f32 written;
  * operations / 67 TFLOP/s (the H100 SXM's float32 peak outside the
    tensor cores): a divide a frequency (N x 8 x bins) and a binary search
    a channel voxel of the region (ceil(log2(bins)) compares).
N and the region are the benchmark's own (`dense_work`): every voxel of
the traced slot's mask whose box lies inside the volume, and the box that
holds those boxes. At 32 bins the bytes term bounds it."""
import math

import torch

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
KERNEL = "dense_hist"
CHANNELS = 8
CHANNEL_BYTES = 4
MASK_BYTES = 1
ROW_BYTES = 4


def dense_work(mask: torch.Tensor, size):
    """(N, region voxels) of the dense ROIs of `mask`."""
    size = [int(s) for s in size]
    shape = list(mask.shape)
    if any(n < s for n, s in zip(shape, size)):
        return 0, 0
    inside = tuple(slice(s // 2, n - s + s // 2 + 1)
                   for n, s in zip(shape, size))
    centres = mask[inside] != 0
    n = int(centres.sum())
    if n == 0:
        return 0, 0
    region = 1
    for a in range(3):
        hit = torch.nonzero(centres.any(dim=tuple(d for d in range(3)
                                                  if d != a)))[:, 0]
        region *= int(hit[-1]) - int(hit[0]) + size[a]
    return n, region


def floor_ms(n, region, bins, channels=CHANNELS):
    bytes_ = (region * (channels * CHANNEL_BYTES + MASK_BYTES)
              + n * channels * bins * ROW_BYTES)
    flop = n * channels * bins + region * channels * math.ceil(math.log2(bins))
    return max(bytes_ / PEAK_BYTES_S, flop / PEAK_FLOP_S) * 1e3


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    busy_s = t.device_seconds(lambda name, cat: cat == "kernel"
                              and KERNEL in name)
    if busy_s <= 0:
        return None
    run = ctx.run
    work = {}
    least = 0.0
    for slot in ctx.traced_slots:
        if slot not in work:
            work[slot] = dense_work(run.scan_tensors(slot)[1], run.roi_size)
        least += len(run.sigmas) * floor_ms(*work[slot], run.bins)
    return 100.0 * least * 1e-3 / busy_s
