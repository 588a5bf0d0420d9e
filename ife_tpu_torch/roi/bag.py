"""Bag-of-features assembly — MakeBag / MakeBagOnlyIntensity / SampleROIs /
ExtractLabels semantics (counterpart of ife_tpu/roi/bag.py).

Reference (tools/MakeBag.cxx:405-486): per scale, run the 8-channel feature
pass; per ROI, bin the masked voxels of each channel into histogram
histIdx = scale*8 + feature; write frequencies into bag row j at column
offset histIdx * histSize.

Two forms, as in ife_tpu:
  * make_bag bins on the host from feature volumes computed on the device:
    each ROI's masked f32 voxels, all 8 channels in one threaded call of the
    native library (numpy searchsorted/bincount for other dtypes);
  * make_bag_device bins on the device: one histogram_boxes call per scale
    and ROI size class, which on the card is one launch of the histogram
    kernel for every ROI of the class, its frequencies written into a bag
    on the device; the bag returns to the host once, at the end of the
    call.

make_bag_dense_device is MakeBagDense's dense bag on the device: an ROI at
every foreground voxel, binned by kernels/dense_hist.py's running box sums,
its rows left on the device.

The device forms take the scan as host arrays, staged through
utils/staging.py's ring, or as tensors already on the target device, used
in place.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ife_tpu_torch.kernels.dense_hist import dense_hist_rows, dense_index
from ife_tpu_torch.kernels.histogram import histogram_boxes
from ife_tpu_torch.native_lib import histogram_channels_native
from ife_tpu_torch.ops.features import (
    NUM_FEATURES, clamp_mask, features8_auto_channels,
)
from ife_tpu_torch.parallel.mesh import default_device
from ife_tpu_torch.roi.generate import ROI
from ife_tpu_torch.utils import staging
from ife_tpu_torch.utils.profiling import span


def _check_hist_spec(hist_edges: Sequence[np.ndarray], n_expected: int) -> int:
    if len(hist_edges) != n_expected:
        raise ValueError(
            f"Number of histograms must match number of features times number "
            f"of scales: got {len(hist_edges)}, expected {n_expected}"
        )
    sizes = {len(e) + 1 for e in hist_edges}
    if len(sizes) != 1:
        raise ValueError("Histograms must have the same bin count")
    return sizes.pop()


def _roi_frequencies(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Frequencies over len(edges)+1 bins, reference bin convention.
    Empty input -> nan row (reference divides counts by a zero total)."""
    idx = np.searchsorted(edges, values, side="left")
    counts = np.bincount(idx, minlength=edges.size + 1).astype(np.float64)
    total = counts.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        return counts / total


def _device_inputs(image, mask, dtype, device, keep_raw=False):
    """The image as `dtype` and the mask as ops/features.py:clamp_mask gives
    it, on `device`. Each crosses once, as the caller holds it (a bool or
    unsigned mask as the signed integer of its width), through
    utils/staging.py's ring of page-locked buffers on the card; the mask's
    clamp runs on the device. `keep_raw` appends the mask as it crossed.

    Spans: "bag.stage.h2d" (work: the bytes that cross) over
    "bag.stage.pinned" (work: those that go through the ring; 0 on the CPU
    and for an array that is not C-contiguous)."""
    image, mask = np.asarray(image), np.asarray(mask)
    kind = mask.dtype.kind
    if kind in "bu":
        mask = mask.view(f"i{mask.itemsize}")
    with span("bag.stage.h2d",
              work=staging.staged_nbytes(image, dtype) + mask.nbytes):
        with span("bag.stage.pinned",
                  work=staging.ring_nbytes(image, device, dtype)
                  + staging.ring_nbytes(mask, device)):
            img = staging.to_device(image, device, dtype)
            raw = staging.to_device(mask, device)
        msk = clamp_mask(raw, kind)
    return (img, msk, raw) if keep_raw else (img, msk)


def _on_device(t, device: torch.device) -> bool:
    return (isinstance(t, torch.Tensor) and t.device.type == device.type
            and (device.index is None or t.device.index == device.index))


def _scan_inputs(image, mask, dtype, device, keep_raw=False):
    """_device_inputs' result for a scan: from tensors on `device`, used in
    place (the image as `dtype`, the mask clamped on the device by
    clamp_mask: no host copy, no staging span); from anything else, host
    arrays staged by _device_inputs. A tensor on another device is refused
    rather than moved."""
    if _on_device(image, device) and _on_device(mask, device):
        mask = mask.contiguous()
        img = image.to(dtype).contiguous()
        msk = clamp_mask(mask)
        return (img, msk, mask) if keep_raw else (img, msk)
    for name, t in (("image", image), ("mask", mask)):
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            raise ValueError(f"{name} lies on {t.device}: pass both image and "
                             f"mask on {device}, or both as host arrays")
    return _device_inputs(image, mask, dtype, device, keep_raw)


def _edges_block(hist_edges, i) -> np.ndarray:
    """(8, E) f64 edges of scale i (scale-major: row i*8 + k)."""
    return np.stack([np.asarray(hist_edges[i * NUM_FEATURES + k], np.float64)
                     for k in range(NUM_FEATURES)])


def _scales(sigmas, hist_edges, hist_size: int):
    """Per scale i: its sigma, its (8, E) f64 edges as the caller gave them
    (the histogram kernels round them for f32 values) and the slice of the
    bag's columns it fills."""
    width = NUM_FEATURES * hist_size
    for i, sigma in enumerate(sigmas):
        yield (float(sigma), _edges_block(hist_edges, i),
               slice(i * width, (i + 1) * width))


def make_bag(
    image: np.ndarray,
    mask: np.ndarray,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    rois: Sequence[ROI],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=torch.float32,
    device=None,
) -> np.ndarray:
    """Bag matrix (n_rois, histSize * 8 * n_scales), binned on the host.

    hist_edges is ordered scale-major: index i*8+k is scale i, feature k
    (reference MakeBag.cxx:453). The feature pass runs on `device` (None: this
    process's card; the CPU only for device="cpu" or IFE_PLATFORM=cpu, and
    a host without a card raises).
    """
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    dev = default_device(device)
    img, msk = _device_inputs(image, mask, dtype, dev)
    bag = np.zeros((len(rois), hist_size * len(hist_edges)), dtype=np.float64)
    roi_masks = [(msk[r.slices()] != 0).cpu().numpy() for r in rois]

    for sigma, edges, cols in _scales(sigmas, hist_edges, hist_size):
        feats = [c.cpu().numpy() for c in features8_auto_channels(
            img, msk, sigma, tuple(spacing))]
        for j, r in enumerate(rois):
            inside = roi_masks[j]
            vox = [feats[k][r.slices()][inside] for k in range(NUM_FEATURES)]
            if feats[0].dtype == np.float32:
                # the MakeBag hot loop in the native library's threads: all
                # 8 channels in one call (masked features are finite: the
                # pass zeroes NaN / inf off the mask; a NaN inside would
                # land in bin 0 here and in the upper tail on numpy's path,
                # as in ife_tpu)
                counts = histogram_channels_native(np.stack(vox, axis=1),
                                                   edges)
                with np.errstate(divide="ignore", invalid="ignore"):
                    freqs = counts.astype(np.float64) / np.float64(len(vox[0]))
            else:
                freqs = np.stack([_roi_frequencies(vox[k], edges[k])
                                  for k in range(NUM_FEATURES)])
            bag[j, cols] = freqs.reshape(-1)
    return bag


def roi_feature_histograms_device(
    feats,
    mask: torch.Tensor,
    starts,
    edges,
    size: tuple,
) -> torch.Tensor:
    """Device-side MakeBag inner loop: per-ROI masked feature histograms of
    every ROI of one box `size`, in one histogram_boxes call (one kernel
    launch on the card).

    Args:
      feats: TUPLE of C (X, Y, Z) channel tensors, or one (X, Y, Z, C)
        volume.
      mask: (X, Y, Z) labels; nonzero = counted. A bool mask is taken as
        the weights as it is, so a caller that bins several times compares
        its mask with 0 once.
      starts: (N, 3) int ROI start corners.
      edges: (C, E) bin edges per channel, host data (histogram_boxes
        rounds f64 edges for f32 channels).
      size: ROI box (sx, sy, sz).

    Returns:
      (N, C, E+1) f32 frequencies: counts / masked voxels, divided in f32
      as ife_tpu does (nan if a box has no masked voxel, like the
      reference's divide-by-zero).
    """
    chans = (tuple(feats[..., k] for k in range(feats.shape[-1]))
             if getattr(feats, "ndim", None) == 4 else tuple(feats))
    chans = tuple(c.contiguous() for c in chans)
    weights = mask if mask.dtype == torch.bool else mask != 0
    counts = histogram_boxes(chans, weights, starts, size, edges)
    # every masked voxel lands in one bin of channel 0: its row sum is the
    # box's masked-voxel count, exact in f32 below 2^24 as ife_tpu's f32
    # sum of the 0/1 mask
    total = counts[:, :1].sum(dim=-1, keepdim=True, dtype=torch.int64)
    return counts.to(torch.float32) / total.to(torch.float32)


def _size_classes(rois: Sequence[ROI]):
    """ROI indices bucketed by box size: [(size, index_list), ...] in
    first-appearance order. The device path bins each class in one
    histogram_boxes call, so reference `.ROIInfo` files with heterogeneous
    boxes (tools/MakeBag.cxx:304-317 accepts per-ROI sizes) stay on the
    device."""
    classes: dict = {}
    for j, r in enumerate(rois):
        classes.setdefault(r.size, []).append(j)
    return list(classes.items())


def _bag_classes(rois: Sequence[ROI], device: torch.device):
    """_size_classes for a bag made on `device`: [(size, starts, rows)],
    starts the class's (n, 3) int64 corners on the host, rows its rows of
    the bag as an int64 tensor on `device` (every class's in one copy that
    does not wait for the card: from page-locked memory there)."""
    starts = np.asarray([r.index for r in rois], np.int64).reshape(-1, 3)
    classes = _size_classes(rois)
    rows = torch.from_numpy(np.asarray(
        [j for _, idxs in classes for j in idxs], np.int64))
    if device.type == "cuda":
        rows = rows.pin_memory()
    rows = rows.to(device, non_blocking=True)
    return [(size, starts[idxs], at) for (size, idxs), at in
            zip(classes, rows.split([len(idxs) for _, idxs in classes]))]


def _bin_into(bag, feats, weights, classes, edges, cols):
    """One scale's frequencies, each size class's written into its rows of
    the bag's columns `cols` on the device."""
    for size, starts, rows in classes:
        with span("bag.bin", device=bag.device, work=len(starts)):
            freqs = roi_feature_histograms_device(feats, weights, starts,
                                                  edges, size)
        bag[rows, cols] = freqs.reshape(len(starts), -1)


def _fetch_bag(bag: torch.Tensor) -> np.ndarray:
    """The f32 bag as the f64 host array callers get (the widening is
    exact): from the card one copy into page-locked memory, the call's one
    wait for the card, then the widening into a fresh array on the host's
    threads (on an NVIDIA H100's host the fastest, in turns, of this, the
    widening on the card before a pageable copy, and numpy's widening)."""
    host = bag
    if bag.is_cuda:
        host = torch.empty(bag.shape, dtype=bag.dtype, pin_memory=True)
        host.copy_(bag, non_blocking=True)
        torch.cuda.current_stream(bag.device).synchronize()
    return torch.empty(bag.shape, dtype=torch.float64).copy_(host).numpy()


def make_bag_device(
    image: np.ndarray,
    mask: np.ndarray,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    rois: Sequence[ROI],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=torch.float32,
    device=None,
) -> np.ndarray:
    """make_bag with the ROI histogramming on the device. Same
    (n_rois, histSize * 8 * n_scales) layout and bin semantics as
    make_bag; the frequencies are f32 (counts / masked voxels), as
    ife_tpu's make_bag_device gives them. Mixed ROI sizes run one
    histogram_boxes call per size class. `image` and `mask` may be tensors
    already on the target device (used in place, the same bag to the bit
    as from the same scan on the host) or host arrays.

    The bag is made on the device (n_rois x 4 KiB at 32 bins and 4 scales)
    and fetched once, after the last scale's binning is queued: the host
    waits for the card once a call, and does the per-ROI bookkeeping while
    the card takes the first scale's features.

    Spans (utils.profiling.span, recorded under torch.profiler): "bag",
    the call; "bag.stage", the inputs' staging (_device_inputs:
    "bag.stage.h2d" over "bag.stage.pinned"; for a scan on the device only
    the mask's clamp); per scale and size class "bag.bin", the binning;
    once a call "bag.fetch" (work: the ROIs), the host waiting for the
    bag. Only "bag.bin" records device events: the others are read on the
    host's clock."""
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    dev = default_device(device)
    ncols = hist_size * NUM_FEATURES * len(sigmas)
    with span("bag", work=len(rois)):
        with span("bag.stage"):
            img, msk = _scan_inputs(image, mask, dtype, dev)
        scales = _scales(sigmas, hist_edges, hist_size)
        sigma, edges, cols = next(scales)
        feats = features8_auto_channels(img, msk, sigma, tuple(spacing))
        # the bookkeeping, behind the first scale's features on the card
        weights = msk != 0
        bag = torch.empty((len(rois), ncols), dtype=torch.float32,
                          device=dev)
        classes = _bag_classes(rois, dev)
        _bin_into(bag, feats, weights, classes, edges, cols)
        for sigma, edges, cols in scales:
            feats = features8_auto_channels(img, msk, sigma, tuple(spacing))
            _bin_into(bag, feats, weights, classes, edges, cols)
        with span("bag.fetch", work=len(rois)):
            return _fetch_bag(bag)


def make_bag_dense_device(
    image,
    mask,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    roi_size: Sequence[int] = (41, 41, 41),
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=torch.float32,
    device=None,
):
    """MakeBagDense (tools/MakeBagDense.cxx) on the device: an ROI of
    `roi_size` centred on every voxel where the mask is nonzero and whose
    box lies inside the volume. Returns (starts, rows) on the device:
    starts (N, 3) int64, exactly roi/generate.py:generate_dense_rois(mask,
    roi_size)'s ROIs in its order (z, then y, then x fastest); rows
    (N, histSize * 8 * n_scales) float32 in make_bag_device's layout and bin
    semantics (counts / masked voxels of the box, divided in f32), equal to
    make_bag_device's bag of those ROIs to the bit. The rows stay where
    they were made; nothing returns to the host. `image` and `mask` are
    host arrays or tensors on the target device, as for make_bag_device.

    Spans: "bag.dense", the call (work: N); inside it "bag.stage" (the
    inputs, as in make_bag_device), "bag.dense.index" (the starts, the row
    of each start and each box's masked-voxel count; work: N) and per scale
    the feature pass's spans and "bag.dense.bin", the binning (work: N; the
    one span of the call with device events)."""
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    size = tuple(int(s) for s in roi_size)
    dev = default_device(device)
    ncols = hist_size * NUM_FEATURES * len(sigmas)
    with span("bag.dense") as call:
        with span("bag.stage"):
            img, msk, raw = _scan_inputs(image, mask, dtype, dev, keep_raw=True)
        weights = msk != 0
        with span("bag.dense.index") as ix:
            index = dense_index(raw != 0, weights, size)
            n = ix.work = call.work = index.starts.shape[0]
        rows = torch.empty((n, ncols), dtype=torch.float32, device=dev)
        if n == 0:
            return index.starts, rows
        for sigma, edges, cols in _scales(sigmas, hist_edges, hist_size):
            feats = features8_auto_channels(img, msk, sigma, tuple(spacing))
            with span("bag.dense.bin", device=dev, work=n):
                dense_hist_rows(feats, weights, index, size, edges,
                                rows[:, cols])
            del feats
    return index.starts, rows


def make_bag_sharded(
    image: np.ndarray,
    mask: np.ndarray,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    rois: Sequence[ROI],
    mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=torch.float32,
) -> np.ndarray:
    """make_bag over a block mesh (counterpart of ife_tpu's
    make_bag_sharded): feature volumes never touch the host. Per scale the
    8-channel pass runs sharded (parallel/features.py); then channel by
    channel, one gathered channel live at a time, the channel is gathered on
    the device (a copy within one process, an all_gather across processes)
    and the per-ROI histograms are taken from it by
    roi_feature_histograms_device, as make_bag_device takes them; only the
    (n_rois, hist_size) frequency block of each channel is fetched. A box may
    straddle blocks, so binning block by block would need one launch per box
    and block; the gathered channel needs one per size class. Every masked
    voxel of a box lands in one bin of every channel, so a channel's counts
    divided by their own sum are make_bag_device's frequencies to the bit.
    Same layout and bin semantics as make_bag; every process returns the
    same bag.
    """
    from ife_tpu_torch.parallel.features import sharded_features8
    from ife_tpu_torch.parallel.mesh import (
        crop_from_mesh, gather_volume, pad_to_mesh, shard_volume,
    )

    classes = _size_classes(rois)
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    clamped = clamp_mask(staging.to_device(np.asarray(mask), "cpu"))

    # pad to the mesh grid; ROIs index the original region only, which the
    # gathered channels are cropped back to
    img_p, orig = pad_to_mesh(np.asarray(image, np.float32), mesh)
    msk_p, _ = pad_to_mesh(clamped.numpy(), mesh)
    img_s = shard_volume(img_p, mesh).map(lambda b: b.to(dtype))
    msk_s = shard_volume(msk_p, mesh)
    msk = clamped.to(mesh.device)
    starts_np = np.asarray([r.index for r in rois], np.int64).reshape(-1, 3)
    bag = np.zeros((len(rois), hist_size * NUM_FEATURES * len(sigmas)),
                   dtype=np.float64)

    for sigma, edges, cols in _scales(sigmas, hist_edges, hist_size):
        chans = sharded_features8(img_s, msk_s, sigma, mesh, tuple(spacing),
                                  stack=False)
        for k, chan in enumerate(chans):
            feat = crop_from_mesh(gather_volume(chan), orig)
            col = cols.start + k * hist_size
            for size, idxs in classes:
                freqs = roi_feature_histograms_device(
                    (feat,), msk, starts_np[idxs], edges[k:k + 1], size)
                bag[idxs, col : col + hist_size] = (
                    freqs[:, 0].cpu().numpy().astype(np.float64))
            del feat
    return bag


def make_bag_intensity(
    image: np.ndarray,
    mask: np.ndarray,
    hist_edges: np.ndarray,
    rois: Sequence[ROI],
) -> np.ndarray:
    """MakeBagOnlyIntensity semantics (tools/MakeBagOnlyIntensity.cxx:326-382):
    one histogram over RAW intensity, no features, no scales."""
    edges = np.asarray(hist_edges)
    mask_np = clamp_mask(staging.to_device(np.asarray(mask), "cpu")).numpy()
    img = np.asarray(image)
    bag = np.zeros((len(rois), edges.size + 1), dtype=np.float64)
    for j, r in enumerate(rois):
        crop = img[r.slices()]
        inside = mask_np[r.slices()] != 0
        bag[j] = _roi_frequencies(crop[inside], edges)
    return bag


def sample_rois(image: np.ndarray, rois: Sequence[ROI]) -> np.ndarray:
    """SampleROIs semantics (tools/SampleROIs.cxx:104-170): one row per ROI
    of raw voxel values in ITK scan order (x fastest). ROIs must share size."""
    sizes = {r.size for r in rois}
    if len(sizes) > 1:
        raise ValueError("All ROIs must have the same size")
    rows = []
    img = np.asarray(image)
    for r in rois:
        crop = img[r.slices()]
        # ITK scan order: x fastest -> transpose to (z, y, x) then ravel C-order
        rows.append(crop.transpose(2, 1, 0).reshape(-1))
    return np.stack(rows) if rows else np.zeros((0, 0))


def extract_labels(
    label_image: np.ndarray,
    rois: Sequence[ROI],
    ignore: Sequence[int] = (),
    dominant: int | None = None,
    dominant_threshold: float = 0.0,
) -> List[int]:
    """ExtractLabels semantics (tools/ExtractLabels.cxx:165-210): per-ROI
    mode label, skipping ignore-list values; if `dominant` is given and its
    fraction exceeds `dominant_threshold`, it wins."""
    img = np.asarray(label_image)
    out = []
    ignore_set = set(int(v) for v in ignore)
    for r in rois:
        crop = img[r.slices()].reshape(-1)
        vals, counts = np.unique(crop, return_counts=True)
        keep = [
            (c, v) for v, c in zip(vals.tolist(), counts.tolist())
            if int(v) not in ignore_set
        ]
        if not keep:
            out.append(0)
            continue
        total = sum(c for c, _ in keep)
        if dominant is not None:
            dom = [(c, v) for c, v in keep if int(v) == int(dominant)]
            if dom and dom[0][0] / total > dominant_threshold:
                out.append(int(dominant))
                continue
        keep.sort(key=lambda cv: (-cv[0], cv[1]))
        out.append(int(keep[0][1]))
    return out
