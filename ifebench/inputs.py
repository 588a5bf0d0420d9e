"""The benchmark's own inputs, made from the seed: chest-CT-like scans and
lung masks, ROI corners, and the bin edges of a configuration.

A scan is f32 Hounsfield units over (X, Y, Z): air outside an elliptic
body cylinder, soft tissue inside it, two lungs (jittered ellipsoids) with
low-attenuation blobs, and white noise everywhere. The noise keeps the
Hessian free of the flat blocks that make eigenvalue ties. Everything is
made on the device the caller names, in a few large calls.

Every seed gets the same set of lung sizes (the ``size_factors`` of the
configuration, one a pool slot, in an order drawn from the seed), so the
masked work a pool holds does not change with the seed; the seed moves the
lungs, the blobs, the noise and the ROIs.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _seed_words(*words) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(w) for w in words])


def slot_rng(seed: int, slot: int, stream: int) -> np.random.Generator:
    """The numpy generator of one pool slot and one use (stream)."""
    return np.random.default_rng(_seed_words(seed, slot, stream))


def _torch_generator(seed: int, slot: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    word = int(_seed_words(seed, slot, 0).generate_state(1, np.uint64)[0])
    g.manual_seed(word >> 1)
    return g


def lung_geometry(scan: dict, shape, seed: int, slot: int, pool: int):
    """[(centre, semi_axes)] of the two lungs of one slot, in voxels of
    `shape`: the configuration's geometry (given for scan["shape"]) scaled
    to `shape`, its size factor, and centres jittered from the seed."""
    lung = scan["lung"]
    scale = np.asarray(shape, np.float64) / np.asarray(scan["shape"],
                                                       np.float64)
    factors = lung["size_factors"]
    order = np.random.default_rng(_seed_words(seed)).permutation(pool)
    factor = factors[int(order[slot]) % len(factors)]
    rng = slot_rng(seed, slot, 1)
    centre = np.asarray(shape, np.float64) / 2.0
    out = []
    for side in (-1.0, 1.0):
        c = centre + np.asarray(lung["offset"], np.float64) * scale
        c[0] += side * lung["x_offset"] * scale[0]
        c += rng.uniform(-1.0, 1.0, 3) * lung["jitter"] * scale
        semi = np.asarray(lung["semi_axes"], np.float64) * factor * scale
        out.append((c, semi))
    return out


def make_scan(scan: dict, mask_kind: str, seed: int, slot: int, pool: int,
              device, shape=None):
    """(image f32, mask uint8) of pool slot `slot` on `device`, (X, Y, Z) =
    `shape` (the configuration's own by default). mask_kind "lung" masks
    the two lungs, "ones" every voxel."""
    shape = tuple(int(s) for s in (shape or scan["shape"]))
    if mask_kind not in ("lung", "ones"):
        raise ValueError(f"no mask kind {mask_kind!r}")
    hu = scan["hu"]
    g = _torch_generator(seed, slot, device)
    scale = np.asarray(shape, np.float64) / np.asarray(scan["shape"],
                                                       np.float64)
    axes = [torch.arange(n, device=device, dtype=torch.float32) + 0.5
            for n in shape]
    xx = axes[0].view(-1, 1, 1)
    yy = axes[1].view(1, -1, 1)
    zz = axes[2].view(1, 1, -1)

    bx, by = (np.asarray(scan["body_semi_axes"], np.float64) * scale[:2])
    body = ((xx - shape[0] / 2) / bx) ** 2 + ((yy - shape[1] / 2) / by) ** 2 <= 1
    lungs = torch.zeros(shape, dtype=torch.bool, device=device)
    for c, semi in lung_geometry(scan, shape, seed, slot, pool):
        lungs |= (((xx - c[0]) / semi[0]) ** 2 + ((yy - c[1]) / semi[1]) ** 2
                  + ((zz - c[2]) / semi[2]) ** 2) <= 1

    # low-attenuation blobs: a coarse normal field, upsampled, over a
    # quantile of its coarse values
    cell = int(scan["blobs"]["cell"])
    coarse_shape = [max(2, -(-n // cell)) for n in shape]
    coarse = torch.randn(coarse_shape, generator=g, device=device)
    level = torch.quantile(coarse.flatten()[:1 << 24].double(),
                           float(scan["blobs"]["quantile"])).float()
    field = F.interpolate(coarse[None, None], size=shape, mode="trilinear",
                          align_corners=False)[0, 0]
    blobs = lungs & (field > level)

    image = torch.full(shape, float(hu["air"]), device=device)
    image = torch.where(body, torch.tensor(float(hu["body"]), device=device),
                        image)
    image = torch.where(lungs, torch.tensor(float(hu["lung"]), device=device),
                        image)
    image = torch.where(blobs, torch.tensor(float(hu["low_attenuation"]),
                                            device=device), image)
    image += float(hu["noise_sd"]) * torch.randn(shape, generator=g,
                                                 device=device)
    if mask_kind == "lung":
        mask = lungs.to(torch.uint8)
    else:
        mask = torch.ones(shape, dtype=torch.uint8, device=device)
    return image.contiguous(), mask.contiguous()


def draw_rois(mask: np.ndarray, n: int, size, seed: int, slot: int):
    """(n, 3) int64 start corners of boxes of `size`, each centred on a
    voxel of `mask` (start = centre - size // 2, MakeBag's convention) and
    lying inside the volume: centres drawn uniformly from the seed over the
    voxels where such a box fits, kept where the mask is set."""
    size = np.asarray(size, np.int64)
    shape = np.asarray(mask.shape, np.int64)
    lo = size // 2
    hi = shape - size + size // 2          # exclusive
    if (hi <= lo).any():
        raise ValueError(f"ROI size {tuple(size)} does not fit {tuple(shape)}")
    rng = slot_rng(seed, slot, 2)
    out = []
    for _ in range(1000):
        c = rng.integers(lo, hi, size=(max(64, 8 * n), 3))
        keep = mask[c[:, 0], c[:, 1], c[:, 2]] != 0
        out.extend(c[keep][: n - len(out)])
        if len(out) == n:
            return np.stack(out) - lo
    raise ValueError("the mask holds too few voxels for the ROIs")


def load_edges(path: Path, n_hist: int, bins: int) -> list:
    """The configuration's bin edges: `n_hist` f64 arrays of `bins` - 1
    edges, scale-major (histogram i * 8 + k is scale i, feature k)."""
    data = json.loads(Path(path).read_text())
    edges = [np.asarray(e, np.float64) for e in data["edges"]]
    if len(edges) != n_hist or any(e.shape != (bins - 1,) for e in edges):
        raise ValueError(f"{path}: expected {n_hist} rows of {bins - 1} edges")
    if any((np.diff(e) < 0).any() or not np.isfinite(e).all() for e in edges):
        raise ValueError(f"{path}: edges must be finite and non-decreasing")
    return edges
