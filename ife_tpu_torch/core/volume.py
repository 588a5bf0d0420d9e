"""Volume: a voxel tensor plus physical metadata.

Counterpart of ife_tpu/core/volume.py. A Volume is a frozen dataclass
holding a ``torch.Tensor`` of shape (X, Y, Z) (axis 0 = ITK direction 0)
and its spacing/origin; it lives on whatever device its tensor does.
``synthetic_ct`` and ``sphere_mask`` build their arrays in numpy exactly as
ife_tpu does, so both packages compute on bit-identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _as_tuple3(v, name: str) -> Tuple[float, float, float]:
    t = tuple(float(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"{name} must have 3 elements, got {len(t)}")
    return t


@dataclasses.dataclass(frozen=True)
class Volume:
    """A 3D image: data[x, y, z] + physical geometry.

    Attributes:
      data: tensor of shape (X, Y, Z).
      spacing: voxel size in physical units per axis (sx, sy, sz).
      origin: physical coordinate of voxel (0, 0, 0).
    """

    data: torch.Tensor
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __post_init__(self):
        object.__setattr__(self, "spacing", _as_tuple3(self.spacing, "spacing"))
        object.__setattr__(self, "origin", _as_tuple3(self.origin, "origin"))

    @classmethod
    def from_numpy(cls, arr, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                   device=None) -> "Volume":
        """Wrap a numpy array (copied when numpy marks it read-only, so the
        tensor never aliases a read-only buffer)."""
        arr = np.asarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        data = torch.from_numpy(arr)
        if device is not None:
            data = data.to(device)
        return cls(data, spacing=spacing, origin=origin)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def with_data(self, data) -> "Volume":
        """Same geometry, new voxel data."""
        return Volume(data=data, spacing=self.spacing, origin=self.origin)

    def astype(self, dtype) -> "Volume":
        return self.with_data(self.data.to(dtype))

    def numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def physical_point(self, index) -> Tuple[float, float, float]:
        """Physical coordinate of a voxel index (continuous indices allowed)."""
        return tuple(
            self.origin[d] + self.spacing[d] * float(index[d]) for d in range(3)
        )

    def crop(self, start, size) -> "Volume":
        """Extract a region-of-interest box; origin shifts accordingly
        (itk::RegionOfInterestImageFilter semantics, as in ife_tpu)."""
        sl = tuple(slice(int(start[d]), int(start[d]) + int(size[d])) for d in range(3))
        new_origin = self.physical_point(start)
        return Volume(data=self.data[sl], spacing=self.spacing, origin=new_origin)


def synthetic_ct(shape=(64, 64, 64), seed=0, dtype=torch.float32,
                 device=None) -> Volume:
    """A smooth synthetic CT-like volume for tests/benchmarks.

    Band-limited random field scaled to CT-ish intensities [-1000, 0]; the
    numpy recipe of ife_tpu.core.volume.synthetic_ct, step for step.
    """
    rng = np.random.default_rng(seed)
    small_shape = [max(2, s // 8) for s in shape]
    small = rng.standard_normal(small_shape)
    # upsample by repetition (factor rounded up so every axis covers `shape`)
    arr = small
    for axis in range(3):
        factor = -(-shape[axis] // small_shape[axis])
        arr = np.repeat(arr, factor, axis=axis)[
            tuple(slice(0, shape[a]) if a == axis else slice(None) for a in range(3))
        ]
    arr = arr[: shape[0], : shape[1], : shape[2]]
    for axis in range(3):
        arr = (
            np.roll(arr, 1, axis) + arr + np.roll(arr, -1, axis)
        ) / 3.0
    arr = (arr - arr.min()) / max(float(np.ptp(arr)), 1e-9)
    arr = -1000.0 + 1000.0 * arr
    return Volume(torch.from_numpy(arr).to(device=device, dtype=dtype))


def sphere_mask(shape=(64, 64, 64), radius_frac=0.4, dtype=torch.uint8,
                device=None) -> Volume:
    """Binary sphere mask centered in the volume."""
    coords = np.ogrid[tuple(slice(0, s) for s in shape)]
    center = [(s - 1) / 2.0 for s in shape]
    r2 = sum(((c - m) / (radius_frac * s)) ** 2 for c, m, s in zip(coords, center, shape))
    return Volume(torch.from_numpy(r2 <= 1.0).to(device=device, dtype=dtype))
