"""Octave ASCII matrix format reader/writer — the numpy code of
ife_tpu/io/octave.py on the port's Volume.

Reference: include/ife/IO/OctaveReader.hxx:20-145. Header:
    # <creator>
    # name: <var-name>
    # type: <type-name>
    # ndims: 3
    <sx> <sy> <sz>
Data order quirk preserved (OctaveReader.hxx:119-139): slice-major over z,
and within each slice the reference's loops nest z -> x -> y, i.e. the
value stream index is ((z * sx) + x) * sy + y.
"""
from __future__ import annotations

import numpy as np

from ife_tpu_torch.core.volume import Volume


def read_octave(path: str) -> Volume:
    with open(path, "r") as f:
        f.readline()  # creator comment
        def kv(expect):
            parts = f.readline().split(":")
            if len(parts) != 2 or parts[0].strip("# ").strip() != expect:
                raise ValueError(f"Expected '# {expect}: ...'")
            return parts[1].strip()

        kv("name")
        kv("type")
        ndims = int(kv("ndims"))
        size = [int(t) for t in f.readline().split()]
        if len(size) != ndims:
            raise ValueError("ndims and number of size fields do not match")
        if ndims != 3:
            raise ValueError("Dimension must be 3")
        vals = np.loadtxt(f, dtype=np.float64).reshape(-1)
    sx, sy, sz = size
    if vals.size < sx * sy * sz:
        raise ValueError("Not enough values in file")
    vals = vals[: sx * sy * sz]
    # stream order (z, x, y) -> array[x, y, z]
    arr = vals.reshape(sz, sx, sy).transpose(1, 2, 0)
    return Volume.from_numpy(np.ascontiguousarray(arr))


def write_octave(path: str, vol: Volume, name: str = "volume") -> None:
    arr = vol.numpy()
    with open(path, "w") as f:
        # the creator line is ife_tpu's, so both packages write identical files
        f.write("# Created by ife_tpu\n")
        f.write(f"# name: {name}\n")
        f.write("# type: matrix\n")
        f.write("# ndims: 3\n")
        f.write(f" {arr.shape[0]} {arr.shape[1]} {arr.shape[2]}\n")
        stream = arr.transpose(2, 0, 1).reshape(-1)  # (z, x, y) order
        np.savetxt(f, stream[:, None], fmt="%.17g")
