"""Minimal self-contained NIfTI-1 reader/writer (.nii / .nii.gz).

The numpy code of ife_tpu/io/nifti.py re-homed onto the port's Volume: the
subset the pipeline needs (3D volumes, scalar dtypes, spacing via pixdim,
origin via the sform row translations, optional scl_slope/scl_inter
scaling, gzip containers). A file written here holds the same bytes as one
written by ife_tpu from the same array and geometry.

Limitations (documented divergence from the reference): direction/rotation
matrices are not applied — volumes with a non-axis-aligned sform are read
with a warning and treated as axis-aligned.
"""
from __future__ import annotations

import gzip
import struct
import warnings

import numpy as np

from ife_tpu_torch.core.volume import Volume

_DT = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DT_REV = {np.dtype(v): k for k, v in _DT.items()}

_HDR = struct.Struct(
    "<i"      # sizeof_hdr
    "10s18s"  # data_type, db_name (unused)
    "i h c c"  # extents, session_error, regular, dim_info
    "8h"      # dim
    "fff hhh"  # intent_p1-3, intent_code, datatype, bitpix
    "h 8f"    # slice_start, pixdim[8]
    "f f f"   # vox_offset, scl_slope, scl_inter
    "h c c"   # slice_end, slice_code, xyzt_units
    "f f f f" # cal_max, cal_min, slice_duration, toffset
    "i i"     # glmax, glmin
    "80s 24s" # descrip, aux_file
    "h h"     # qform_code, sform_code
    "6f"      # quatern_b,c,d, qoffset_x,y,z
    "4f 4f 4f"  # srow_x, srow_y, srow_z
    "16s 4s"  # intent_name, magic
)
if _HDR.size != 348:
    raise ImportError(f"NIfTI-1 header layout is {_HDR.size} bytes, not 348")


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Volume:
    with _open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 352:
        raise ValueError(f"Not a NIfTI-1 file (too short): {path}")
    hdr = _HDR.unpack(raw[:348])
    sizeof_hdr = hdr[0]
    if sizeof_hdr != 348:
        raise ValueError(f"Not a NIfTI-1 file (sizeof_hdr={sizeof_hdr}): {path}")
    magic = hdr[-1]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"Bad NIfTI magic {magic!r}: {path}")
    dim = hdr[7:15]
    ndim = dim[0]
    if ndim < 3:
        shape = tuple(dim[1 : 1 + ndim]) + (1,) * (3 - ndim)
    else:
        extra = dim[4 : 1 + ndim]
        if any(e > 1 for e in extra):
            raise ValueError(f"Only 3D volumes supported, dim={dim}")
        shape = tuple(dim[1:4])
    datatype = hdr[19]
    if datatype not in _DT:
        raise ValueError(f"Unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DT[datatype])
    pixdim = hdr[22:30]
    spacing = tuple(abs(float(p)) or 1.0 for p in pixdim[1:4])
    vox_offset = int(hdr[30])
    scl_slope, scl_inter = float(hdr[31]), float(hdr[32])
    sform_code = hdr[45]
    srows = np.array(hdr[52:64], dtype=np.float64).reshape(3, 4)
    if sform_code > 0:
        origin = tuple(srows[:, 3])
        rot = srows[:, :3]
        offdiag = rot - np.diag(np.diag(rot))
        if np.abs(offdiag).max() > 1e-6 * max(1.0, np.abs(rot).max()):
            warnings.warn(
                f"{path}: non-axis-aligned sform ignored (treated as identity "
                "direction)", stacklevel=2,
            )
    else:
        origin = (float(hdr[49]), float(hdr[50]), float(hdr[51]))

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=dtype, count=count, offset=vox_offset
    )
    # NIfTI stores x fastest: file order (z, y, x) C-contiguous
    arr = data.reshape(shape[::-1]).transpose(2, 1, 0)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr * np.float32(slope) + np.float32(scl_inter)
    return Volume.from_numpy(np.ascontiguousarray(arr), spacing=spacing,
                             origin=origin)


def write_nifti(path: str, vol: Volume) -> None:
    arr = vol.numpy()
    if arr.ndim != 3:
        raise ValueError(f"write_nifti needs a 3D array, got shape {arr.shape}")
    dt = np.dtype(arr.dtype)
    if dt == np.dtype(np.int64):
        arr, dt = arr.astype(np.int32), np.dtype(np.int32)
    if dt == np.dtype(bool):
        arr, dt = arr.astype(np.uint8), np.dtype(np.uint8)
    if dt not in _DT_REV:
        arr, dt = arr.astype(np.float32), np.dtype(np.float32)
    datatype = _DT_REV[dt]
    bitpix = dt.itemsize * 8
    sx, sy, sz = vol.spacing
    ox, oy, oz = vol.origin
    hdr = _HDR.pack(
        348,
        b"", b"",
        0, 0, b"r", b"\x00",
        3, arr.shape[0], arr.shape[1], arr.shape[2], 1, 1, 1, 1,
        0.0, 0.0, 0.0, 0, datatype, bitpix,
        0, 0.0, sx, sy, sz, 1.0, 1.0, 1.0, 1.0,
        352.0, 1.0, 0.0,
        0, b"\x00", b"\x00",
        0.0, 0.0, 0.0, 0.0,
        0, 0,
        # the descrip field names the format's writer as ife_tpu's does, so
        # both packages write byte-identical files
        b"ife_tpu", b"",
        0, 1,
        0.0, 0.0, 0.0, float(ox), float(oy), float(oz),
        sx, 0.0, 0.0, float(ox),
        0.0, sy, 0.0, float(oy),
        0.0, 0.0, sz, float(oz),
        b"", b"n+1\x00",
    )
    with _open(path, "wb") as f:
        f.write(hdr)
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.ascontiguousarray(arr).tobytes(order="F"))
