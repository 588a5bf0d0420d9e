"""HR2 binary volume format (reverse-engineered, reference
src/IO/HR2Reader.cxx:11-37) — the numpy code of ife_tpu/io/hr2.py on the
port's Volume.

Layout: 3-byte magic ("HR?" where ? != '3', HR2Reader.cxx:97-102 — quirk
preserved), then length-prefixed ASCII tags, each followed by a
little-endian field length of up to 4 non-zero bytes terminated early by a
zero byte (HR2Reader.cxx:211-222), then the field payload. The ImageData
tag ends the header; its payload is a zlib stream of float32 or int8
voxels, x fastest.
"""
from __future__ import annotations

import io
import zlib

import numpy as np

from ife_tpu_torch.core.volume import Volume

_TAGS = (
    "PixelType", "Compression", "Dimension", "Size", "Origin", "Spacing", "ImageData",
)


def _read_tag(f) -> str:
    blen = f.read(1)
    if not blen:
        raise ValueError("Error reading from stream")
    s = f.read(blen[0]).decode("ascii")
    if s not in _TAGS:
        raise ValueError("Not an HR2 tag")
    return s


def _read_field_length(f) -> int:
    """Up to 4 little-endian bytes; a zero byte terminates early
    (HR2Reader.cxx:211-222)."""
    got = []
    while True:
        b = f.read(1)
        if not b:
            raise ValueError("Error reading from stream")
        if b[0] == 0:
            break
        got.append(b[0])
        if len(got) == 4:
            break
    while len(got) < 4:
        got.append(0)
    return got[0] | (got[1] << 8) | (got[2] << 16) | (got[3] << 24)


def _write_field_length(n: int) -> bytes:
    """Inverse of _read_field_length: little-endian bytes up to the last
    nonzero one, zero-terminated if fewer than 4 bytes were emitted.
    Lengths whose little-endian encoding contains an interior zero byte
    cannot be represented (the reader would terminate early)."""
    le = [(n >> (8 * i)) & 0xFF for i in range(4)]
    while le and le[-1] == 0:
        le.pop()
    if not le:
        return b"\x00"
    if any(b == 0 for b in le):
        raise ValueError(
            f"field length {n} has an interior zero byte in little-endian "
            "form and cannot be encoded in the HR2 length scheme"
        )
    out = bytes(le)
    if len(out) < 4:
        out += b"\x00"
    return out


def read_hr2(path: str, native: bool = True) -> Volume:
    if native:
        # the native path (zlib in C++, ife_tpu_torch/native_lib.py); a
        # library that cannot be built raises
        from ife_tpu_torch import native_lib

        try:
            data, spacing, origin = native_lib.hr2_read_native(path)
        except ValueError:
            pass  # let the pure-Python path produce the error message
        else:
            return Volume.from_numpy(data, spacing=spacing, origin=origin)
    with open(path, "rb") as f:
        magic = f.read(3)
        if not (magic[:2] == b"HR" and magic[2:3] != b"3"):
            raise ValueError("Not an HR2 file")
        pixel_type = None
        compression = None
        dimension = None
        size: list[int] = []
        origin: list[float] = []
        spacing: list[float] = []
        while True:
            tag = _read_tag(f)
            length = _read_field_length(f)
            if tag == "ImageData":
                payload = f.read(length)
                break
            s = f.read(length).decode("ascii")
            if tag == "PixelType":
                pixel_type = s
            elif tag == "Dimension":
                dimension = int(s)
            elif tag == "Size":
                size = [int(t) for t in s.split()]
            elif tag == "Origin":
                origin = [float(t) for t in s.split()]
            elif tag == "Spacing":
                spacing = [float(t) for t in s.split()]
            elif tag == "Compression":
                compression = s

    if pixel_type not in ("float", "char"):
        raise ValueError("PixelType not implemented")
    if compression != "ZLib":
        raise ValueError("Only ZLib compression implemented")
    if dimension is None or len(size) != dimension:
        raise ValueError("Number of size elements does not match dimension")
    if len(origin) != dimension:
        raise ValueError("Number of origin elements does not match dimension")
    if len(spacing) != dimension:
        raise ValueError("Number of spacing elements does not match dimension")

    inflated = zlib.decompress(payload)
    if pixel_type == "float":
        buf = np.frombuffer(inflated, dtype=np.float32)
    else:
        buf = np.frombuffer(inflated, dtype=np.int8).astype(np.float32)

    if dimension == 3:
        arr = buf.reshape(size[::-1]).transpose(2, 1, 0)  # x fastest in file
        return Volume.from_numpy(
            np.ascontiguousarray(arr),
            spacing=tuple(spacing),
            origin=tuple(origin),
        )
    # non-3D: pad metadata to 3 dims
    arr = buf.reshape(list(size[::-1]) + [1] * (3 - dimension))
    arr = np.ascontiguousarray(arr.transpose(tuple(range(arr.ndim))[::-1]))
    pad = lambda v, fill: tuple(list(v) + [fill] * (3 - dimension))
    return Volume.from_numpy(arr, spacing=pad(spacing, 1.0),
                             origin=pad(origin, 0.0))


def write_hr2(path: str, vol: Volume, pixel_type: str = "float") -> None:
    """Writer (the reference has only a reader; needed for round-trip tests
    and interop)."""
    arr = vol.numpy()
    if pixel_type == "float":
        payload_raw = np.ascontiguousarray(arr.astype(np.float32)).tobytes(order="F")
    elif pixel_type == "char":
        payload_raw = np.ascontiguousarray(arr.astype(np.int8)).tobytes(order="F")
    else:
        raise ValueError("pixel_type must be 'float' or 'char'")
    payload = zlib.compress(payload_raw)

    def field(tag: str, body: bytes) -> bytes:
        return bytes([len(tag)]) + tag.encode() + _write_field_length(len(body)) + body

    fmt_f = lambda vals: " ".join(repr(float(v)) for v in vals).encode()
    out = io.BytesIO()
    out.write(b"HR2")
    out.write(field("PixelType", pixel_type.encode()))
    out.write(field("Dimension", b"3"))
    out.write(field("Size", " ".join(str(s) for s in arr.shape).encode()))
    out.write(field("Origin", fmt_f(vol.origin)))
    out.write(field("Spacing", fmt_f(vol.spacing)))
    out.write(field("Compression", b"ZLib"))
    out.write(field("ImageData", payload))
    with open(path, "wb") as f:
        f.write(out.getvalue())
