"""Minimal DICOM series reader — ConvertDICOM capability without pydicom.

Reference (tools/ConvertDICOM.cxx:70-131): discover series in a directory,
build one volume per SeriesInstanceUID sorted by slice position, name the
output from PatientID/StudyDate/ConvolutionKernel/SliceSpacing tags.

Scope: uncompressed little-endian transfer syntaxes (Implicit VR
1.2.840.10008.1.2 and Explicit VR 1.2.840.10008.1.2.1), RLE Lossless
(1.2.840.10008.1.2.5, PackBits segments), JPEG Lossless SV1
(1.2.840.10008.1.2.4.70, process 14 first-order prediction; decoder in
io/jpegll.py), and JPEG-LS (1.2.840.10008.1.2.4.80 lossless /
...4.81 near-lossless, T.87 LOCO-I; codec in io/jpegls.py) with
monochrome int8/16 pixels — together the common compressed CT archive
syntaxes the reference reads through GDCM. The remaining compressed
syntaxes (lossy JPEG, JPEG 2000 — a full wavelet/EBCOT codec is
deliberately scoped out) raise a clear error listing what is supported.
This is a deliberate from-scratch parser (no pydicom; the reference used
ITK's GDCM). A copy of ife_tpu/io/dicom.py that builds the port's Volume on
the host; the compressed frames go through the native decoders of
ife_tpu_torch/native_lib.py.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ife_tpu_torch.core.volume import Volume

_MAGIC_OFFSET = 128
_UNCOMPRESSED = {
    "1.2.840.10008.1.2",     # implicit VR LE
    "1.2.840.10008.1.2.1",   # explicit VR LE
}
_RLE = "1.2.840.10008.1.2.5"  # RLE Lossless (PackBits segments)
_JPEG_LL = "1.2.840.10008.1.2.4.70"  # JPEG Lossless SV1 (process 14)
_JPEG_LS = "1.2.840.10008.1.2.4.80"  # JPEG-LS Lossless (T.87)
_JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"  # JPEG-LS near-lossless
SUPPORTED_SYNTAXES = sorted(
    _UNCOMPRESSED | {_RLE, _JPEG_LL, _JPEG_LS, _JPEG_LS_NEAR})
# VRs with a 2-byte reserved field and 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}

TAGS = {
    "TransferSyntaxUID": (0x0002, 0x0010),
    "StudyDate": (0x0008, 0x0020),
    "SeriesInstanceUID": (0x0020, 0x000E),
    "PatientID": (0x0010, 0x0020),
    "ConvolutionKernel": (0x0018, 0x1210),
    "SliceThickness": (0x0018, 0x0050),
    "ImagePositionPatient": (0x0020, 0x0032),
    "NumberOfFrames": (0x0028, 0x0008),
    "Rows": (0x0028, 0x0010),
    "Columns": (0x0028, 0x0011),
    "PixelSpacing": (0x0028, 0x0030),
    "BitsAllocated": (0x0028, 0x0100),
    "PixelRepresentation": (0x0028, 0x0103),
    "RescaleIntercept": (0x0028, 0x1052),
    "RescaleSlope": (0x0028, 0x1053),
    "PixelData": (0x7FE0, 0x0010),
}
_WANTED = {v: k for k, v in TAGS.items()}


def _parse_elements(buf: bytes, explicit: bool, start: int) -> Dict[str, bytes]:
    """Single linear pass collecting wanted top-level elements."""
    out: Dict[str, bytes] = {}
    pos = start
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit or group == 0x0002:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == TAGS["PixelData"]:
                # encapsulated pixel data: Basic Offset Table item + one
                # item per frame, terminated by a sequence delimiter
                frags = []
                while pos + 8 <= n:
                    g2, e2 = struct.unpack_from("<HH", buf, pos)
                    ln = struct.unpack_from("<I", buf, pos + 4)[0]
                    pos += 8
                    if (g2, e2) == (0xFFFE, 0xE0DD):
                        break
                    if (g2, e2) != (0xFFFE, 0xE000):
                        raise ValueError("malformed encapsulated pixel data")
                    frags.append(buf[pos : pos + ln])
                    pos += ln
                out["PixelDataFragments"] = frags  # type: ignore[assignment]
                break
            raise ValueError(
                "undefined-length element (sequence data) is not supported"
            )
        key = _WANTED.get((group, elem))
        if key is not None:
            out[key] = buf[pos : pos + length]
        pos += length
        if (group, elem) == TAGS["PixelData"]:
            break
    return out


def read_dicom_file(path: str) -> Optional[Dict[str, bytes]]:
    """Parse one DICOM file's wanted elements; None if not DICOM."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < _MAGIC_OFFSET + 4 or buf[_MAGIC_OFFSET : _MAGIC_OFFSET + 4] != b"DICM":
        return None
    # file meta group (0002) is always explicit VR LE
    meta = _parse_elements(buf, explicit=True, start=_MAGIC_OFFSET + 4)
    ts = meta.get("TransferSyntaxUID", b"").decode("ascii", "ignore").strip("\x00 ")
    if ts and ts not in SUPPORTED_SYNTAXES:
        raise ValueError(
            f"{path}: unsupported transfer syntax {ts}; supported: "
            + ", ".join(SUPPORTED_SYNTAXES)
            + " — transcode lossy-JPEG/JPEG2000 files to one of these"
        )
    explicit = ts != "1.2.840.10008.1.2"
    # skip past the meta group: re-scan from after DICM, stopping when group
    # changes from 0002 — cheap approach: parse whole file with the dataset
    # syntax, tolerating the meta group parsed twice
    pos = _MAGIC_OFFSET + 4
    n = len(buf)
    # advance over group-0002 elements (explicit VR)
    while pos + 8 <= n:
        group = struct.unpack_from("<H", buf, pos)[0]
        if group != 0x0002:
            break
        vr = buf[pos + 6 : pos + 8]
        if vr in _LONG_VRS:
            length = struct.unpack_from("<I", buf, pos + 8)[0]
            pos += 12 + length
        else:
            length = struct.unpack_from("<H", buf, pos + 6)[0]
            pos += 8 + length
    data = _parse_elements(buf, explicit=explicit, start=pos)
    data.update({k: v for k, v in meta.items() if k not in data})
    data["_ts"] = ts.encode()
    return data


def _packbits_decode(src: bytes, out_len: int) -> bytes:
    """PackBits (DICOM RLE segment) decode: n<128 -> copy n+1 literal
    bytes; n>128 -> repeat next byte 257-n times; n==128 -> no-op."""
    out = bytearray()
    i, L = 0, len(src)
    while i < L and len(out) < out_len:
        n = src[i]
        i += 1
        if n < 128:
            out += src[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += bytes([src[i]]) * (257 - n)
            i += 1
    if len(out) < out_len:
        raise ValueError("truncated RLE segment")
    return bytes(out[:out_len])


def _rle_decode_frame(frame: bytes, npix: int, bits: int,
                      signed: bool) -> np.ndarray:
    """One RLE Lossless frame: 64-byte header (uint32 segment count + 15
    uint32 segment offsets), then PackBits segments — byte planes of the
    composite pixel code, most significant first (DICOM PS3.5 G)."""
    n_seg = struct.unpack_from("<I", frame, 0)[0]
    offsets = struct.unpack_from("<15I", frame, 4)
    segs = []
    for s in range(n_seg):
        start = offsets[s]
        end = offsets[s + 1] if s + 1 < n_seg and offsets[s + 1] else len(frame)
        segs.append(np.frombuffer(
            _packbits_decode(frame[start:end], npix), np.uint8))
    if bits == 8:
        return segs[0].view(np.int8) if signed else segs[0]
    val = (segs[0].astype(np.uint16) << 8) | segs[1]
    return val.view(np.int16) if signed else val


def _s(d: Dict[str, bytes], key: str, default: str = "") -> str:
    return d.get(key, default.encode()).decode("ascii", "ignore").strip("\x00 ")


def _f(d: Dict[str, bytes], key: str, default: float = 0.0) -> float:
    s = _s(d, key)
    try:
        return float(s.split("\\")[0]) if s else default
    except ValueError:
        return default


def _us(d: Dict[str, bytes], key: str) -> int:
    raw = d.get(key, b"\x00\x00")
    return struct.unpack("<H", raw[:2])[0]


def read_dicom_series(paths: List[str]) -> Tuple[Volume, Dict[str, str]]:
    """Assemble one volume from slice files of a single series, sorted by
    z position (ImagePositionPatient[2])."""
    slices = []
    for p in paths:
        d = read_dicom_file(p)
        if d is None or ("PixelData" not in d
                         and "PixelDataFragments" not in d):
            continue
        ipp = _s(d, "ImagePositionPatient")
        z = float(ipp.split("\\")[2]) if ipp else float(len(slices))
        slices.append((z, d))
    if not slices:
        raise ValueError("no DICOM image slices found")
    slices.sort(key=lambda t: t[0])
    d0 = slices[0][1]
    rows, cols = _us(d0, "Rows"), _us(d0, "Columns")
    bits = _us(d0, "BitsAllocated") or 16
    signed = _us(d0, "PixelRepresentation") == 1
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16}[bits]
    planes = []
    for z, d in slices:
        if "PixelDataFragments" in d:
            # the fragment joiners below assume ONE frame per file (the CT
            # series layout); a multi-frame file would silently collapse
            # frames into garbage — refuse it loudly instead
            nf = _s(d, "NumberOfFrames")
            if nf and int(float(nf)) > 1:
                raise ValueError(
                    f"multi-frame encapsulated DICOM (NumberOfFrames={nf}) "
                    "is not supported — split into single-frame files"
                )
            frags = d["PixelDataFragments"]
            ts_here = d.get("_ts", b"").decode()
            if ts_here in (_JPEG_LS, _JPEG_LS_NEAR):
                # one frame, possibly fragmented (PS3.5 A.4) — join past
                # the Basic Offset Table fragment
                frame = b"".join(frags[1:]) if len(frags) > 1 else frags[0]
                from ife_tpu_torch.io.jpegls import decode_jpegls_fast

                raw = decode_jpegls_fast(
                    frame, rows, cols)[:rows, :cols].reshape(-1)
                if bits == 8:
                    arr = raw.astype(np.uint8)
                    arr = arr.view(np.int8) if signed else arr
                else:
                    raw = raw.astype(np.uint16)
                    arr = raw.view(np.int16) if signed else raw
            elif ts_here == _JPEG_LL:
                # single-frame files: fragment 0 is the (possibly empty)
                # Basic Offset Table; a JPEG frame MAY be split across
                # several following fragments (PS3.5 A.4) — join them
                frame = b"".join(frags[1:]) if len(frags) > 1 else frags[0]
                from ife_tpu_torch.io.jpegll import decode_jpeg_lossless_fast

                raw = decode_jpeg_lossless_fast(
                    frame, rows, cols)[:rows, :cols].reshape(-1)
                if bits == 8:
                    arr = raw.astype(np.uint8)
                    arr = arr.view(np.int8) if signed else arr
                else:
                    # two's-complement reinterpretation, like the raw path
                    arr = raw.view(np.int16) if signed else raw
            else:
                # RLE: one fragment per frame (PS3.5 G.1) — the last
                # fragment is the (single) frame
                arr = _rle_decode_frame(frags[-1], rows * cols, bits,
                                        signed)
        else:
            arr = np.frombuffer(d["PixelData"], dtype=dtype)[: rows * cols]
        slope = _f(d, "RescaleSlope", 1.0)
        inter = _f(d, "RescaleIntercept", 0.0)
        planes.append(arr.reshape(rows, cols).astype(np.float32) * slope + inter)
    vol_zyx = np.stack(planes)  # (Z, rows=Y, cols=X)
    data = np.ascontiguousarray(vol_zyx.transpose(2, 1, 0))  # -> (X, Y, Z)

    ps = _s(d0, "PixelSpacing") or "1\\1"
    ry, rx = (float(v) for v in ps.split("\\")[:2])  # row spacing, col spacing
    if len(slices) > 1:
        dz = abs(slices[1][0] - slices[0][0]) or _f(d0, "SliceThickness", 1.0)
    else:
        dz = _f(d0, "SliceThickness", 1.0)
    vol = Volume.from_numpy(data, spacing=(rx, ry, dz))
    tags = {
        "PatientID": _s(d0, "PatientID", "unknown"),
        "StudyDate": _s(d0, "StudyDate", "00000000"),
        "ConvolutionKernel": _s(d0, "ConvolutionKernel", "NA"),
        "SliceSpacing": f"{dz:g}",
    }
    return vol, tags


def convert_dicom_dir(dicom_dir: str, out_dir: str) -> List[str]:
    """Discover series (by SeriesInstanceUID) in a directory tree and write
    one volume per series, named from the reference's tag scheme
    (ConvertDICOM.cxx:105-131); returns the paths in uid order."""
    from ife_tpu_torch.io.volume_io import write_volume
    from ife_tpu_torch.utils.profiling import stage_timer

    series: Dict[str, List[str]] = {}
    for root, _dirs, files in os.walk(dicom_dir):
        for fn in sorted(files):
            path = os.path.join(root, fn)
            try:
                d = read_dicom_file(path)
            except (ValueError, struct.error):
                continue
            if d is None or ("PixelData" not in d
                             and "PixelDataFragments" not in d):
                continue
            series.setdefault(_s(d, "SeriesInstanceUID", "unknown"), []).append(path)
    if not series:
        raise ValueError(f"no DICOM series found under {dicom_dir}")
    os.makedirs(out_dir, exist_ok=True)

    written = []
    for uid, paths in sorted(series.items()):
        # two spans a series in utils.profiling's store:
        # "convert-dicom decode <uid>" (parse, decode, rescale) and
        # "convert-dicom write <uid>" (the gzip-9 NIfTI write)
        with stage_timer(f"convert-dicom decode {uid}"):
            vol, tags = read_dicom_series(paths)
        name = "_".join(
            [tags["PatientID"], tags["StudyDate"], tags["ConvolutionKernel"],
             tags["SliceSpacing"]]
        ).replace(" ", "-").replace("/", "-")
        out_path = os.path.join(out_dir, f"{name}.nii.gz")
        with stage_timer(f"convert-dicom write {uid}",
                         work=vol.data.numel()):
            write_volume(out_path, vol)
        written.append(out_path)
    return written
