"""The port's DICOM reader (ife_tpu_torch/io/dicom.py) and JPEG codecs
(io/jpegll.py, io/jpegls.py) against ife_tpu's on the CPU, on the same
bytes: convert_dicom_dir and read_dicom_series give the same file names,
file contents, arrays, spacing and tags for raw (implicit and explicit
VR), RLE, JPEG Lossless (whole and fragmented frames) and JPEG-LS
(lossless and near-lossless) series of 8- and 16-bit pixels; both refuse a
multi-frame file and a JPEG-baseline file alike; the encoders give the
same bytes and the Python and native decoders the same pixels over seeded
fuzz at precisions 2-16; the native decoders decode every frame of a
well-formed series (native_lib.CALLS) and the fallback to the Python
decoder is counted (native_lib.FALLBACKS). The DICOM files are built here
byte by byte."""
import gzip
import os
import struct

import numpy as np
import pytest

from ife_tpu.io import dicom as JD, jpegll as JLL, jpegls as JLS
from ife_tpu_torch import native_lib as N
from ife_tpu_torch.io import dicom as TD, jpegll as TLL, jpegls as TLS

EXPLICIT = "1.2.840.10008.1.2.1"
IMPLICIT = "1.2.840.10008.1.2"
RLE = "1.2.840.10008.1.2.5"
JPEG_LL = "1.2.840.10008.1.2.4.70"
JPEG_LS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
_LONG = (b"OB", b"OW", b"SQ", b"UT", b"UN", b"OF")


@pytest.fixture(autouse=True)
def _counts():
    N.reset_counts()
    yield


def _elem(group, el, vr, value: bytes, explicit=True):
    if len(value) % 2:
        value += b"\x00" if vr in (b"OB", b"OW", b"UI") else b" "
    if not explicit:
        return struct.pack("<HHI", group, el, len(value)) + value
    if vr in _LONG:
        return struct.pack("<HH2sHI", group, el, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, el, vr, len(value)) + value


def _encapsulated(fragments):
    """Encapsulated PixelData: an empty Basic Offset Table item, one item
    per fragment, the sequence delimiter."""
    items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
    for f in fragments:
        if len(f) % 2:
            f += b"\x00"
        items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f)
    items.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return (struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
            + b"".join(items))


def _rle_segment(data: bytes) -> bytes:
    """PackBits with literal runs of <= 128 bytes, and one replicate run
    where 3+ bytes repeat (valid, if not maximally compressed)."""
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        chunk = data[i:i + 128]
        out.append(len(chunk) - 1)
        out += chunk
        i += len(chunk)
    return bytes(out)


def _rle_frame(pix: np.ndarray, bits: int) -> bytes:
    u = pix.reshape(-1).view(np.uint8 if bits == 8 else np.uint16)
    planes = [u.astype(np.uint8)] if bits == 8 else [
        ((u >> 8) & 0xFF).astype(np.uint8), (u & 0xFF).astype(np.uint8)]
    segs = [_rle_segment(p.tobytes()) for p in planes]
    segs = [s + b"\x00" if len(s) % 2 else s for s in segs]
    offsets, pos = [], 64
    for s in segs:
        offsets.append(pos)
        pos += len(s)
    header = struct.pack("<16I", len(segs), *offsets,
                         *([0] * (15 - len(segs))))
    return header + b"".join(segs)


def dicom_file(ts, pix, z, *, uid=b"1.2.3.4", patient=b"PAT1", near=0,
               fragments=1, frames=None, sof_pix=None, explicit=True):
    """One slice of a series as the bytes of a DICOM file. `pix` is the
    (rows, cols) int8/uint8/int16/uint16 stored image; `sof_pix` an image
    of other dims to encode instead (a frame whose SOF differs from the
    tags)."""
    rows, cols = pix.shape
    bits = pix.dtype.itemsize * 8
    signed = pix.dtype.kind == "i"
    unsigned = (sof_pix if sof_pix is not None else pix).view(
        np.uint8 if bits == 8 else np.uint16)
    if ts in (EXPLICIT, IMPLICIT):
        pixel = _elem(0x7FE0, 0x0010, b"OW", pix.tobytes(), explicit)
    else:
        if ts == RLE:
            frame = _rle_frame(pix, bits)
        elif ts == JPEG_LL:
            frame = TLL.encode_jpeg_lossless(unsigned, precision=bits)
        elif ts == JPEG_BASELINE:
            frame = b"\xff\xd8\xff\xc0\x00\x0b\x08\x00\x01\x00\x01\x01\x01" \
                    b"\x11\x00\xff\xd9"
        else:
            frame = TLS.encode_jpegls(unsigned, precision=bits, near=near)
        cuts = np.linspace(0, len(frame), fragments + 1).astype(int) & ~1
        cuts[-1] = len(frame)
        pixel = _encapsulated([frame[a:b] for a, b in zip(cuts, cuts[1:])])
    e = lambda g, el, vr, v: _elem(g, el, vr, v, explicit)  # noqa: E731
    body = [
        e(0x0008, 0x0020, b"DA", b"20260817"),
        e(0x0010, 0x0020, b"LO", patient),
        e(0x0018, 0x0050, b"DS", b"2.5"),
        e(0x0018, 0x1210, b"SH", b"B30f"),
        e(0x0020, 0x000E, b"UI", uid),
        e(0x0020, 0x0032, b"DS", f"-10\\-20.5\\{z:g}".encode()),
    ]
    if frames is not None:
        body.append(e(0x0028, 0x0008, b"IS", str(frames).encode()))
    body += [
        e(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        e(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        e(0x0028, 0x0030, b"DS", b"0.7\\0.65"),
        e(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        e(0x0028, 0x0103, b"US", struct.pack("<H", int(signed))),
        e(0x0028, 0x1052, b"DS", b"-1024" if signed else b"-7.5"),
        e(0x0028, 0x1053, b"DS", b"1" if signed else b"0.5"),
        pixel,
    ]
    meta = _elem(0x0002, 0x0010, b"UI", ts.encode())
    return b"\x00" * 128 + b"DICM" + meta + b"".join(body)


def ct_slice(rng, shape, dtype):
    """A CT-like stored image: a body of noisy tissue in air, flat runs at
    the border (JPEG-LS run mode)."""
    rows, cols = shape
    info = np.iinfo(dtype)
    lo, hi = (0, 2000) if info.bits == 16 else (0, 200)
    img = np.full(shape, lo, np.int64)
    y, x = np.ogrid[:rows, :cols]
    body = ((y - rows / 2) / (0.4 * rows)) ** 2 + (
        (x - cols / 2) / (0.45 * cols)) ** 2 <= 1
    img[body] = rng.integers(hi // 3, hi, int(body.sum()))
    if info.min < 0:
        img -= hi // 2
    return img.clip(info.min, info.max).astype(dtype)


CASES = {
    # name: (transfer syntax, dtype, extra dicom_file arguments)
    "explicit_i16": (EXPLICIT, np.int16, {}),
    "implicit_i16": (IMPLICIT, np.int16, {"explicit": False}),
    "explicit_u16": (EXPLICIT, np.uint16, {}),
    "explicit_u8": (EXPLICIT, np.uint8, {}),
    "rle_i16": (RLE, np.int16, {}),
    "rle_u8": (RLE, np.uint8, {}),
    "jll_i16": (JPEG_LL, np.int16, {}),
    "jll_i16_fragmented": (JPEG_LL, np.int16, {"fragments": 3}),
    "jll_u16": (JPEG_LL, np.uint16, {}),
    "jll_u8": (JPEG_LL, np.uint8, {}),
    "jls_i16": (JPEG_LS, np.int16, {}),
    "jls_i16_fragmented": (JPEG_LS, np.int16, {"fragments": 2}),
    "jls_u8": (JPEG_LS, np.uint8, {}),
    "jls_near_i16": (JPEG_LS_NEAR, np.int16, {"near": 3}),
}


def _series_dir(tmp_path, name, n=3, shape=(11, 7)):
    ts, dtype, kw = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    d = tmp_path / name
    d.mkdir()
    pix = [ct_slice(rng, shape, dtype) for _ in range(n)]
    zs = [5.0 - 2.5 * i for i in range(n)]  # files in descending z
    for i, (p, z) in enumerate(zip(pix, zs)):
        (d / f"s{i:02d}.dcm").write_bytes(dicom_file(ts, p, z, **kw))
    return d, pix[::-1], kw.get("near", 0)


def _gz(path):
    with open(path, "rb") as f:
        return gzip.decompress(f.read())


@pytest.mark.parametrize("name", sorted(CASES))
def test_series_equal_ife_tpu(tmp_path, name):
    d, pix, near = _series_dir(tmp_path, name)
    paths = sorted(str(d / f) for f in os.listdir(d))
    vol, tags = TD.read_dicom_series(paths)
    jvol, jtags = JD.read_dicom_series(paths)
    got = vol.numpy()
    assert got.dtype == np.float32 and got.shape == (7, 11, 3)
    np.testing.assert_array_equal(got, np.asarray(jvol.data))
    assert vol.spacing == jvol.spacing == pytest.approx((0.65, 0.7, 2.5))
    assert vol.origin == tuple(float(v) for v in jvol.origin)
    assert tags == jtags
    signed = pix[0].dtype.kind == "i"
    slope, inter = (1.0, -1024.0) if signed else (0.5, -7.5)
    want = np.stack([p.astype(np.float32) * slope + inter for p in pix]
                    ).transpose(2, 1, 0)
    if near:
        assert np.abs(got - want).max() <= near * slope
    else:
        np.testing.assert_array_equal(got, want)
    ts = CASES[name][0]
    jpeg = {JPEG_LL: "jll_decode", JPEG_LS: "jls_decode",
            JPEG_LS_NEAR: "jls_decode"}.get(ts)
    assert N.CALLS["jll_decode"] == (3 if jpeg == "jll_decode" else 0)
    assert N.CALLS["jls_decode"] == (3 if jpeg == "jls_decode" else 0)
    assert N.FALLBACKS == {"jll_decode": 0, "jls_decode": 0}


@pytest.mark.parametrize("name", ["explicit_i16", "rle_i16", "jll_i16",
                                  "jls_near_i16"])
def test_convert_dicom_dir_equals_ife_tpu(tmp_path, name):
    d, _, _ = _series_dir(tmp_path, name)
    # a second series (another uid) in a subdirectory
    sub = d / "sub"
    sub.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        (sub / f"t{i}.dcm").write_bytes(dicom_file(
            EXPLICIT, ct_slice(rng, (6, 9), np.int16), 1.5 * i,
            uid=b"1.2.3.5", patient=b"PAT 2/b"))
    (d / "notes.txt").write_text("not DICOM")
    got = TD.convert_dicom_dir(str(d), str(tmp_path / "t"))
    want = JD.convert_dicom_dir(str(d), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        "PAT1_20260817_B30f_2.5.nii.gz", "PAT-2-b_20260817_B30f_1.5.nii.gz"]
    for a, b in zip(got, want):
        assert _gz(a) == _gz(b)


def test_multi_frame_file_is_refused_alike(tmp_path):
    rng = np.random.default_rng(0)
    p = tmp_path / "mf.dcm"
    p.write_bytes(dicom_file(JPEG_LL, ct_slice(rng, (5, 4), np.int16), 0.0,
                             frames=2))
    for mod in (TD, JD):
        with pytest.raises(ValueError, match="multi-frame") as e:
            mod.read_dicom_series([str(p)])
        with pytest.raises(ValueError, match="multi-frame") as e2:
            mod.convert_dicom_dir(str(tmp_path), str(tmp_path / "out"))
        assert str(e.value) == str(e2.value)
    assert N.CALLS["jll_decode"] == 0


@pytest.mark.parametrize("bad_uid", [b"1.2.3.1", b"1.2.3.9"])
def test_a_failing_series_among_others_raises_alike(tmp_path, bad_uid):
    # a series that fails stops the run as in ife_tpu: the series before
    # it in uid order are written, none after it
    rng = np.random.default_rng(4)
    for i in range(2):
        (tmp_path / f"ok{i}.dcm").write_bytes(dicom_file(
            JPEG_LS, ct_slice(rng, (6, 5), np.int16), 2.0 * i,
            uid=b"1.2.3.5"))
    (tmp_path / "mf.dcm").write_bytes(dicom_file(
        JPEG_LL, ct_slice(rng, (6, 5), np.int16), 0.0, frames=3, uid=bad_uid))
    written = []
    for mod, out in ((TD, "t"), (JD, "j")):
        with pytest.raises(ValueError, match="NumberOfFrames=3"):
            mod.convert_dicom_dir(str(tmp_path), str(tmp_path / out))
        written.append(sorted(os.listdir(tmp_path / out)))
    assert written[0] == written[1]
    assert len(written[0]) == (bad_uid > b"1.2.3.5")


def test_jpeg_baseline_file_is_refused_alike(tmp_path):
    rng = np.random.default_rng(1)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "b.dcm").write_bytes(dicom_file(
        JPEG_BASELINE, ct_slice(rng, (5, 4), np.int16), 0.0))
    msgs = []
    for mod in (TD, JD):
        with pytest.raises(ValueError, match="unsupported transfer syntax "
                           + JPEG_BASELINE.replace(".", r"\.")) as e:
            mod.read_dicom_file(str(bad / "b.dcm"))
        msgs.append(str(e.value))
        # convert_dicom_dir skips the file; with nothing else, it refuses
        with pytest.raises(ValueError, match="no DICOM series found"):
            mod.convert_dicom_dir(str(bad), str(tmp_path / "out"))
    assert msgs[0] == msgs[1] and "supported:" in msgs[0]
    # beside a readable series the baseline file is skipped alike
    (bad / "ok.dcm").write_bytes(dicom_file(
        EXPLICIT, ct_slice(rng, (5, 4), np.int16), 0.0))
    got = TD.convert_dicom_dir(str(bad), str(tmp_path / "t"))
    want = JD.convert_dicom_dir(str(bad), str(tmp_path / "j"))
    assert len(got) == 1 and _gz(got[0]) == _gz(want[0])
    assert TD.SUPPORTED_SYNTAXES == JD.SUPPORTED_SYNTAXES


@pytest.mark.parametrize("ts,counter", [(JPEG_LL, "jll_decode"),
                                        (JPEG_LS, "jls_decode")])
def test_frame_dims_other_than_the_tags_fall_back_counted(tmp_path, ts,
                                                          counter):
    # a frame larger than the Rows / Columns tags: the native decoders
    # refuse it (rc -7), the Python decoders decode it and the reader
    # crops, in both packages alike
    rng = np.random.default_rng(2)
    big = ct_slice(rng, (9, 8), np.int16)
    p = tmp_path / "x.dcm"
    p.write_bytes(dicom_file(ts, big[:7, :6], 0.0, sof_pix=big))
    vol, _ = TD.read_dicom_series([str(p)])
    jvol, _ = JD.read_dicom_series([str(p)])
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jvol.data))
    np.testing.assert_array_equal(vol.numpy()[..., 0],
                                  big[:7, :6].T.astype(np.float32) - 1024)
    assert N.FALLBACKS[counter] == 1 and N.CALLS[counter] == 0


def test_packbits_and_rle_frames_equal_ife_tpu():
    rng = np.random.default_rng(3)
    for n in (1, 127, 128, 129, 1000):
        data = bytes(rng.integers(0, 4, n).astype(np.uint8))
        seg = _rle_segment(data)
        assert TD._packbits_decode(seg, n) == JD._packbits_decode(seg, n) == data
        with pytest.raises(ValueError, match="truncated"):
            TD._packbits_decode(seg, n + 1)
    pix = ct_slice(rng, (6, 5), np.int16)
    frame = _rle_frame(pix, 16)
    for signed in (True, False):
        got = TD._rle_decode_frame(frame, 30, 16, signed)
        np.testing.assert_array_equal(got, JD._rle_decode_frame(frame, 30, 16,
                                                                signed))
        assert got.dtype == (np.int16 if signed else np.uint16)


def _fuzz_image(precision, shape=(9, 13), seed=0):
    rng = np.random.default_rng(seed + precision)
    img = rng.integers(0, 1 << precision, shape, dtype=np.int64)
    img[2:5, 3:9] = rng.integers(0, 1 << precision)  # a flat patch
    img[-1] = img[-1, 0]                             # a flat last row
    return img.astype(np.uint16)


@pytest.mark.parametrize("precision", range(2, 17))
def test_jpeg_lossless_codec_equals_ife_tpu(precision):
    img = _fuzz_image(precision)
    enc = TLL.encode_jpeg_lossless(img, precision=precision)
    assert enc == JLL.encode_jpeg_lossless(img, precision=precision)
    assert TLL.encode_jpeg_lossless(img) == JLL.encode_jpeg_lossless(img)
    py = TLL.decode_jpeg_lossless(enc)
    np.testing.assert_array_equal(py, JLL.decode_jpeg_lossless(enc))
    np.testing.assert_array_equal(py, img)
    fast = TLL.decode_jpeg_lossless_fast(enc, *img.shape)
    np.testing.assert_array_equal(
        fast, JLL.decode_jpeg_lossless_fast(enc, *img.shape))
    np.testing.assert_array_equal(fast, img)
    assert fast.dtype == py.dtype == np.uint16
    assert N.CALLS["jll_decode"] == 1 and N.FALLBACKS["jll_decode"] == 0


@pytest.mark.parametrize("precision,near", [(p, 0) for p in range(2, 17)]
                         + [(2, 1), (5, 2), (8, 1), (12, 3), (16, 7)])
def test_jpegls_codec_equals_ife_tpu(precision, near):
    img = _fuzz_image(precision, seed=100)
    enc = TLS.encode_jpegls(img, precision=precision, near=near)
    assert enc == JLS.encode_jpegls(img, precision=precision, near=near)
    if near == 0:
        assert TLS.encode_jpegls(img) == JLS.encode_jpegls(img)
    py = TLS.decode_jpegls(enc)
    np.testing.assert_array_equal(py, JLS.decode_jpegls(enc))
    assert py.dtype == JLS.decode_jpegls(enc).dtype
    assert np.abs(py.astype(np.int64) - img).max() <= near
    fast = TLS.decode_jpegls_fast(enc, *img.shape)
    np.testing.assert_array_equal(fast,
                                  JLS.decode_jpegls_fast(enc, *img.shape))
    np.testing.assert_array_equal(fast, py)
    assert N.CALLS["jls_decode"] == 1 and N.FALLBACKS["jls_decode"] == 0


@pytest.mark.parametrize("stream", [b"", b"\x00\x00\x00\x00",
                                    b"\xff\xd8\xff\xd9"])
def test_codecs_refuse_a_malformed_stream_alike(stream):
    for t, j in ((TLL.decode_jpeg_lossless, JLL.decode_jpeg_lossless),
                 (TLS.decode_jpegls, JLS.decode_jpegls)):
        with pytest.raises(ValueError) as a:
            t(stream)
        with pytest.raises(ValueError) as b:
            j(stream)
        assert str(a.value) == str(b.value)
    # the fast decoders: the native decoder refuses (counted), then the
    # Python decoder raises its own error
    with pytest.raises(ValueError):
        TLL.decode_jpeg_lossless_fast(stream, 2, 2)
    with pytest.raises(ValueError):
        TLS.decode_jpegls_fast(stream, 2, 2)
    assert N.FALLBACKS == {"jll_decode": 1, "jls_decode": 1}


# chip_smoke.py's dicom phase: the series it builds, converted on the CPU,
# and the two sizes it converts (the default run's and --dicom's)

@pytest.mark.parametrize("shape", [(64, 64, 6), (48, 40, 9)])
def test_chip_smoke_series_convert_to_the_expected_volume(tmp_path,
                                                         monkeypatch, shape):
    monkeypatch.setenv("IFE_PLATFORM", "cpu")
    import chip_smoke as C
    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.io import read_volume

    src, out = tmp_path / "dcm", tmp_path / "nii"
    stored, _, _ = C.write_dicom_dir(str(src), shape, C.DICOM_DISTINCT)
    assert main(["convert-dicom", "-d", str(src), "-o", str(out)]) == 0
    assert N.CALLS["jll_decode"] == N.CALLS["jls_decode"] == shape[2]
    assert N.FALLBACKS == {"jll_decode": 0, "jls_decode": 0}
    assert sorted(os.listdir(out)) == sorted(
        C.dicom_file_name(p) for p, _ in C.DICOM_SERIES)
    want = C.dicom_expected_volume(stored, shape[2])
    assert want.shape == (shape[1], shape[0], shape[2])
    for patient, _ in C.DICOM_SERIES:
        vol = read_volume(str(out / C.dicom_file_name(patient)))
        got = vol.numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert vol.spacing == tuple(float(np.float32(s))
                                    for s in (0.7, 0.7, 1.25))


def test_chip_smoke_converts_its_two_dicom_sizes(monkeypatch, capsys):
    # main with every phase up to dicom stubbed: the default run converts
    # DICOM_SMOKE_SHAPE, --dicom DICOM_SHAPE, both of 512^2 slices; --dicom's
    # [budget] line prints without a card and leaves the exit code 0
    import sys

    import chip_smoke as C

    assert C.DICOM_SHAPE == (512, 512, 128)
    assert C.DICOM_SMOKE_SHAPE == (512, 512, 32)
    seen = []

    def dicom(tmp, shape, make_bag_s, binning):
        seen.append(shape)
        if sys.argv[1:] != ["--dicom"]:
            raise C.PhaseError("stopped after the dicom phase")
        return {}

    for name, value in (("phase_device", None), ("phase_build", None),
                        ("phase_kernels", None), ("phase_main", (0, 0, 0)),
                        ("phase_bags", (0, 0, 0)), ("phase_tools", None)):
        monkeypatch.setattr(C, name, lambda *a, v=value: v)
    monkeypatch.setattr(C, "phase_dicom", dicom)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--dicom"])
    assert C.main() == 0
    budget = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("[budget] ")]
    assert len(budget) == 1 and "| dicom " in budget[0]
    assert " | total " in budget[0]
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert C.main() == 1
    assert "phase dicom failed" in capsys.readouterr().err
    assert seen == [C.DICOM_SHAPE, C.DICOM_SMOKE_SHAPE]
    assert all(s[:2] == (512, 512) for s in seen)
