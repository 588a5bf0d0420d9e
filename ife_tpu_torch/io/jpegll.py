"""JPEG Lossless (process 14) codec — the DICOM transfer syntax
1.2.840.10008.1.2.4.70 (JPEG Lossless, Nonhierarchical, First-Order
Prediction: selection value 1), the most common compressed CT archive
syntax. The reference reads it through ITK's GDCM
(tools/ConvertDICOM.cxx:70-84); this is a from-scratch, dependency-free
implementation (ITU-T T.81 Annex H) so ConvertDICOM covers the same
archives. A copy of ife_tpu/io/jpegll.py whose fast decoder runs the
port's native library (ife_tpu_torch/native_lib.py).

Decoder accepts any selection value 1-7 and 2-16 bit precision,
single-component (monochrome — what CT is) scans, with the standard
predictor rules (T.81 H.1.2.1):
  * first sample of the image: 2^(P - Pt - 1)
  * first sample of every other line: Rb (the sample above)
  * remaining samples of the first line: Ra (the sample to the left)
  * elsewhere: the SOS selection-value predictor (1 -> Ra, 2 -> Rb,
    3 -> Rc, 4 -> Ra+Rb-Rc, 5 -> Ra+(Rb-Rc)/2, 6 -> Rb+(Ra-Rc)/2,
    7 -> (Ra+Rb)/2)
Differences are Huffman-coded magnitude categories (SSSS 0-16) with
SSSS appended raw bits, extended exactly like DC coefficients (T.81
F.2.2.1), arithmetic modulo 2^16. The entropy stream is byte-stuffed
(FF 00 -> literal FF).

The encoder (selection value 1, default Huffman table built from the
image's own category histogram) exists so round-trip tests need no
binary fixtures; it emits a fully standard SOI/DHT/SOF3/SOS/EOI stream.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# markers
_SOI = 0xFFD8
_EOI = 0xFFD9
_SOF3 = 0xFFC3
_DHT = 0xFFC4
_SOS = 0xFFDA


class _BitReader:
    """MSB-first bit reader over a byte-stuffed entropy segment."""

    def __init__(self, data: bytes):
        # un-stuff once up front: FF 00 -> FF; a marker (FF xx, xx != 0)
        # ends the entropy-coded segment
        out = bytearray()
        i, n = 0, len(data)
        while i < n:
            b = data[i]
            out.append(b)
            i += 1
            if b == 0xFF:
                if i < n and data[i] == 0x00:
                    i += 1  # stuffed zero
                else:
                    out.pop()  # marker reached: not entropy data
                    break
        self.buf = bytes(out)
        self.pos = 0       # bit position
        self.nbits = 8 * len(self.buf)

    def read_bit(self) -> int:
        if self.pos >= self.nbits:
            # past the end: T.81 decoders pad with 1-bits
            return 1
        byte = self.buf[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read_bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.read_bit()
        return v


def _build_huffman(bits: List[int], values: List[int]) -> Dict[Tuple[int, int], int]:
    """(length, code) -> value map from the DHT BITS/HUFFVAL lists
    (T.81 Annex C code assignment)."""
    table: Dict[Tuple[int, int], int] = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[(length, code)] = values[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _decode_huffman(br: _BitReader, table: Dict[Tuple[int, int], int]) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.read_bit()
        v = table.get((length, code))
        if v is not None:
            return v
    raise ValueError("invalid Huffman code in JPEG lossless stream")


def _extend(v: int, ssss: int) -> int:
    """T.81 F.2.2.1 EXTEND: map the SSSS raw bits to a signed difference."""
    if ssss == 0:
        return 0
    if v < (1 << (ssss - 1)):
        return v - (1 << ssss) + 1
    return v


def decode_jpeg_lossless(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG Lossless (SOF3) stream.

    Returns a (rows, cols) uint16 array of the raw stored values (the
    caller applies PixelRepresentation / rescale semantics).
    """
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != _SOI:
        raise ValueError("not a JPEG stream (missing SOI)")
    pos = 2
    htables: Dict[int, Dict[Tuple[int, int], int]] = {}
    precision = rows = cols = 0
    ncomp = 0
    predictor = 1
    pt = 0

    while pos + 4 <= len(data):
        marker = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        if marker == _EOI:
            break
        if not (0xFFC0 <= marker <= 0xFFFE):
            raise ValueError(f"bad JPEG marker {marker:#x}")
        seglen = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2 : pos + seglen]
        if marker == _SOF3:
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp != 1:
                raise ValueError(
                    f"only single-component (monochrome) JPEG lossless is "
                    f"supported, got {ncomp} components"
                )
        elif marker in (0xFFC0, 0xFFC1, 0xFFC2, 0xFFC5, 0xFFC6, 0xFFC7,
                        0xFFC9, 0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF):
            raise ValueError(
                "not a lossless (SOF3) JPEG — only JPEG Lossless "
                "(process 14) is supported"
            )
        elif marker == _DHT:
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                bits = list(seg[p + 1 : p + 17])
                nv = sum(bits)
                values = list(seg[p + 17 : p + 17 + nv])
                # lossless scans use DC-class (Tc=0) tables only; an
                # AC-class table with the same id must NOT overwrite the
                # DC table the scan references (T.81 B.2.4.2)
                if (tc_th >> 4) == 0:
                    htables[tc_th & 0x0F] = _build_huffman(bits, values)
                p += 17 + nv
        elif marker == _SOS:
            ns = seg[0]
            if ns != 1:
                raise ValueError("only single-component scans are supported")
            td = seg[2] >> 4  # component 0's DC (lossless) table id
            if td not in htables:
                raise ValueError(
                    f"SOS references undefined Huffman table {td}"
                )
            predictor = seg[1 + 2 * ns]       # Ss = selection value
            pt = seg[3 + 2 * ns] & 0x0F       # Al = point transform
            pos += seglen
            return _decode_scan(
                data[pos:], htables[td], precision, rows, cols, predictor, pt
            )
        pos += seglen
    raise ValueError("no SOS scan found in JPEG stream")


def _decode_scan(entropy: bytes, table, precision: int, rows: int, cols: int,
                 predictor: int, pt: int) -> np.ndarray:
    br = _BitReader(entropy)
    out = np.empty((rows, cols), dtype=np.uint16)
    mask = 0xFFFF
    default = 1 << (precision - pt - 1)

    read_bits = br.read_bits
    decode = _decode_huffman
    for r in range(rows):
        row = out[r]
        above = out[r - 1] if r else None
        for c in range(cols):
            ssss = decode(br, table)
            if ssss == 16:
                diff = 32768
            else:
                diff = _extend(read_bits(ssss), ssss) if ssss else 0
            if r == 0 and c == 0:
                px = default
            elif r == 0:
                px = row[c - 1]
            elif c == 0:
                px = above[c]
            else:
                ra = int(row[c - 1])
                rb = int(above[c])
                if predictor == 1:
                    px = ra
                elif predictor == 2:
                    px = rb
                elif predictor == 3:
                    px = above[c - 1]
                elif predictor == 4:
                    px = ra + rb - int(above[c - 1])
                elif predictor == 5:
                    px = ra + ((rb - int(above[c - 1])) >> 1)
                elif predictor == 6:
                    px = rb + ((ra - int(above[c - 1])) >> 1)
                elif predictor == 7:
                    px = (ra + rb) >> 1
                else:
                    raise ValueError(f"bad selection value {predictor}")
            row[c] = (int(px) + diff) & mask
    if pt:
        out <<= pt
    return out


def decode_jpeg_lossless_fast(data: bytes, rows: int, cols: int
                              ) -> np.ndarray:
    """decode_jpeg_lossless through the native C++ decoder
    (native/ife_native.cpp ife_jll_decode, the same algorithm: milliseconds
    instead of ~1-2 s per CT slice). rows/cols must match the SOF3 frame
    header (the DICOM caller knows them). A stream the native decoder
    refuses (a native-only limit, e.g. SOF dims that differ from the tags,
    rc -7) goes to the Python decoder, counted in
    native_lib.FALLBACKS["jll_decode"]; a truly malformed stream raises the
    Python decoder's own error. A library that cannot be built raises."""
    from ife_tpu_torch import native_lib

    try:
        return native_lib.jll_decode_native(data, rows, cols)
    except ValueError:
        native_lib.count(native_lib.FALLBACKS, "jll_decode")
    return decode_jpeg_lossless(data)


# ---------------------------------------------------------------------------
# encoder (selection value 1) — for round-trip tests and completeness
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.acc = 0
                self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.acc <<= 8 - self.n
            self.acc |= (1 << (8 - self.n)) - 1  # pad with 1-bits
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.n = 0
        return bytes(self.out)


def _category(diff: int) -> int:
    """SSSS magnitude category of a difference (T.81 H.1.2.2)."""
    if diff == 32768:
        return 16
    a = abs(diff)
    s = 0
    while a:
        a >>= 1
        s += 1
    return s


def _diffs_sv1(img: np.ndarray, precision: int) -> np.ndarray:
    """Selection-value-1 difference plane (int32, modulo-2^16 wrapped to
    the symmetric representative used for coding)."""
    x = img.astype(np.int64)
    pred = np.empty_like(x)
    pred[0, 0] = 1 << (precision - 1)
    pred[0, 1:] = x[0, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[1:, 1:] = x[1:, :-1]
    d = (x - pred) & 0xFFFF
    # wrap to (-32768, 32768]: 32768 stays (category 16, no extra bits)
    d = np.where(d > 32768, d - 65536, d)
    return d.astype(np.int32)


def encode_jpeg_lossless(img: np.ndarray, precision: int | None = None
                         ) -> bytes:
    """Encode a (rows, cols) unsigned array as JPEG Lossless, selection
    value 1, one component, Huffman table derived from the image."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2D single-component image")
    if precision is None:
        precision = max(2, int(img.max()).bit_length())
    if precision > 16:
        raise ValueError("precision > 16 is not representable")
    rows, cols = img.shape
    d = _diffs_sv1(img, precision)
    cats = np.vectorize(_category, otypes=[np.int32])(d)

    # Huffman table from the category histogram (canonical, by frequency;
    # a simple length assignment: more frequent -> shorter, lengths grown
    # until Kraft-feasible)
    hist = np.bincount(cats.reshape(-1), minlength=17)
    syms = [s for s in np.argsort(-hist) if hist[s] > 0]
    # start everyone at ceil(log2(len)) bits and grow the tail until the
    # Kraft sum fits; max length 16
    lengths = {}
    base = max(1, (len(syms) - 1).bit_length())
    for i, s in enumerate(syms):
        lengths[s] = min(16, base + (0 if i < (1 << base) - 1 else 1))
    # ensure prefix-feasibility (sum 2^-L <= 1, with no all-ones code of
    # max length per JPEG convention: keep strict < 1 by bumping base)
    while sum(2.0 ** -L for L in lengths.values()) >= 1.0:
        for s in list(lengths):
            if lengths[s] < 16:
                lengths[s] += 1
    bits = [0] * 16
    for s in syms:
        bits[lengths[s] - 1] += 1
    values = sorted(syms, key=lambda s: (lengths[s], s))
    table = _build_huffman(bits, values)
    codes = {v: (L, c) for (L, c), v in table.items()}

    bw = _BitWriter()
    it = np.nditer(d, order="C")
    for diff in it:
        diff = int(diff)
        ssss = _category(diff)
        L, c = codes[ssss]
        bw.write(c, L)
        if 0 < ssss < 16:
            v = diff if diff >= 0 else diff + (1 << ssss) - 1
            bw.write(v & ((1 << ssss) - 1), ssss)
    entropy = bw.flush()

    out = bytearray()
    out += struct.pack(">H", _SOI)
    dht = bytes([0x00]) + bytes(bits) + bytes(values)
    out += struct.pack(">HH", _DHT, 2 + len(dht)) + dht
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes(
        [0x00, 0x11, 0x00])  # id 0, 1x1 sampling, tq 0
    out += struct.pack(">HH", _SOF3, 2 + len(sof)) + sof
    sos = bytes([1, 0x00, 0x00, 1, 0, 0x00])  # ns=1, comp 0/table 0, Ss=1
    out += struct.pack(">HH", _SOS, 2 + len(sos)) + sos
    out += entropy
    out += struct.pack(">H", _EOI)
    return bytes(out)
