"""JPEG-LS (ITU-T T.87, LOCO-I) codec from scratch — single-component.

Closes the last common compressed CT transfer syntaxes the reference's
GDCM path reads (tools/ConvertDICOM.cxx:70-84): DICOM
1.2.840.10008.1.2.4.80 (JPEG-LS Lossless) and ...4.81 (JPEG-LS
near-lossless). JPEG 2000 remains scoped out with a clean error in
io/dicom.py (a full wavelet/EBCOT codec is out of scope). A copy of
ife_tpu/io/jpegls.py, as it is, whose fast decoder runs the port's native
library (ife_tpu_torch/native_lib.py).

Scope: single-component (monochrome) scans, 2-16 bit, ILV=0, NEAR >= 0,
default or LSE-preset thresholds. Both directions are implemented — the
encoder exists so round-trip tests and DICOM fixtures can be built in an
environment with no JPEG-LS reference data (zero egress); the context
modeling, Golomb parameterization, run mode, and bit-stuffing follow
T.87 A.1-A.7 exactly as written so real archives decode too.

Algorithm summary (T.87):
  * causal template a (left), b (above), c (above-left), d (above-right)
    with the edge rules of A.2.1 (virtual zero line above row 0,
    Ra(col 0) = Rb, Rc(col 0) = Ra at the start of the previous line);
  * gradients D1-D3 quantized by thresholds T1/T2/T3 into 365 regular
    contexts with sign folding (A.3.3);
  * median-edge-detector prediction + per-context bias correction C[Q]
    (A.4.2), Golomb-Rice coding with the limited-length escape (A.5.3),
    context state A/B/C/N with RESET halving (A.6);
  * run mode on the flat context (A.7): J-table run-length segments,
    run-interruption samples on contexts 365/366.

Bitstream: MSB-first with the JPEG-LS marker-avoid rule — a byte
following 0xFF carries only 7 payload bits (its MSB is a stuffed 0).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_SOI = 0xFFD8
_EOI = 0xFFD9
_SOF55 = 0xFFF7
_LSE = 0xFFF8
_SOS = 0xFFDA

# run-length code order table (A.7.1.1)
_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_RESET_DEFAULT = 64
_MIN_C, _MAX_C = -128, 127


def _default_thresholds(maxval: int, near: int) -> Tuple[int, int, int]:
    """Default T1/T2/T3 (C.2.4.1.1.1)."""
    def clamp(i, j):
        return j if i > maxval or i < j else i

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _Params:
    def __init__(self, precision: int, near: int,
                 maxval: Optional[int] = None,
                 thresholds: Optional[Tuple[int, int, int]] = None,
                 reset: int = _RESET_DEFAULT):
        self.P = precision
        self.near = near
        self.maxval = (1 << precision) - 1 if maxval is None else maxval
        self.range = (self.maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        bpp = max(2, (self.maxval).bit_length())
        self.limit = 2 * (bpp + max(8, bpp))
        defaults = _default_thresholds(self.maxval, near)
        if thresholds is None:
            thresholds = (0, 0, 0)
        # per-field: a zero preset selects that field's default
        # (T.87 C.2.4.1.1)
        self.t1, self.t2, self.t3 = (
            t if t else d for t, d in zip(thresholds, defaults))
        self.reset = reset
        # context state (A.2.1 init): 365 regular + 2 run-interruption
        a_init = max(2, (self.range + 32) // 64)
        self.A = [a_init] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]  # negative counts for contexts 365/366

    def quantize_gradient(self, d: int) -> int:
        n = self.near
        if d <= -self.t3:
            return -4
        if d <= -self.t2:
            return -3
        if d <= -self.t1:
            return -2
        if d < -n:
            return -1
        if d <= n:
            return 0
        if d < self.t1:
            return 1
        if d < self.t2:
            return 2
        if d < self.t3:
            return 3
        return 4


def _predict(a: int, b: int, c: int) -> int:
    """Median edge detector (A.4.1)."""
    if c >= max(a, b):
        return min(a, b)
    if c <= min(a, b):
        return max(a, b)
    return a + b - c


class _BitWriter:
    """MSB-first bit writer with the 0xFF 7-bit stuffing rule."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0  # bits currently in acc
        self.cap = 8    # capacity of the byte being filled

    def _flush_byte(self):
        self.out.append(self.acc)
        self.cap = 7 if self.acc == 0xFF else 8
        self.acc = 0
        self.nbits = 0

    def put_bit(self, bit: int):
        self.acc = (self.acc << 1) | (bit & 1)
        self.nbits += 1
        if self.nbits == self.cap:
            self._flush_byte()

    def put_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put_bit((value >> i) & 1)

    def done(self) -> bytes:
        # pad the final partial byte with zeros
        while self.nbits:
            self.put_bit(0)
        return bytes(self.out)


class _BitReader:
    """MSB-first bit reader honoring the 0xFF stuffing rule."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                # trailing pad past the data: zeros (a conforming stream
                # never *needs* them; tolerate ragged padding)
                return 0
            byte = self.data[self.pos]
            self.pos += 1
            if self.prev_ff:
                self.acc = byte & 0x7F
                self.nbits = 7
            else:
                self.acc = byte
                self.nbits = 8
            self.prev_ff = byte == 0xFF
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


def _golomb_encode(bw: _BitWriter, merr: int, k: int, glimit: int,
                   qbpp: int):
    """Limited-length Golomb-Rice (A.5.3)."""
    high = merr >> k
    if high < glimit - qbpp - 1:
        for _ in range(high):
            bw.put_bit(0)
        bw.put_bit(1)
        if k:
            bw.put_bits(merr & ((1 << k) - 1), k)
    else:
        for _ in range(glimit - qbpp - 1):
            bw.put_bit(0)
        bw.put_bit(1)
        bw.put_bits(merr - 1, qbpp)


def _golomb_decode(br: _BitReader, k: int, glimit: int, qbpp: int) -> int:
    z = 0
    while br.read_bit() == 0:
        z += 1
        if z > glimit:  # corrupt stream guard
            raise ValueError("corrupt JPEG-LS stream (unary overrun)")
    if z < glimit - qbpp - 1:
        return (z << k) | (br.read_bits(k) if k else 0)
    return br.read_bits(qbpp) + 1


def _mod_range(errval: int, rng: int) -> int:
    if errval < 0:
        errval += rng
    if errval >= (rng + 1) // 2:
        errval -= rng
    return errval


def _clamp_c(v: int) -> int:
    return max(_MIN_C, min(_MAX_C, v))


def _context_neighbors(rec, i, j, w):
    """(a, b, c, d) with the edge rules of A.2.1."""
    if i == 0:
        b = c = d = 0
        a = 0 if j == 0 else int(rec[0][j - 1])
        if j == 0:
            a = b  # == 0
        return a, b, c, d
    b = int(rec[i - 1][j])
    d = int(rec[i - 1][j + 1]) if j + 1 < w else b
    if j == 0:
        a = b
        c = int(rec[i - 2][0]) if i >= 2 else 0
    else:
        a = int(rec[i][j - 1])
        c = int(rec[i - 1][j - 1])
    return a, b, c, d


def _regular_k(p: _Params, q: int) -> int:
    k = 0
    while (p.N[q] << k) < p.A[q]:
        k += 1
    return k


def _update_regular(p: _Params, q: int, errval: int):
    """A/B/N update + bias computation (A.6)."""
    p.B[q] += errval * (2 * p.near + 1)
    p.A[q] += abs(errval)
    if p.N[q] == p.reset:
        p.A[q] >>= 1
        p.B[q] = p.B[q] >> 1 if p.B[q] >= 0 else -((1 - p.B[q]) >> 1)
        p.N[q] >>= 1
    p.N[q] += 1
    if p.B[q] <= -p.N[q]:
        if p.C[q] > _MIN_C:
            p.C[q] -= 1
        p.B[q] += p.N[q]
        if p.B[q] <= -p.N[q]:
            p.B[q] = -p.N[q] + 1
    elif p.B[q] > 0:
        if p.C[q] < _MAX_C:
            p.C[q] += 1
        p.B[q] -= p.N[q]
        if p.B[q] > 0:
            p.B[q] = 0


def _ri_state(p: _Params, ritype: int):
    """(q, k) for a run-interruption sample (A.7.2.2)."""
    q = 365 + ritype
    temp = p.A[366] + (p.N[366] >> 1) if ritype else p.A[365]
    k = 0
    while (p.N[q] << k) < temp:
        k += 1
    return q, k


def _update_ri(p: _Params, q: int, errval: int, emerr: int, ritype: int):
    if errval < 0:
        p.Nn[q - 365] += 1
    p.A[q] += (emerr + 1 - ritype) >> 1
    if p.N[q] == p.reset:
        p.A[q] >>= 1
        p.N[q] >>= 1
        p.Nn[q - 365] >>= 1
    p.N[q] += 1


def _quantize_errval(p: _Params, errval: int) -> int:
    if p.near == 0:
        return errval
    if errval > 0:
        return (p.near + errval) // (2 * p.near + 1)
    return -((p.near - errval) // (2 * p.near + 1))


def _reconstruct(p: _Params, px: int, sign: int, errval: int) -> int:
    rx = px + sign * errval * (2 * p.near + 1)
    if rx < -p.near:
        rx += p.range * (2 * p.near + 1)
    elif rx > p.maxval + p.near:
        rx -= p.range * (2 * p.near + 1)
    return max(0, min(p.maxval, rx))


# ---------------------------------------------------------------------------
# scan codec
# ---------------------------------------------------------------------------

def _encode_scan(img: np.ndarray, p: _Params) -> bytes:
    h, w = img.shape
    bw = _BitWriter()
    rec = [[0] * w for _ in range(h)]
    src = img.astype(np.int64)
    for i in range(h):
        j = 0
        while j < w:
            a, b, c, d = _context_neighbors(rec, i, j, w)
            q1 = p.quantize_gradient(d - b)
            q2 = p.quantize_gradient(b - c)
            q3 = p.quantize_gradient(c - a)
            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode (A.7) ----
                run = 0
                jj = j
                while jj < w and abs(int(src[i][jj]) - a) <= p.near:
                    rec[i][jj] = a
                    run += 1
                    jj += 1
                runindex = getattr(p, "_runindex", 0)
                while run >= (1 << _J[runindex]):
                    bw.put_bit(1)
                    run -= 1 << _J[runindex]
                    if runindex < 31:
                        runindex += 1
                if jj >= w:
                    # run ended by the line end: one final 1 closes any
                    # partial segment (A.7.1.2)
                    if run > 0:
                        bw.put_bit(1)
                    p._runindex = runindex
                    j = jj
                    continue
                # interrupted: 0 + J[runindex]-bit remainder
                bw.put_bit(0)
                if _J[runindex]:
                    bw.put_bits(run, _J[runindex])
                # ---- run-interruption sample (A.7.2) ----
                x = int(src[i][jj])
                bri = int(rec[i - 1][jj]) if i > 0 else 0
                ritype = 1 if abs(a - bri) <= p.near else 0
                px = a if ritype else bri
                sign = -1 if (ritype == 0 and a > bri) else 1
                errval = _quantize_errval(p, sign * (x - px))
                rec[i][jj] = _reconstruct(p, px, sign, errval)
                errval = _mod_range(errval, p.range)
                q, k = _ri_state(p, ritype)
                if errval > 0:
                    mapbit = 1 if (k == 0
                                   and 2 * p.Nn[q - 365] < p.N[q]) else 0
                elif errval < 0:
                    mapbit = 1 if (2 * p.Nn[q - 365] >= p.N[q]
                                   or k != 0) else 0
                else:
                    mapbit = 0
                emerr = 2 * abs(errval) - ritype - mapbit
                glimit = p.limit - _J[runindex] - 1
                _golomb_encode(bw, emerr, k, glimit, p.qbpp)
                _update_ri(p, q, errval, emerr, ritype)
                if runindex > 0:
                    runindex -= 1
                p._runindex = runindex
                j = jj + 1
                continue
            # ---- regular mode (A.4-A.6) ----
            sign = -1 if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))) else 1
            q = abs(81 * q1 + 9 * q2 + q3)
            px = _predict(a, b, c)
            px = px + sign * p.C[q]
            px = max(0, min(p.maxval, px))
            x = int(src[i][j])
            errval = _quantize_errval(p, sign * (x - px))
            rec[i][j] = _reconstruct(p, px, sign, errval)
            errval = _mod_range(errval, p.range)
            k = _regular_k(p, q)
            if p.near == 0 and k == 0 and 2 * p.B[q] <= -p.N[q]:
                merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _golomb_encode(bw, merr, k, p.limit, p.qbpp)
            _update_regular(p, q, errval)
            j += 1
    return bw.done()


def _decode_scan(data: bytes, p: _Params, h: int, w: int) -> np.ndarray:
    br = _BitReader(data)
    rec = [[0] * w for _ in range(h)]
    for i in range(h):
        j = 0
        while j < w:
            a, b, c, d = _context_neighbors(rec, i, j, w)
            q1 = p.quantize_gradient(d - b)
            q2 = p.quantize_gradient(b - c)
            q3 = p.quantize_gradient(c - a)
            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode ----
                runindex = getattr(p, "_runindex", 0)
                end_of_line = False
                while br.read_bit() == 1:
                    n = 1 << _J[runindex]
                    take = min(n, w - j)
                    for t in range(take):
                        rec[i][j + t] = a
                    j += take
                    if take < n or j >= w:
                        # segment truncated by the line end, or filled
                        # exactly to it: the run ends with this line
                        end_of_line = True
                        if runindex < 31 and take == n:
                            runindex += 1
                        break
                    if runindex < 31:
                        runindex += 1
                if end_of_line:
                    p._runindex = runindex
                    continue
                r = br.read_bits(_J[runindex]) if _J[runindex] else 0
                if r > w - j:
                    raise ValueError("corrupt JPEG-LS stream (run overrun)")
                for t in range(r):
                    rec[i][j + t] = a
                j += r
                if j >= w:
                    raise ValueError(
                        "corrupt JPEG-LS stream (interruption past line)")
                # ---- run-interruption sample ----
                bri = int(rec[i - 1][j]) if i > 0 else 0
                ritype = 1 if abs(a - bri) <= p.near else 0
                px = a if ritype else bri
                sign = -1 if (ritype == 0 and a > bri) else 1
                q, k = _ri_state(p, ritype)
                glimit = p.limit - _J[runindex] - 1
                emerr = _golomb_decode(br, k, glimit, p.qbpp)
                s = emerr + ritype  # 2|e| - map
                if k == 0 and 2 * p.Nn[q - 365] < p.N[q]:
                    errval = (s + 1) // 2 if s % 2 else -(s // 2)
                else:
                    errval = s // 2 if s % 2 == 0 else -((s + 1) // 2)
                rec[i][j] = _reconstruct(p, px, sign, errval)
                _update_ri(p, q, errval, emerr, ritype)
                if runindex > 0:
                    runindex -= 1
                p._runindex = runindex
                j += 1
                continue
            # ---- regular mode ----
            sign = -1 if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))) else 1
            q = abs(81 * q1 + 9 * q2 + q3)
            px = _predict(a, b, c)
            px = max(0, min(p.maxval, px + sign * p.C[q]))
            k = _regular_k(p, q)
            merr = _golomb_decode(br, k, p.limit, p.qbpp)
            if p.near == 0 and k == 0 and 2 * p.B[q] <= -p.N[q]:
                errval = (merr - 1) // 2 if merr % 2 else -(merr // 2) - 1
            else:
                errval = merr // 2 if merr % 2 == 0 else -((merr + 1) // 2)
            errval = _mod_range(errval, p.range)
            rec[i][j] = _reconstruct(p, px, sign, errval)
            _update_regular(p, q, errval)
            j += 1
    return np.asarray(rec, dtype=np.uint16 if p.maxval > 255 else np.uint8)


# ---------------------------------------------------------------------------
# marker-level interface
# ---------------------------------------------------------------------------

def encode_jpegls(img: np.ndarray, precision: Optional[int] = None,
                  near: int = 0) -> bytes:
    """Encode one monochrome image as a JPEG-LS stream (SOI/SOF55/SOS,
    ILV=0). `near`=0 is lossless; `near`>0 bounds |decoded - original|
    by `near` per sample."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("JPEG-LS encoder takes a single 2D component")
    if precision is None:
        precision = max(2, int(img.max()).bit_length()) if img.size else 8
    if not 2 <= precision <= 16:
        raise ValueError(f"precision must be in [2, 16], got {precision}")
    h, w = img.shape
    p = _Params(precision, near)
    scan = _encode_scan(img, p)
    out = bytearray()
    out += struct.pack(">H", _SOI)
    out += struct.pack(">HHBHHB", _SOF55, 11, precision, h, w, 1)
    out += bytes([1, 0x11, 0])            # component id, 1x1 sampling, Tq
    out += struct.pack(">HHB", _SOS, 8, 1)
    out += bytes([1, 0])                  # component, mapping table 0
    out += bytes([near, 0, 0])            # NEAR, ILV=0, Al/Ah
    out += scan
    out += struct.pack(">H", _EOI)
    return bytes(out)


def decode_jpegls_fast(data: bytes, rows: int, cols: int) -> np.ndarray:
    """decode_jpegls through the native C++ decoder (native/ife_native.cpp,
    ~ms per CT slice vs ~0.5-2 s for the per-pixel Python path). A stream
    the native decoder refuses goes to the Python reference implementation,
    counted in native_lib.FALLBACKS["jls_decode"]: the native decoder's
    marker filter and frame-dimension check are slightly stricter than the
    Python parser (e.g. it rejects a skippable 0xFFCC segment, or a frame
    whose SOF55 dims differ from the DICOM tags, which the Python path
    handles via the [:rows, :cols] crop), and a stream the Python path
    decodes must keep decoding. A library that cannot be built raises."""
    from ife_tpu_torch import native_lib

    try:
        return native_lib.jls_decode_native(data, rows, cols)
    except ValueError:
        native_lib.count(native_lib.FALLBACKS, "jls_decode")
    return decode_jpegls(data)


def decode_jpegls(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-LS stream. Returns (rows, cols)
    uint8/uint16 (two's-complement reinterpretation of signed DICOM
    pixels is the caller's concern, as in io.jpegll)."""
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != _SOI:
        raise ValueError("not a JPEG-LS stream (missing SOI)")
    pos = 2
    precision = rows = cols = 0
    maxval = None
    thresholds = None
    reset = _RESET_DEFAULT
    while pos + 4 <= len(data):
        marker = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        if marker == _EOI:
            break
        if not (0xFFC0 <= marker <= 0xFFFE):
            raise ValueError(f"bad JPEG-LS marker {marker:#x}")
        seglen = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2 : pos + seglen]
        if marker == _SOF55:
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp != 1:
                raise ValueError(
                    "only single-component (monochrome) JPEG-LS is "
                    f"supported, got {ncomp} components")
        elif marker in (0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6,
                        0xFFC7, 0xFFC9, 0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE,
                        0xFFCF):
            raise ValueError("not a JPEG-LS (SOF55) stream")
        elif marker == _LSE:
            if seg and seg[0] == 1:
                maxval, t1, t2, t3, reset = struct.unpack_from(
                    ">HHHHH", seg, 1)
                # a ZERO preset value means "use the default" for that
                # parameter (T.87 C.2.4.1.1) — CharLS/GDCM emit such
                # streams (e.g. MAXVAL set, thresholds left 0)
                maxval = maxval or None
                thresholds = (t1, t2, t3)
                reset = reset or _RESET_DEFAULT
        elif marker == _SOS:
            ns = seg[0]
            if ns != 1:
                raise ValueError("only single-component scans are supported")
            near = seg[1 + 2 * ns]
            ilv = seg[2 + 2 * ns]
            if ilv != 0:
                raise ValueError(
                    f"only ILV=0 (non-interleaved) is supported, got {ilv}")
            if not precision:
                raise ValueError("SOS before SOF55")
            p = _Params(precision, near, maxval=maxval,
                        thresholds=thresholds, reset=reset)
            return _decode_scan(data[pos + seglen :], p, rows, cols)
        pos += seglen
    raise ValueError("no SOS scan found in JPEG-LS stream")
