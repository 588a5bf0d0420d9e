"""The port's native host library: ctypes over ``native/ife_native.cpp``.

Counterpart of ife_tpu/native_lib.py. The library holds the host hot loops
around the card: the HR2 zlib codec, threaded histogram binning (the
MakeBag host loop and ``DenseHistogram.insert_many``) and the JPEG Lossless
and JPEG-LS decoders of the DICOM reader. ``native/ife_native.cpp`` is the
port's own copy of the C++ source.

At first use ``g++`` compiles it with the flags below into a cache under
``build/ife_tpu_torch/native/<key>/`` at the root of the checkout, and the
library is loaded with ctypes. The key hashes the source, the flags, ``g++
--version`` and the target options ``-march=native`` resolves to, so an
edited source, another compiler or another CPU gets a library of its own.
Concurrent builds (several test workers) take a file lock; the loser finds
the library built. A build that fails raises with the compiler's stderr:
unlike ife_tpu, nothing here returns None and falls back in silence.

Every wrapper counts a call that the library served in ``CALLS``; the JPEG
fast decoders (io/jpegll.py, io/jpegls.py) count the frames they handed to
their Python decoder in ``FALLBACKS``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "ife_native.cpp"
BUILD_ROOT = (Path(__file__).resolve().parent.parent / "build"
              / "ife_tpu_torch" / "native")
CXX = "g++"
# native/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra",
             "-fPIC", "-pthread")
LD_LIBS = ("-lz", "-pthread")

# entry -> calls the library served (counted after the call returned)
CALLS = dict.fromkeys(("hr2_read", "hr2_write", "histogram",
                       "histogram_channels", "jll_decode", "jls_decode"), 0)
# decoder -> frames the fast decoder gave to its Python decoder after the
# native decoder refused them
FALLBACKS = dict.fromkeys(("jll_decode", "jls_decode"), 0)

_lock = threading.Lock()
_count_lock = threading.Lock()  # convert_dicom_dir decodes in threads
_lib = None


def count(counter: dict, key: str) -> None:
    """Add one to counter[key] (CALLS or FALLBACKS), safe across threads."""
    with _count_lock:
        counter[key] += 1


def reset_counts() -> None:
    with _count_lock:
        for d in (CALLS, FALLBACKS):
            for k in d:
                d[k] = 0


class Hr2Info(ctypes.Structure):
    _fields_ = [
        ("size", ctypes.c_int64 * 3),
        ("origin", ctypes.c_double * 3),
        ("spacing", ctypes.c_double * 3),
        ("is_float", ctypes.c_int32),
    ]


def _compiler_output(*args) -> str:
    """stdout of `CXX *args`; raises RuntimeError when it cannot run."""
    try:
        res = subprocess.run([CXX, *args], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"the native library of ife_tpu_torch needs a C++ compiler: "
            f"{CXX} {' '.join(args)} failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} {' '.join(args)} failed "
                           f"({res.returncode}):\n{res.stderr}")
    return res.stdout


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_LIBS).encode())
    h.update(_compiler_output("--version").encode())
    h.update(_compiler_output("-march=native", "-Q", "--help=target").encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libife_native.so"


def build() -> Path:
    """Compile the source into the cached library unless it is there;
    returns its path. Raises RuntimeError with the compiler's stderr when
    the build fails. Writes nothing outside BUILD_ROOT."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():  # built by the process that held the lock
            return out
        with tempfile.TemporaryDirectory(dir=out.parent) as work:
            tmp = Path(work) / out.name
            cmd = [CXX, *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE),
                   *LD_LIBS]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise RuntimeError(
                    f"building the native library failed ({res.returncode}):"
                    f" {' '.join(cmd)}\n{res.stderr}")
            (out.parent / "build.log").write_text(res.stdout + res.stderr)
            # rename into place: no process loads a half-written library
            os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            L.ife_free.argtypes = [ctypes.c_void_p]
            L.ife_hr2_read.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(Hr2Info),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_char_p, ctypes.c_int,
            ]
            L.ife_hr2_read.restype = ctypes.c_int
            L.ife_hr2_write.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(Hr2Info),
                ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int,
            ]
            L.ife_hr2_write.restype = ctypes.c_int
            L.ife_histogram.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ]
            L.ife_histogram.restype = None
            L.ife_histogram_channels.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ]
            L.ife_histogram_channels.restype = None
            for fn in (L.ife_jll_decode, L.ife_jls_decode):
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.c_int32, ctypes.c_int32,
                ]
                fn.restype = ctypes.c_int
            _lib = L
        return _lib


# ---------------------------------------------------------------------------
# the wrappers: ife_tpu's signatures and results, never None
# ---------------------------------------------------------------------------

def hr2_read_native(path: str):
    """(data (X,Y,Z) float32, spacing, origin). Raises ValueError when the
    library rejects the file."""
    L = lib()
    info = Hr2Info()
    data_p = ctypes.POINTER(ctypes.c_float)()
    err = ctypes.create_string_buffer(256)
    rc = L.ife_hr2_read(path.encode(), ctypes.byref(info),
                        ctypes.byref(data_p), err, 256)
    if rc != 0:
        raise ValueError(f"HR2 read failed: {err.value.decode()}")
    n = info.size[0] * info.size[1] * info.size[2]
    flat = np.ctypeslib.as_array(data_p, shape=(n,)).copy()
    L.ife_free(data_p)
    # payload is x fastest -> file order (z, y, x); transpose to (X, Y, Z)
    arr = flat.reshape(info.size[2], info.size[1], info.size[0]).transpose(2, 1, 0)
    count(CALLS, "hr2_read")
    return (
        np.ascontiguousarray(arr),
        tuple(info.spacing),
        tuple(info.origin),
    )


def hr2_write_native(path: str, data: np.ndarray, spacing, origin,
                     pixel_type: str = "float") -> bool:
    L = lib()
    info = Hr2Info()
    for d in range(3):
        info.size[d] = data.shape[d]
        info.spacing[d] = float(spacing[d])
        info.origin[d] = float(origin[d])
    info.is_float = 1 if pixel_type == "float" else 0
    flat = np.ascontiguousarray(
        np.asarray(data, dtype=np.float32).transpose(2, 1, 0)
    ).reshape(-1)
    err = ctypes.create_string_buffer(256)
    rc = L.ife_hr2_write(
        path.encode(), ctypes.byref(info),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256,
    )
    if rc != 0:
        raise ValueError(f"HR2 write failed: {err.value.decode()}")
    count(CALLS, "hr2_write")
    return True


def histogram_native(values: np.ndarray, edges: np.ndarray,
                     mask: np.ndarray | None = None):
    """(n_edges+1,) uint64 counts (searchsorted-left bins of the values as
    f32; a NaN lands in bin 0, where numpy's searchsorted puts it last)."""
    L = lib()
    v = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    e = np.ascontiguousarray(edges, dtype=np.float64)
    counts = np.zeros(e.size + 1, dtype=np.uint64)
    m_ptr = None
    if mask is not None:
        m = np.ascontiguousarray(mask, dtype=np.uint8).reshape(-1)
        if m.size != v.size:
            raise ValueError("mask size mismatch")
        m_ptr = m.ctypes.data_as(ctypes.c_void_p)
    L.ife_histogram(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.size,
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), e.size,
        m_ptr, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    count(CALLS, "histogram")
    return counts


def histogram_channels_native(values: np.ndarray, edges: np.ndarray,
                              mask: np.ndarray | None = None):
    """values (N, H), edges (H, E) -> (H, E+1) uint64 counts (NaN in bin 0,
    as histogram_native)."""
    L = lib()
    v = np.ascontiguousarray(values, dtype=np.float32)
    if v.ndim != 2:
        raise ValueError("values must be (N, H)")
    n, h = v.shape
    e = np.ascontiguousarray(edges, dtype=np.float64)
    if e.shape[0] != h:
        raise ValueError("edges must be (H, E)")
    counts = np.zeros((h, e.shape[1] + 1), dtype=np.uint64)
    m_ptr = None
    if mask is not None:
        m = np.ascontiguousarray(mask, dtype=np.uint8).reshape(-1)
        if m.size != n:
            raise ValueError("mask size mismatch")
        m_ptr = m.ctypes.data_as(ctypes.c_void_p)
    L.ife_histogram_channels(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h,
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), e.shape[1],
        m_ptr, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    count(CALLS, "histogram_channels")
    return counts


def _decode(entry: str, what: str, data: bytes, rows: int, cols: int):
    out = np.empty((rows, cols), dtype=np.uint16)
    rc = getattr(lib(), f"ife_{entry}")(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rows, cols,
    )
    if rc != 0:
        raise ValueError(f"{what} decode failed (native rc={rc})")
    count(CALLS, entry)
    return out


def jll_decode_native(data: bytes, rows: int, cols: int):
    """Decode a JPEG Lossless SV1 frame with the C++ decoder; (rows, cols)
    uint16. Raises ValueError on a stream it refuses (a malformed one, or a
    frame whose SOF3 dims differ from rows/cols)."""
    return _decode("jll_decode", "JPEG lossless", data, rows, cols)


def jls_decode_native(data: bytes, rows: int, cols: int):
    """Decode a single-component JPEG-LS (T.87) stream with the C++
    decoder; (rows, cols) uint16. Raises ValueError on a stream it
    refuses."""
    return _decode("jls_decode", "JPEG-LS", data, rows, cols)
