"""Build, load and launch the hand-written CUDA kernels of
``ife_tpu_torch/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all of them at once, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
cached under ``build/ife_tpu_torch/<source hash>/`` at the root of
the checkout, and loaded with ctypes. The hash covers every source and
header and the compiler flags, so an edited kernel is rebuilt and a stale
library is never loaded.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0 and counts the
launch in ``LAUNCHES`` only when it succeeded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "ife_tpu_torch"
# --fmad=false: no a*b+c is contracted into an FMA, so each rounds twice
# exactly like the plain twins' separate tensor ops and a kernel agrees with
# its twin to the bit. A 1-ulp difference in a Hessian term would otherwise
# reach ~1e-4 of the eigenvalue scale near repeated eigenvalues (the f32
# sqrt(ulp) floor of the closed-form solve, docs/design.md "Precision
# policy"), hiding real faults under arithmetic noise. The kernels are
# memory-bound, so the extra instructions are not on their critical path.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Names counted in LAUNCHES that have no C entry of their own, and the entry
# they launch: "normalized_conv_tiled" counts the launches of
# ife_normalized_conv that fused_normalized_conv_sweep_tiled makes, one per
# slab; the others count the shard modes (clamps, x_halo, pre_padded) and
# the other outputs (the probes' copyfloor, copy6, stencil6; the Hessian's
# reference eigen path) of an entry apart from its whole-volume features.
COUNTED_AS = {
    "normalized_conv_tiled": "normalized_conv",
    "features8_sweep_clamps": "features8_sweep",
    "features8_sweep_multi_clamps": "features8_sweep_multi",
    "hessian_eig_x_halo": "hessian_eig",
    "hessian_eig_pre_padded": "hessian_eig",
    "features8_post_x_halo": "features8_post",
    "features8_post_pre_padded": "features8_post",
    "features8_post_windowed_pre_padded": "features8_post_windowed",
    "hessian_eig_copyfloor": "hessian_eig",
    "hessian_eig_copy6": "hessian_eig",
    "hessian_eig_stencil6": "hessian_eig",
    "hessian_eig_reference": "hessian_eig",
    "features8_tap_copyfloor": "features8_tap",
}

# kernel name -> number of successful launches of its C entry point
LAUNCHES = dict.fromkeys(
    ("hessian_eig", "normalized_conv", "features8_post", "features8_sweep",
     "features8_xs_stream", "smooth_yz", "histogram", "smooth_xz",
     "features8_post_windowed", "features8_ys_multi", "features8_sweep_multi",
     "features8_tap", "features8_xs", "pcopy1", "trivial6", *COUNTED_AS), 0)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
# C signatures: every pointer and the stream as void*, dims as int64,
# constants as float (an undeclared argument would be passed as a 32-bit int)
_SIGNATURES = {
    "ife_hessian_eig": [_P, _P, _P, _P, _I, _I, _I, _I, _I] + [_F] * 6 + [_P],
    "ife_features8_post": [_P, _P, _P, _P, _P, _I, _I, _I, _I] + [_F] * 6
                          + [_P],
    "ife_normalized_conv": [_P, _P, _P, _P, _P, _I, _I, _I,
                            _FP, _I, _FP, _I, _FP, _I, _P],
    "ife_smooth_yz": [_P, _P, _P, _P, _I, _I, _I, _FP, _I, _FP, _I, _P],
    "ife_features8_sweep": [_P, _P, _P, _I, _I, _I, _FP, _I, _FP, _I, _FP,
                            _I] + [_I] * 4 + [_F] * 6 + [_P],
    "ife_features8_xs_stream": [_P, _P, _P, _P, _I, _I, _I, _FP, _I]
                               + [_F] * 6 + [_P],
    "ife_histogram": [_P, _I, _P, _I, _P, _I, _P] + [_I] * 11 + [_P, _P],
    "ife_smooth_xz": [_P, _P, _P, _P, _I, _I, _I, _FP, _I, _FP, _I, _P],
    "ife_features8_post_windowed": [_P, _P, _P, _I, _I, _I, _I, _I, _I]
                                   + [_F] * 6 + [_P],
    "ife_features8_ys_multi": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P]
                              + [_F] * 6 + [_P],
    "ife_features8_sweep_multi": [_P, _P, _P, _I, _I, _I, _I, _P, _P]
                                 + [_I] * 4 + [_F] * 6 + [_P],
    "ife_features8_tap": [_P, _P, _P, _I, _I, _I, _FP, _I, _FP, _I, _FP, _I]
                         + [_F] * 6 + [_I, _P, _I, _P],
    "ife_features8_xs": [_P, _P, _P, _P, _I, _I, _I, _FP, _I] + [_F] * 6
                        + [_P],
    "ife_pcopy1": [_P, _P, _I, _I, _F, _P],
    "ife_trivial6": [_P] * 7 + [_I, _I] + [_F] * 6 + [_P],
}

MAX_TAPS = 257    # csrc/fir.cuh kMaxTaps: radius <= 128 voxels
MAX_SCALES = 8    # csrc/fir.cuh kMaxScales

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
            "CUDA kernels of ife_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libife_kernels.so"


def _run_all(cmds):
    """Run the commands at once; raise with the first failure's stderr.
    Returns their stdout + stderr, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return [o + e for o, e in outs]


def build() -> Path:
    """Compile csrc/*.cu into the cached library unless it already exists;
    returns its path. Each source compiles in its own nvcc process, all
    started together, then one nvcc links the objects. Raises with nvcc's
    stderr when the build fails. The compiler's report (-Xptxas -v:
    registers, spills) is kept beside the library as build.log."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        objs = [str(Path(work) / (cu.stem + ".o")) for cu in cus]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(cu)]
                         for cu, o in zip(cus, objs)])
        # link to a private name, then rename: a concurrent process never
        # loads a half-written library
        tmp = str(Path(work) / out.name)
        logs += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        (out.parent / "build.log").write_text("".join(logs))
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.ife_error_string.argtypes = [ctypes.c_int]
            handle.ife_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def launch(kernel: str, device: torch.device, *args, count_as=None) -> None:
    """Call the C entry ``ife_<kernel>`` on `device`'s current stream
    (appended as the last argument); raise on a launch error, else count
    one launch of `kernel` (of `count_as`, a name of COUNTED_AS, when
    given)."""
    handle = lib()
    entry = f"ife_{kernel}"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(handle, entry)(*args, stream)
    if err != 0:
        msg = handle.ife_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")
    LAUNCHES[count_as or kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda_volume(name: str, t: torch.Tensor, shape=None) -> None:
    """The inputs every kernel takes: a contiguous (X, Y, Z) float32 CUDA
    tensor (of `shape` when given). Raises ValueError on anything else."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name}: expected an (X, Y, Z) volume, got shape "
                         f"{tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if min(t.shape) < 1 or max(t.shape[:2]) > 65535:
        raise ValueError(f"{name}: X and Y must be in [1, 65535], Z >= 1, "
                         f"got {tuple(t.shape)}")


def scale_taps_tensor(rows, device: torch.device) -> torch.Tensor:
    """The taps of a multi-scale launch on the card: one row of MAX_TAPS
    float32 per tap tuple of `rows`, zero beyond its 2r+1 taps (csrc/fir.cuh
    kMaxTaps; the kernels copy a row's head to shared memory)."""
    host = torch.zeros((len(rows), MAX_TAPS), dtype=torch.float32)
    for i, taps in enumerate(rows):
        if len(taps) > MAX_TAPS:
            raise ValueError(f"{len(taps)} taps > {MAX_TAPS}")
        host[i, :len(taps)] = torch.tensor(taps, dtype=torch.float64).float()
    return host.to(device)


def use_plain_twin(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs its plain twin), False for a
    CUDA tensor (the wrapper launches its kernel); raises for any other
    device. Nothing on a CUDA tensor ever falls back to the plain twin."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel or plain path for device {t.device}")
