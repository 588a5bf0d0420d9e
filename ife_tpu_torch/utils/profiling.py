"""Per-stage timing/throughput metrics (counterpart of
ife_tpu/utils/profiling.py).

`stage_timer` wraps a pipeline stage and:
  * marks it as an NVTX range when CUDA is in use, so a device profile
    groups kernels by pipeline stage (ife_tpu used
    jax.profiler.TraceAnnotation for the same purpose);
  * records wall time and voxel throughput into a StageMetrics registry,
    synchronising the CUDA device at both ends so the time covers the
    device work queued inside the stage, not just its enqueue;
  * optionally emits a JSON metrics line per stage.

Beside it, the yardsticks chip_smoke.py and bench_torch.py time the card
with (one copy, so the two cannot drift apart): `cuda_ms`, a call on an
idle card as its caller waits for it; `device_ms`, back-to-back calls behind
queued work, the card's own time; `wall_ms`, the host clock's counterpart of
device_ms for a run on the CPU; and `card_line` / `card`, the card's name
and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ife_tpu_torch.utils.logging import log_json


@dataclass
class StageRecord:
    name: str
    seconds: float
    voxels: Optional[int] = None

    @property
    def voxels_per_sec(self) -> Optional[float]:
        if self.voxels is None or self.seconds <= 0:
            return None
        return self.voxels / self.seconds


@dataclass
class StageMetrics:
    records: List[StageRecord] = field(default_factory=list)

    def add(self, rec: StageRecord) -> None:
        self.records.append(rec)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            s = out.setdefault(r.name, {"seconds": 0.0, "calls": 0})
            s["seconds"] += r.seconds
            s["calls"] += 1
            if r.voxels_per_sec is not None:
                s["voxels_per_sec"] = r.voxels_per_sec
        return out


_global_metrics = StageMetrics()


def global_metrics() -> StageMetrics:
    return _global_metrics


def _cuda_in_use() -> bool:
    # never initialises CUDA itself: a CPU-only run stays CPU-only
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def stage_timer(
    name: str,
    voxels: Optional[int] = None,
    metrics: Optional[StageMetrics] = None,
    emit: bool = False,
):
    """Time a pipeline stage; marks it as an NVTX range on CUDA.

    The clock is read after a device synchronise at entry and at exit, so
    the recorded time includes the device work the stage queued.
    """
    m = metrics if metrics is not None else _global_metrics
    cuda = _cuda_in_use()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.nvtx.range(name) if cuda else contextlib.nullcontext():
        yield
        if _cuda_in_use():
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = StageRecord(name=name, seconds=dt, voxels=voxels)
    m.add(rec)
    if emit:
        payload = {"stage": name, "seconds": round(dt, 6)}
        if rec.voxels_per_sec is not None:
            payload["voxels_per_sec"] = round(rec.voxels_per_sec, 1)
        log_json("stage", payload)


# ---------------------------------------------------------------------------
# yardsticks
# ---------------------------------------------------------------------------

# the device yardstick (device_ms): calls between one event pair, and the
# clock cycles of the torch.cuda._sleep queued ahead of them (~2 ms at the
# H100's 1.98 GHz boost clock), longer than the host takes to enqueue them
DEVICE_CALLS = 10
DEVICE_SLEEP_CYCLES = 4_000_000


def _median_min_max(ts):
    ts = sorted(ts)
    return ts[len(ts) // 2], ts[0], ts[-1]


def cuda_ms(fn, reps=5):
    """(median, min, max) ms of fn() by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
        del out
    return _median_min_max(ts)


def device_ms(fn, calls=DEVICE_CALLS, reps=5):
    """(median, min, max) ms a call of fn on the device: one warm call, then
    `reps` runs of `calls` back-to-back calls between one event pair, each
    run behind a torch.cuda._sleep of DEVICE_SLEEP_CYCLES (~2 ms) so that the
    card has work queued while the host enqueues the calls: the wrappers'
    host time (argument checks, allocations, the ctypes call) hides behind
    the device's work unless a call waits for the card. cuda_ms, which
    starts each call on an idle card, is the call's time as a caller waits
    for it."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return _median_min_max(ts)


def wall_ms(fn, calls=DEVICE_CALLS, reps=5):
    """(median, min, max) ms a call of fn on the host's clock: one warm
    call, then `reps` runs of `calls` back-to-back calls. device_ms's
    counterpart for a run on the CPU, where the host does the work."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ts.append((time.perf_counter() - t0) * 1e3 / calls)
    return _median_min_max(ts)


def card_line() -> str:
    """The first card's `name, power limit` as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    it (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). Raises RuntimeError when
    nvidia-smi fails, OSError when there is none."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def card() -> Dict[str, object]:
    """card_line as {"name": ..., "power_limit_w": watts, a float, or None
    where nvidia-smi prints no number}."""
    name, _, limit = card_line().rpartition(",")
    try:
        watts: Optional[float] = float(limit.strip().split()[0])
    except (ValueError, IndexError):
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}
