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
"""
from __future__ import annotations

import contextlib
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
