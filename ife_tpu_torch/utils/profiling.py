"""Spans and stage timers of the port, in one store (counterpart of
ife_tpu/utils/profiling.py), and the yardsticks that time the card.

`span(name, device=None, work=None)` marks a piece of the program's work
(whose count, `work`, may also be set on the span inside it).
It records only while torch.profiler is recording in the calling thread;
otherwise it costs its call and one flag check. While it records it
  * enters torch.profiler.record_function(name), so the span is a
    `user_annotation` of the profiler's trace, on the clock of the trace's
    kernel and memcpy records (under torch.autograd.profiler.emit_nvtx() an
    NVTX range);
  * appends a StageRecord to the store: host start and end ns, the index
    of its parent span and of its request (the outermost span open), a
    count of its work (voxels, bytes, ROIs), and, when `device` is a CUDA
    device, a pair of timing events on the current stream.
No span synchronises the device or reads an event: the events are read
when the store is, by `span_device_ms` and `span_self_device_ms`
(`spans(name)` lists the records, `span_host_ms` reads the host clock's).

`stage_timer` is the CLI's always-on stage timer: it synchronises the CUDA
device at both ends, so its time covers the device work queued inside the
stage, records into the same store and the same record_function, and can
emit a JSON metrics line.

Beside them, the yardsticks chip_smoke.py and bench_torch.py time the card
with (one copy, so the two cannot drift apart): `cuda_ms`, a call on an
idle card as its caller waits for it; `device_ms`, back-to-back calls behind
queued work, the card's own time; `wall_ms`, the host clock's counterpart of
device_ms for a run on the CPU; and `card_line` / `card`, the card's name
and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import contextlib
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from ife_tpu_torch.utils.logging import log_json

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass
class StageRecord:
    """One span: host ns on time.perf_counter_ns's clock, its own index in
    the store, its parent's (None at the root) and its request's (the
    outermost span open when it began; its own at the root), its work, and
    its (start, end) CUDA events or None."""
    name: str
    index: int
    start_ns: int
    end_ns: int = 0
    parent: Optional[int] = None
    request: int = 0
    work: Optional[int] = None
    events: Optional[tuple] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclass
class StageMetrics:
    """The store: records in the order their spans began."""
    records: List[StageRecord] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    _local: threading.local = field(default_factory=threading.local,
                                    repr=False, compare=False)

    def _open_spans(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, work: Optional[int] = None,
             events: Optional[tuple] = None) -> int:
        """Begin a record in the calling thread; returns its index."""
        stack = self._open_spans()
        with self._lock:
            i = len(self.records)
            self.records.append(StageRecord(
                name, i, time.perf_counter_ns(),
                parent=stack[-1] if stack else None,
                request=stack[0] if stack else i, work=work, events=events))
        stack.append(i)
        return i

    def close(self, i: int) -> StageRecord:
        rec = self.records[i]
        rec.end_ns = time.perf_counter_ns()
        self._open_spans().remove(i)
        return rec


_global_metrics = StageMetrics()


def global_metrics() -> StageMetrics:
    return _global_metrics


class span:
    """A span of the program's work (see the module's docstring): records
    into global_metrics() while torch.profiler records in this thread."""

    __slots__ = ("name", "device", "work", "_index", "_fn", "_events")

    def __init__(self, name: str, device=None, work: Optional[int] = None):
        self.name, self.device, self.work = name, device, work
        self._index = None

    def __enter__(self):
        if not _profiler_enabled():
            return self
        self._fn = record_function(self.name)
        self._fn.__enter__()
        self._events = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        self._index = _global_metrics.open(self.name, self.work, self._events)
        return self

    def __exit__(self, *exc):
        if self._index is None:
            return False
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        # the work may be set inside the span, once it is known
        _global_metrics.close(self._index).work = self.work
        self._index = None
        self._fn.__exit__(*exc)
        return False


def spans(name: Optional[str] = None) -> List[StageRecord]:
    """The store's records, or those named `name`, in the order they began."""
    return [r for r in _global_metrics.records if name is None or r.name == name]


def span_host_ms(rec: StageRecord) -> float:
    return (rec.end_ns - rec.start_ns) * 1e-6


def span_device_ms(rec: StageRecord) -> Optional[float]:
    """The device ms between the span's two events (waiting for the end
    event), or None for a span without events."""
    if rec.events is None:
        return None
    start, end = rec.events
    end.synchronize()
    return start.elapsed_time(end)


def span_self_device_ms(rec: StageRecord) -> Optional[float]:
    """span_device_ms less what the span's children cover on the device:
    the children of one span run one after another on its stream, so that
    is the sum of their device ms."""
    total = span_device_ms(rec)
    if total is None:
        return None
    for r in _global_metrics.records[rec.index + 1:]:
        if r.start_ns > rec.end_ns:
            break
        if r.parent == rec.index and r.events is not None:
            total -= span_device_ms(r)
    return total


def _cuda_in_use() -> bool:
    # never initialises CUDA itself: a CPU-only run stays CPU-only
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def stage_timer(name: str, work: Optional[int] = None, emit: bool = False):
    """Time a pipeline stage into the store (a root span where no span is
    open) under record_function(name), whether or not a profiler runs.

    The clock is read after a device synchronise at entry and at exit, so
    the recorded time includes the device work the stage queued. `emit`
    prints {"event": "stage", "stage": name, "seconds": s[, "work": n]}.
    """
    m = _global_metrics
    if _cuda_in_use():
        torch.cuda.synchronize()
    with record_function(name):
        i = m.open(name, work)
        try:
            yield
            if _cuda_in_use():
                torch.cuda.synchronize()
        finally:
            rec = m.close(i)
    if emit:
        payload = {"stage": name, "seconds": round(rec.seconds, 6)}
        if work is not None:
            payload["work"] = work
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
