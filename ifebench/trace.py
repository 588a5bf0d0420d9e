"""The traced window: torch.profiler over a few scans, read back from its
chrome trace.

Device intervals are the profiler's kernel, memcpy and memset records.
The window runs from the start of the first scan's ``ifebench.scan`` span
to the end of the last one's, on the profiler's clock. Busy time is the
union of the device intervals inside the window; an idle gap is a stretch
of the window that no device interval covers, named by the innermost host
record (a Python function, an op or a runtime call) under its midpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SCAN_SPAN = "ifebench.scan"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("python_function", "cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120


def record(scan, n_scans: int, cuda: bool):
    """Run scan(i) for i < n_scans under the profiler; returns a Trace."""
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=True) as prof:
        for i in range(n_scans):
            with record_function(SCAN_SPAN):
                scan(i)
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events, n_scans)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Intervals in microseconds on the profiler's clock."""

    def __init__(self, events, n_scans):
        self.n_scans = n_scans
        spans = [e for e in events if e.get("ph") == "X"]
        scans = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                 if e.get("name") == SCAN_SPAN
                 and e.get("cat") == "user_annotation"]
        self.window = ((min(a for a, _ in scans), max(b for _, b in scans))
                       if scans else (0.0, 0.0))
        lo, hi = self.window
        self.device = [(e["name"], e["cat"], max(e["ts"], lo),
                        min(e["ts"] + e["dur"], hi))
                       for e in spans if e.get("cat") in DEVICE_CATS
                       and e["ts"] < hi and e["ts"] + e["dur"] > lo]
        self.host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in spans
                     if e.get("cat") in HOST_CATS]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self):
        return _union([(a, b) for _, _, a, b in self.device if b > a])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self):
        """[(start, end)] of the window that no device interval covers."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def device_seconds(self, match):
        """Summed seconds of the device records whose (name, cat) match."""
        return sum(b - a for n, c, a, b in self.device if match(n, c)) * 1e-6

    def host_under(self, t):
        """Name of the innermost host record that covers time t."""
        best = None
        for name, a, b in self.host:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "(no host record)"

    def breakdown(self, top=10):
        ops = defaultdict(float)
        for n, _, a, b in self.device:
            ops[n[:NAME_CHARS]] += (b - a) * 1e-6
        gaps = defaultdict(float)
        for a, b in self.idle_gaps():
            gaps[self.host_under((a + b) / 2)[:NAME_CHARS]] += (b - a) * 1e-6
        return {
            "device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top],
        }
