"""The seven metrics that read the program's spans, on a fabricated store
and trace: what each sums, per traced scan, and nothing where there is
nothing to read."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from ifebench.harness import load_module
from ifebench.trace import Trace
from ife_tpu_torch.utils import profiling

METRICS = Path(__file__).resolve().parent.parent / "metrics"
NAMES = ("stage_host_ms_per_scan", "host_wait_ms_per_scan",
         "roi_hist_ms_per_scan", "features_sweep_ms_per_scan",
         "features_xs_stream_ms_per_scan", "features_nc_post_ms_per_scan",
         "features_mask_ms_per_scan")
READERS = {n: load_module(METRICS / f"{n}.py", "metrics") for n in NAMES}


class _Event:
    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class _Store:
    """Spans opened and closed at given host ms and device ms: a span's
    host ms is its children's and then its own."""

    def __init__(self):
        self.m = profiling.StageMetrics()
        self.host_ms = 0.0

    def span(self, name, host_ms, device=None, children=()):
        ev = None if device is None else (_Event(device[0]), _Event(device[1]))
        i = self.m.open(name, events=ev)
        self.m.records[i].start_ns = int(self.host_ms * 1e6)
        for child in children:
            self.span(*child)
        self.host_ms += host_ms
        rec = self.m.close(i)
        rec.end_ns = int(self.host_ms * 1e6)


def _ctx(n_scans, device_records=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "ifebench.scan",
           "ts": 0, "dur": 1000}]
    if device_records:
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": 10,
                   "dur": 100})
    return SimpleNamespace(trace=Trace(ev, n_scans))


@pytest.fixture
def store(monkeypatch):
    s = _Store()
    monkeypatch.setattr(profiling, "_global_metrics", s.m)
    return s


def _bag(s, t):
    """One traced bag: the span tree of make_bag_device over 2 scales,
    device times from t ms."""
    s.span("bag", 1.0, (t, t + 40), [
        ("bag.stage", 0.0, (t, t + 30), [
            ("bag.stage.clip", 170.0, (t, t + 1)),
            ("bag.stage.h2d", 80.0, (t + 1, t + 30))]),
        ("features.sweep", 0.5, (t + 30, t + 33),
         [("features.mask", 0.1, (t + 30, t + 30.25))]),
        ("bag.bin", 0.2, (t + 33, t + 33.5)),
        ("bag.fetch", 3.0, (t + 33.5, t + 33.6)),
        ("features.nc_post", 0.5, (t + 33.6, t + 39),
         [("features.mask", 0.1, (t + 33.6, t + 34))]),
        ("bag.bin", 0.2, (t + 39, t + 39.25)),
        ("bag.fetch", 5.0, (t + 39.25, t + 40))])


def test_the_bag_readers_sum_per_traced_scan(store):
    _bag(store, 0.0)
    _bag(store, 100.0)
    ctx = _ctx(2)
    val = {n: READERS[n].read(ctx) for n in NAMES}
    assert val["stage_host_ms_per_scan"] == pytest.approx(250.0)
    assert val["host_wait_ms_per_scan"] == pytest.approx(8.0)
    assert val["roi_hist_ms_per_scan"] == pytest.approx(0.75)
    # self time: the branch span less its mask child
    assert val["features_sweep_ms_per_scan"] == pytest.approx(3.0 - 0.25)
    assert val["features_nc_post_ms_per_scan"] == pytest.approx(5.4 - 0.4)
    assert val["features_mask_ms_per_scan"] == pytest.approx(0.65)
    assert val["features_xs_stream_ms_per_scan"] is None


def test_the_feature_readers_add_up_to_the_branch_spans(store):
    for t in (0.0, 50.0, 100.0):
        for name, d0, d1, m1 in (("features.sweep", 0, 4, 0.3),
                                 ("features.sweep", 4, 8, 4.3),
                                 ("features.xs_stream", 8, 12, 8.3),
                                 ("features.nc_post", 12, 16, 12.3)):
            store.span(name, 0.1, (t + d0, t + d1),
                       [("features.mask", 0.01, (t + d0, t + m1))])
    ctx = _ctx(3)
    parts = [READERS[n].read(ctx) for n in NAMES[3:]]
    assert parts == pytest.approx([7.4, 3.7, 3.7, 1.2])
    assert sum(parts) == pytest.approx(16.0)


def test_nothing_to_read(store, monkeypatch):
    for n in NAMES:
        # an empty store, no trace, a trace with no device record (a run on
        # the CPU)
        assert READERS[n].read(_ctx(4)) is None
        assert READERS[n].read(SimpleNamespace(trace=None)) is None
    _bag(store, 0.0)
    for n in NAMES[:3]:
        assert READERS[n].read(_ctx(1, device_records=False)) is None
    # spans without device events: the host readers read, the device ones
    # find nothing
    host_only = _Store()
    host_only.span("bag.stage", 4.0)
    host_only.span("bag.bin", 1.0)
    monkeypatch.setattr(profiling, "_global_metrics", host_only.m)
    assert READERS["stage_host_ms_per_scan"].read(_ctx(2)) == 2.0
    assert READERS["roi_hist_ms_per_scan"].read(_ctx(2)) is None
    # a program without spans (before them): no reader raises
    for attr in ("span_host_ms", "span_device_ms", "span_self_device_ms"):
        monkeypatch.delattr(profiling, attr)
    for n in NAMES:
        assert READERS[n].read(_ctx(1)) is None
