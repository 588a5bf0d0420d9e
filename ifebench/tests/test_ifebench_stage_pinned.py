"""stage_pinned_pct on a fabricated store and trace: the share of the
staged bytes that went through the ring, and nothing where there is nothing
to read."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from ifebench.harness import load_module
from ifebench.trace import Trace
from ife_tpu_torch.utils import profiling

METRICS = Path(__file__).resolve().parent.parent / "metrics"
PINNED = load_module(METRICS / "stage_pinned_pct.py", "metrics")


class _Store:
    """Host-only spans opened and closed at given host ms, each with its
    work: a span's host ms is its children's and then its own."""

    def __init__(self):
        self.m = profiling.StageMetrics()
        self.host_ms = 0.0

    def span(self, name, host_ms, work=None, children=()):
        i = self.m.open(name, work=work)
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


def _staging(s, image, mask, pinned):
    """One traced bag's staging: "bag.stage.h2d" (work: the bytes that
    cross) over "bag.stage.pinned" (work: those through the ring)."""
    s.span("bag", 1.0, None, [
        ("bag.stage", 0.0, None, [
            ("bag.stage.h2d", 1.0, image + mask,
             [("bag.stage.pinned", 30.0, pinned)])])])


def test_stage_pinned_pct_is_the_ring_share_of_the_staged_bytes(store):
    _staging(store, 400, 100, 500)
    _staging(store, 400, 100, 500)
    assert PINNED.read(_ctx(2)) == pytest.approx(100.0)
    # a third scan whose image took the pageable copy
    _staging(store, 400, 100, 100)
    assert PINNED.read(_ctx(3)) == pytest.approx(100.0 * 1100 / 1500)


def test_stage_pinned_pct_reads_nothing_without_its_spans(store, monkeypatch):
    assert PINNED.read(_ctx(1)) is None
    assert PINNED.read(SimpleNamespace(trace=None)) is None
    # the program before the ring: "bag.stage.h2d" and no pinned span
    store.span("bag.stage.h2d", 80.0, 500)
    assert PINNED.read(_ctx(1)) is None
    # on the CPU: no device record in the trace
    _staging(store, 400, 100, 0)
    assert PINNED.read(_ctx(1, device_records=False)) is None
    assert PINNED.read(_ctx(1)) == 0.0
    monkeypatch.delattr(profiling, "spans")
    assert PINNED.read(_ctx(1)) is None
