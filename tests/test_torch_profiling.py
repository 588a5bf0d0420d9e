"""ife_tpu_torch.utils.profiling's spans and stage timer, and the spans of
roi/bag.py:make_bag_device and ops/features.py:fused_features8, on the CPU
(one case on the card, marker gpu).

This file imports neither JAX nor ife_tpu; on the card run its card case
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_profiling.py -q
"""
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ife_tpu_torch.kernels import _build
from ife_tpu_torch.ops.features import fused_features8
from ife_tpu_torch.roi.bag import make_bag_device
from ife_tpu_torch.roi.generate import ROI
from ife_tpu_torch.utils import logging as ife_logging
from ife_tpu_torch.utils import profiling as P


@pytest.fixture
def store(monkeypatch):
    """A fresh store in the place of the process's."""
    m = P.StageMetrics()
    monkeypatch.setattr(P, "_global_metrics", m)
    return m


def _profiled(fn, **options):
    """fn() under torch.profiler (CPU activity, and `options`) inside
    record_function "outer"; returns the profiler."""
    with profile(activities=[ProfilerActivity.CPU], **options) as prof:
        with record_function("outer"):
            fn()
    return prof


def _chrome_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def _annotations(prof, tmp_path):
    return [e for e in _chrome_events(prof, tmp_path)
            if e.get("cat") == "user_annotation"]


def test_a_span_without_the_profiler_records_nothing(store, monkeypatch):
    def no_record_function(name):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(P, "record_function", no_record_function)
    with P.span("off", device="cpu", work=3) as s:
        with P.span("off.child"):
            pass
    assert store.records == [] and s.name == "off"


def test_a_span_records_only_in_the_profiled_thread(store, tmp_path):
    def other_thread():
        with P.span("other.thread"):
            pass

    def body():
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with P.span("this.thread"):
            pass

    prof = _profiled(body)
    assert [r.name for r in store.records] == ["this.thread"]
    names = {e["name"] for e in _annotations(prof, tmp_path)}
    assert "this.thread" in names and "other.thread" not in names


def test_nested_spans_record_parent_request_and_host_time(store):
    def body():
        with P.span("a", work=7):
            with P.span("a.b"):
                with P.span("a.b.c"):
                    pass
            with P.span("a.d"):
                pass
        with P.span("e"):
            pass

    _profiled(body)
    recs = store.records
    assert [(r.name, r.index, r.parent, r.request) for r in recs] == [
        ("a", 0, None, 0), ("a.b", 1, 0, 0), ("a.b.c", 2, 1, 0),
        ("a.d", 3, 0, 0), ("e", 4, None, 4)]
    assert recs[0].work == 7 and recs[1].work is None
    for r in recs:
        assert r.end_ns >= r.start_ns and r.events is None
        assert P.span_device_ms(r) is None and P.span_self_device_ms(r) is None
    # a child lies inside its parent on the host clock
    for r in recs[1:4]:
        p = recs[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert P.span_host_ms(r) <= P.span_host_ms(p)
    assert [r.name for r in P.spans("a.d")] == ["a.d"]
    assert len(P.spans()) == 5


class _Event:
    """A CUDA event's reading interface at a fixed device time (ms)."""

    def __init__(self, t):
        self.t = t
        self.waited = False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_self_device_time_is_the_span_less_its_children(store):
    def rec(name, t0, t1):
        i = store.open(name, events=(_Event(t0), _Event(t1)))
        return i

    root = rec("root", 0.0, 10.0)
    c1 = rec("c1", 1.0, 3.0)
    g = rec("c1.g", 1.5, 2.0)
    store.close(g)
    store.close(c1)
    plain = store.open("no-events")
    store.close(plain)
    c2 = rec("c2", 4.0, 8.5)
    store.close(c2)
    store.close(root)
    after = rec("after", 20.0, 21.0)
    store.close(after)
    r = store.records
    assert P.span_device_ms(r[root]) == 10.0
    # the grandchild is inside c1: only the children's time comes off
    assert P.span_self_device_ms(r[root]) == pytest.approx(10.0 - 2.0 - 4.5)
    assert P.span_self_device_ms(r[c1]) == pytest.approx(1.5)
    assert P.span_self_device_ms(r[after]) == 1.0
    assert all(e.waited for e in r[c2].events[1:])


def test_stage_timer_records_emits_and_shows_under_the_profiler(
        store, capsys, tmp_path):
    with P.stage_timer("stage.a", work=1000, emit=True):
        pass
    with P.stage_timer("stage.b"):
        pass
    rec = store.records[0]
    assert (rec.name, rec.work, rec.parent, rec.request) == (
        "stage.a", 1000, None, 0)
    assert rec.seconds >= 0 and store.records[1].name == "stage.b"
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line["event"] == "stage" and line["stage"] == "stage.a"
    assert line["work"] == 1000 and line["seconds"] == round(rec.seconds, 6)

    # under the profiler a stage is a user_annotation, and spans inside it
    # are its children
    def body():
        with P.stage_timer("stage.c"):
            with P.span("inside"):
                pass

    prof = _profiled(body)
    c, inside = store.records[2:]
    assert (inside.parent, inside.request) == (c.index, c.index)
    names = [e["name"] for e in _annotations(prof, tmp_path)]
    assert "stage.c" in names and "inside" in names


def test_stage_timer_closes_its_record_when_the_stage_raises(store):
    with pytest.raises(ValueError):
        with P.stage_timer("failing"):
            raise ValueError("boom")
    with P.stage_timer("next"):
        pass
    assert [(r.name, r.parent) for r in store.records] == [
        ("failing", None), ("next", None)]
    assert store.records[0].end_ns > 0


def test_the_kernel_build_prints_one_stage_line_and_none_on_a_hit(
        store, capsys, tmp_path, monkeypatch):
    lib = tmp_path / "hash" / "libife_kernels.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    calls = []

    def run_all(cmds):
        calls.append(cmds)
        for c in cmds:
            out = c[c.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"\0")
        return ["" for _ in cmds]

    monkeypatch.setattr(_build, "_run_all", run_all)
    cus, _ = _build._sources()
    assert _build.build() == lib and lib.is_file()
    assert [len(c) for c in calls] == [len(cus), 1]
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines()]
    assert [(x["event"], x["stage"], x["work"]) for x in lines] == [
        ("stage", "kernels.build", len(cus))]
    assert [r.name for r in store.records] == ["kernels.build"]
    assert _build.build() == lib
    assert capsys.readouterr().err == "" and len(calls) == 2


def test_the_log_tag_is_the_ports_process_id(monkeypatch):
    monkeypatch.delenv("JAX_PROCESS_INDEX", raising=False)
    monkeypatch.delenv("IFE_PROCESS_ID", raising=False)
    assert ife_logging._process_tag() == ""
    monkeypatch.setenv("JAX_PROCESS_INDEX", "5")
    assert ife_logging._process_tag() == ""
    monkeypatch.setenv("IFE_PROCESS_ID", "3")
    assert ife_logging._process_tag() == "p3"


SHAPE = (20, 18, 16)


def _scan(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=SHAPE).astype(np.float32)
    mask = (rng.random(SHAPE) > 0.3).astype(np.uint8) * 2
    return img, mask


@pytest.mark.parametrize("branch, name", [
    ("sweep", "features.sweep"), ("xs_stream", "features.xs_stream"),
    ("nc_conv+post", "features.nc_post")])
def test_the_dispatcher_records_its_branch_and_mask_spans(store, branch,
                                                          name):
    img, mask = _scan()
    img, mask = torch.from_numpy(img), torch.from_numpy(mask)
    want = fused_features8(img, mask, 1.1, (0.8, 0.9, 1.0), branch=branch)
    assert store.records == []
    got = []
    prof = _profiled(lambda: got.append(
        fused_features8(img, mask, 1.1, (0.8, 0.9, 1.0), branch=branch)),
        profile_memory=True)
    assert torch.equal(torch.nan_to_num(got[0], 7.0),
                       torch.nan_to_num(want, 7.0))
    voxels = img.numel()
    assert [(r.name, r.parent, r.request, r.work) for r in store.records] == [
        (name, None, 0, voxels), ("features.mask", 0, 0, voxels)]
    # the passes over the uint8 mask (ops that write a volume; a view writes
    # none): the cast alone for the sweep, which clamps in its kernel; the
    # clamp and the cast for the others
    spans = [e for e in prof.events() if e.name == "features.mask"]
    assert len(spans) == 1
    passes = [e.name for e in spans[0].cpu_children
              if e.cpu_memory_usage >= voxels]
    assert len(passes) == (1 if branch == "sweep" else 2), passes


def test_make_bag_device_records_its_span_tree(store, tmp_path):
    img, mask = _scan(1)
    sigmas = [0.6, 1.2]
    edges = [np.linspace(-1.5, 1.5, 5) for _ in range(8 * len(sigmas))]
    rois = [ROI((1, 1, 1), (7, 7, 7)), ROI((5, 4, 3), (7, 7, 7)),
            ROI((2, 3, 4), (6, 5, 4))]
    want = make_bag_device(img, mask, sigmas, edges, rois, device="cpu")
    assert store.records == []
    got = []
    prof = _profiled(lambda: got.append(
        make_bag_device(img, mask, sigmas, edges, rois, device="cpu")))
    np.testing.assert_array_equal(got[0], want)

    recs = store.records
    tree = [(r.name, recs[r.parent].name if r.parent is not None else None)
            for r in recs]
    # the mask's clamp runs on the device, inside the copies' span: no host
    # clamp to time; of the bytes staged none go through the page-locked
    # ring on the CPU; the bag is binned per scale and size class on the
    # device and fetched once, at the end
    assert tree == [("bag", None), ("bag.stage", "bag"),
                    ("bag.stage.h2d", "bag.stage"),
                    ("bag.stage.pinned", "bag.stage.h2d")] + [
                        ("bag.bin", "bag")] * 4 + [("bag.fetch", "bag")]
    assert all(r.request == 0 for r in recs)
    assert recs[0].work == len(rois)
    assert recs[2].work == img.nbytes + mask.nbytes
    assert recs[3].work == 0
    assert [r.work for r in recs[4:8]] == [2, 1] * 2
    assert recs[8].work == len(rois)

    # each span is a user_annotation of the chrome trace, inside "outer"
    events = _chrome_events(prof, tmp_path)
    outer = [e for e in events if e["name"] == "outer"
             and e.get("cat") == "user_annotation"]
    assert len(outer) == 1
    lo, hi = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    found = [e["name"] for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("bag")]
    assert sorted(found) == sorted(r.name for r in recs)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("bag"):
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi


@pytest.mark.gpu
def test_spans_on_the_card_read_events_and_never_synchronise(store):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `python -m "
                    "pytest --noconftest -m gpu tests/test_torch_profiling.py`")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    cycles = 200_000_000  # ~0.1 s at the H100's clock

    def body():
        with P.span("card", device=dev):
            with P.span("card.sleep", device=dev):
                torch.cuda._sleep(cycles)
        # the host got here with the sleep still queued: nothing waited
        assert not store.records[1].events[1].query()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        body()
    outer, inner = store.records
    assert P.span_host_ms(outer) < 20.0
    sleep_ms = P.span_device_ms(inner)
    assert sleep_ms > 20.0
    assert P.span_device_ms(outer) >= sleep_ms
    assert P.span_self_device_ms(outer) == pytest.approx(
        P.span_device_ms(outer) - sleep_ms)
    assert 0.0 <= P.span_self_device_ms(outer) < 5.0
