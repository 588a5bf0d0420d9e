"""features_roofline_pct's floor arithmetic, pinned by hand, and its
reading of a trace."""
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from ifebench.harness import load_module
from ifebench.trace import Trace

METRICS = Path(__file__).resolve().parent.parent / "metrics"
roof = load_module(METRICS / "features_roofline_pct.py", "metrics")

SHAPE = (512, 512, 400)
SPACING = (0.78, 0.78, 1.0)
VOXELS = 512 * 512 * 400


def test_bytes_term_is_37_bytes_a_voxel_at_3_35_tb_s():
    assert VOXELS * 37 == 3_879_731_200
    assert roof.bytes_ms(SHAPE) == pytest.approx(1.158128716, rel=1e-9)


@pytest.mark.parametrize("sigma, radii, ms", [
    # taps (2r+1) over x, y, z; FLOP a masked voxel = 4 * taps + 93
    (0.6, (4, 4, 3), VOXELS * (4 * 25 + 93) / 67e12 * 1e3),
    (1.2, (7, 7, 6), VOXELS * (4 * 43 + 93) / 67e12 * 1e3),
    (2.4, (14, 14, 11), VOXELS * (4 * 81 + 93) / 67e12 * 1e3),
    (4.8, (28, 28, 22), VOXELS * (4 * 159 + 93) / 67e12 * 1e3),
])
def test_operations_term_under_a_mask_of_ones(sigma, radii, ms):
    assert tuple(roof.radius(sigma, h, 4.5) for h in SPACING) == radii
    assert roof.flop_ms(sigma, SPACING, 4.5, VOXELS) == pytest.approx(ms)


def test_values_of_the_terms():
    assert [round(roof.flop_ms(s, SPACING, 4.5, VOXELS), 4)
            for s in (0.6, 1.2, 2.4, 4.8)] == [0.3021, 0.4147, 0.6526, 1.1409]
    # every scale is bound by bytes, under the lung mask and under ones
    for count in (VOXELS // 10, VOXELS):
        total = sum(roof.floor_ms(SHAPE, SPACING, s, 4.5, count)
                    for s in (0.6, 1.2, 2.4, 4.8))
        assert total == pytest.approx(4 * 1.158128716, rel=1e-9)
    # past 740 FLOP a masked voxel (37 B x 67 / 3.35) the operations bound
    assert roof.floor_ms(SHAPE, SPACING, 6.0, 4.5, VOXELS) == \
        roof.flop_ms(6.0, SPACING, 4.5, VOXELS) > roof.bytes_ms(SHAPE)


def _trace(device_intervals, scans):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "ifebench.scan",
           "ts": a, "dur": b - a} for a, b in scans]
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a}
           for i, (a, b) in enumerate(device_intervals)]
    return Trace(ev, len(scans))


def test_share_of_the_busy_time_and_nothing_without_a_trace():
    run = SimpleNamespace(shape=SHAPE, spacing=SPACING, sigmas=(0.6, 4.8),
                          truncate=4.5, mask_counts=[VOXELS], mask_bytes=1)
    # two scans, 10 ms of device time in all (the overlap counted once)
    t = _trace([(0, 4000), (3000, 6000), (7000, 10000)],
               [(0, 5000), (5000, 10500)])
    ctx = SimpleNamespace(trace=t, run=run, traced_slots=[0, 0])
    want = 2 * (1.158128716 + roof.flop_ms(4.8, SPACING, 4.5, VOXELS) * 0
                + max(1.158128716, roof.flop_ms(4.8, SPACING, 4.5, VOXELS)))
    assert t.busy_s == pytest.approx(9e-3)
    assert roof.read(ctx) == pytest.approx(100 * want / 9.0)
    ctx.trace = None
    assert roof.read(ctx) is None
    ctx.trace = _trace([], [(0, 100)])
    assert roof.read(ctx) is None


def test_idle_share_and_gaps():
    idle = load_module(METRICS / "device_idle_pct.py", "metrics")
    t = _trace([(0, 4000), (3000, 6000), (7000, 10000)], [(0, 12000)])
    assert idle.read(SimpleNamespace(trace=t)) == pytest.approx(
        100 * (1 - 9 / 12))
    assert t.idle_gaps() == [(6000, 7000), (10000, 12000)]
    assert math.isclose(sum(v for _, v in t.breakdown()["idle_gaps"]), 3e-3)
