"""Runs of the harness on the CPU at a small size: the last line's shape,
a cell added as files, no result without a card, no JAX in the process."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ifebench import harness

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(shape=(48, 48, 40), roi_size=(9, 9, 9), n_rois=4, pool=2)
CELLS = ("mil-bag-4s.lung", "ct-features-4s.lung", "ct-features-4s.full")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run_small(cell, trace=0, root=ROOT, **kw):
    return harness.run_cell(cell, 2**31 + 99, 0.3, trace, time.perf_counter(),
                            root=root, device="cpu", overrides=SMALL,
                            log=lambda msg: None, **kw)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_shape(cell, trace):
    r = run_small(cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(r)
    assert isinstance(r["correct"], bool) and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    spec = json.loads((ROOT / "ifebench/workloads" / f"{cell}.json").read_text())
    assert set(r["checks"]) == set(spec["check"]["limits"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if trace:
        # the CPU's trace holds no device record: the device metrics stay out
        assert r["metrics"] == {}
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = ({"bags_per_s", "bag_ms_p95"} if cell.startswith("mil-bag")
                else {"scans_per_s", "scan_ms_p95"})
        assert set(r["metrics"]) == want | {"setup_s"}


def test_a_cell_added_as_files_is_found_and_runs(tmp_path):
    shutil.copytree(ROOT / "ifebench", tmp_path / "ifebench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ct-features-4s.few", "config":
                               "ct-features-4s", "traffic": "few", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "scans_total", "unit": "scans",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "scans_per_s",
                               "workloads": ["ct-features-4s.few"]})
    bench["end_to_end"].append({"name": "scans_seen", "unit": "scans",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["ct-features-4s.few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = json.loads((ROOT / "ifebench/workloads/ct-features-4s.full.json")
                      .read_text())
    spec["traffic"].update(name="few", pool=3)
    (tmp_path / "ifebench/workloads/ct-features-4s.few.json").write_text(
        json.dumps(spec))
    for name in ("scans_total", "scans_seen"):
        (tmp_path / f"ifebench/metrics/{name}.py").write_text(
            "def read(ctx):\n    return ctx.scans\n")
    cell = harness.load_cell("ct-features-4s.few", tmp_path)
    assert cell.spec["traffic"]["pool"] == 3
    assert [m["name"] for m in cell.end_to_end][-1] == "scans_seen"
    r = run_small("ct-features-4s.few", 0, tmp_path)
    assert r["metrics"]["scans_seen"]["value"] == r["attempted"]
    r = run_small("ct-features-4s.few", 1, tmp_path)
    assert r["metrics"]["scans_total"]["value"] == r["attempted"]
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell", tmp_path)


def test_no_result_and_a_nonzero_exit_without_a_card():
    p = subprocess.run([sys.executable, "-m", "ifebench.run", "--workload",
                        "ct-features-4s.lung", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys\n"
            "from ifebench import harness, run, calibrate, make_edges\n"
            "for c in %r:\n"
            "    cell = harness.load_cell(c)\n"
            "    e = cell.module('entries', cell.spec['entry'])\n"
            "    cell.module('checks', e.CHECK_OUTPUT)\n"
            "    [cell.module('metrics', m['name'])\n"
            "     for m in cell.end_to_end + cell.per_layer]\n"
            "print(harness.banned_modules())\n" % (CELLS,))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
    # whole top-level names are compared: ife_tpu_torch is not ife_tpu
    import ife_tpu_torch  # noqa: F401
    assert "ife_tpu" not in harness.banned_modules()


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run([sys.executable, "-m", "ifebench.run", "--workload",
                        "ct-features-4s.lung", "--seed", "2147483999",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
