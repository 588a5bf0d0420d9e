"""The harness: finds a cell by its name, makes its inputs from the seed,
warms up, times the closed loop for the window, traces a few scans when
asked, checks what the timed path produced against the reference, and
reads the cell's metrics.

A cell is ``workloads/<cell>.json`` (its configuration, entry, traffic and
check limits) under the entry of BENCHMARK.json's ``workloads`` that names
it; its configuration is the file BENCHMARK.json's ``configs`` names. The
entry is ``entries/<entry>.py`` (a class ``Entry(run)`` with ``scan(slot,
keep)``, and ``CHECK_OUTPUT``, the name of ``checks/<name>.py``), and each
metric of the cell is ``metrics/<metric>.py`` (``read(ctx)``, returning
None where it finds nothing to read). Adding any of them is adding files.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ifebench import inputs, trace as tracing

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "ife_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """The module of one file, imported by its path (names may hold '.')."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    tag = re.sub(r"\W", "_", f"ifebench_{kind}_{path.stem}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_metrics(metrics, name):
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


@dataclass
class Cell:
    name: str
    root: Path
    workload: dict
    spec: dict
    config: dict
    end_to_end: list
    per_layer: list

    def module(self, kind: str, name: str):
        return load_module(self.root / "ifebench" / kind / f"{name}.py",
                           kind)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    spec = load_json(root / "ifebench" / "workloads" / f"{name}.json")
    if spec["config"] != w["config"] or spec["traffic"]["name"] != w["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json "
                         f"on its config or traffic")
    return Cell(name, root, w, spec, config,
                _cell_metrics(bench["end_to_end"], name),
                _cell_metrics(bench["per_layer"], name))


@dataclass
class Run:
    """What a run's entry, check and metrics read: the configuration's
    sizes, the pool of scans, the ROIs and edges of a bag configuration."""
    cell: Cell
    seed: int
    device: torch.device
    overrides: dict = field(default_factory=dict)
    pool: list = field(default_factory=list)
    host_pool: list = field(default_factory=list)
    rois: dict = field(default_factory=dict)
    mask_counts: list = field(default_factory=list)
    edges: list = None

    def __post_init__(self):
        cfg, traffic = self.cell.config, self.cell.spec["traffic"]
        scan = cfg["scan"]
        self.shape = tuple(self.overrides.get("shape", scan["shape"]))
        self.spacing = tuple(float(h) for h in scan["spacing"])
        self.sigmas = tuple(float(s) for s in cfg["sigmas"])
        self.truncate = float(cfg["truncate"])
        self.pool_size = int(self.overrides.get("pool", traffic["pool"]))
        self.mask_kind = traffic["mask"]
        self.residency = traffic["residency"]
        self.mask_bytes = 1
        bag = cfg.get("bag")
        if bag:
            self.roi_size = tuple(self.overrides.get("roi_size",
                                                     bag["roi_size"]))
            self.n_rois = int(self.overrides.get("n_rois", bag["n_rois"]))
            self.bins = int(bag["bins"])
            self.edges = inputs.load_edges(
                self.cell.root / "ifebench" / "configs" / bag["edges"],
                8 * len(self.sigmas), self.bins)

    def make_pool(self):
        for slot in range(self.pool_size):
            image, mask = inputs.make_scan(self.cell.config["scan"],
                                           self.mask_kind, self.seed, slot,
                                           self.pool_size, self.device,
                                           self.shape)
            self.mask_counts.append(int(mask.sum(dtype=torch.int64)))
            mask_np = None
            if self.residency == "host" or self.edges is not None:
                mask_np = mask.cpu().numpy()
            if self.edges is not None:
                self.rois[slot] = inputs.draw_rois(
                    mask_np, self.n_rois, self.roi_size, self.seed, slot)
            if self.residency == "host":
                self.host_pool.append((image.cpu().numpy(), mask_np))
            else:
                self.pool.append((image, mask))
            del image, mask

    def scan_tensors(self, slot):
        """(image, mask) of a slot on the run's device."""
        if self.pool:
            return self.pool[slot]
        image, mask = self.host_pool[slot]
        return (torch.from_numpy(image).to(self.device),
                torch.from_numpy(mask).to(self.device))


class Window:
    """The closed loop: one scan in flight, the next when the call returns,
    slots in turn. Keeps every output (sample None) or a reservoir sample of
    `sample` scans drawn from the seed."""

    def __init__(self, run, entry, sample):
        self.run, self.entry, self.sample = run, entry, sample
        self.rng = np.random.default_rng(np.random.SeedSequence([run.seed, 9]))
        self.latencies_ms, self.held = [], []
        self.scans = 0
        self.window_s = 0.0
        self.cuda = run.device.type == "cuda"

    def _scan_timed(self, slot, keep):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.entry.scan(slot, keep)
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end)
        t = time.perf_counter()
        out = self.entry.scan(slot, keep)
        return out, (time.perf_counter() - t) * 1e3

    def run_for(self, seconds):
        t0 = time.perf_counter()
        while True:
            n, slot = self.scans, self.scans % self.run.pool_size
            if self.sample is None or n < self.sample:
                keep, at = True, len(self.held)
            else:
                at = int(self.rng.integers(0, n + 1))
                keep = at < self.sample
            out, ms = self._scan_timed(slot, keep)
            self.latencies_ms.append(ms)
            if keep:
                if at == len(self.held):
                    self.held.append((n, slot, out))
                else:
                    self.held[at] = (n, slot, out)
            del out
            self.scans += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                self.window_s = t1 - t0
                return


@dataclass
class Context:
    """What a metric reader reads."""
    run: Run
    setup_s: float
    scans: int
    window_s: float
    latencies_ms: list
    trace: object = None
    traced_slots: list = field(default_factory=list)


def _warm(run, entry, sample):
    """One scan of every slot; as many outputs held at once as the window
    will hold (its sample and the scan that may replace one), so that the
    window's allocations all come from the allocator's cache."""
    hold = run.pool_size if sample is None else min(run.pool_size, sample + 1)
    kept = []
    for slot in range(run.pool_size):
        kept.append(entry.scan(slot, len(kept) < hold))
    del kept
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def _launches():
    from ife_tpu_torch.kernels._build import LAUNCHES
    return dict(LAUNCHES)


def _power_limit_w(device):
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def run_cell(name, seed, seconds, trace, t_start, root=ROOT, device=None,
             overrides=None, entry_class=None, warm=True, log=None):
    """One run of one cell. Returns the result dict (the last line's
    object). `device` None takes the card; the tests pass "cpu", small
    `overrides` ("shape", "roi_size", "n_rois", "pool") and, to break the
    timed path, an `entry_class`; a control (calibrate.py) skips the
    warm-up."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    marks = [("start to harness", time.perf_counter())]
    cell = load_cell(name, root)
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        marks.append(("CUDA context", time.perf_counter()))
    entry_mod = cell.module("entries", cell.spec["entry"])
    check_mod = cell.module("checks", entry_mod.CHECK_OUTPUT)
    check_spec = cell.spec["check"]
    sample = check_spec.get("sample_scans")
    marks.append(("program import", time.perf_counter()))

    run = Run(cell, int(seed), dev, dict(overrides or {}))
    run.make_pool()
    marks.append(("pool", time.perf_counter()))
    entry = (entry_class or entry_mod.Entry)(run)
    if warm:
        _warm(run, entry, sample)
    marks.append(("warm-up", time.perf_counter()))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = _launches()
    prev, steps = t_start, []
    for what, t in marks:
        steps.append(f"{what} {t - prev:.3f}")
        prev = t
    log(f"[ifebench] set-up s: {', '.join(steps)}; pool of {run.pool_size} "
        f"scans {run.shape}, masked voxels {run.mask_counts}")

    setup_s = time.perf_counter() - t_start
    window = Window(run, entry, sample)
    window.run_for(seconds)
    launches = {k: (v - launches0[k]) / window.scans
                for k, v in _launches().items() if v != launches0[k]}
    log(f"[ifebench] window {window.window_s:.3f} s, {window.scans} scans; "
        f"launches a scan {json.dumps(launches, sort_keys=True)}")

    ctx = Context(run, setup_s, window.scans, window.window_s,
                  window.latencies_ms)
    if trace:
        n = int(cell.spec["traffic"]["trace_scans"])
        first = window.scans
        ctx.traced_slots = [(first + i) % run.pool_size for i in range(n)]
        ctx.trace = tracing.record(
            lambda i: entry.scan(ctx.traced_slots[i], False), n, cuda)

    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = check_spec["limits"]
    t = time.perf_counter()
    readings, compared, failed = check_mod.check(run, window.held, limits)
    log(f"[ifebench] check of {compared} outputs {time.perf_counter() - t:.3f} s")
    window.held.clear()
    correct = (compared > 0 and failed == 0
               and all(readings[k] <= limits[k] for k in limits))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if cuda:
        device_info["power_limit_w"] = _power_limit_w(dev)
    result = {"correct": bool(correct), "attempted": window.scans,
              "failed": int(failed), "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in limits}
    return result
