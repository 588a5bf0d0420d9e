"""bench_torch.py on the CPU, against bench.py and ife_tpu.

Each function bench_torch times is held against the ife_tpu calls bench.py
makes at the line its docstring names, on the same numpy inputs (made from a
seed); where bench.py's TPU branch calls a Pallas kernel, that kernel runs in
interpret mode as tests/test_kernels.py runs it, and the port's wrappers run
their plain PyTorch twins for CPU tensors. Tolerances, the repo's precision
policy (tests/test_torch_sweep.py):

  * f64: <= 1e-9 of max(max|reference|, 1) per channel; the three
    eigenvalue channels per channel, as value-sorted triples only where two
    magnitudes tie within twice the tolerance (tie_sorted_eigenvalues);
  * f32: smoothed <= 1e-4 relative, derivative channels <= 1e-3 of their
    scale;
  * histogram counts: equal.

Then the script itself: the gate's report under bench.py's keys, the JSON
line and the --all artifact under bench.py's keys, --resume, a failing
config, no JAX in its process, and no run on a host without a card unless
IFE_PLATFORM=cpu asks for the CPU. The gate on the card:
tests/test_torch_gpu.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import bench_torch as B
from ife_tpu.kernels import fused as JF
from ife_tpu.kernels import histogram as JH
from ife_tpu.ops import eigen as JE
from ife_tpu.ops import features as JO
from ife_tpu.stats import histogram as JS
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACING = B.SPACING
TOL64 = 1e-9
TOL32_SMOOTHED = 1e-4
TOL32_DERIVATIVE = 1e-3
EIG = (2, 3, 4)
SMALL = (32, 32, 32)
# bench.py's gate keys under the port's names: its second sweep scale (3.5
# -> 1.7) and the branches of the port's dispatcher and block path
RENAMED = (("_s35", "_s1.7"), ("[einsum+post_stream]", "[nc_conv+post]"),
           ("[in-kernel-mxu]", "[ys_multi]"),
           ("[sharded_staged_x_halo]", "[sharded_block_nc_conv+post]"))
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline",
                 "spread")


def _bench_py_artifact():
    """bench.py's TPU artifact (BENCH_DETAIL.json)."""
    with open(os.path.join(ROOT, "BENCH_DETAIL.json")) as f:
        return json.load(f)


def _bench_py_gate_keys():
    """bench.py's gate keys under the port's names: the recorded report's,
    and the unaligned entry bench.py:324 added after it was recorded."""
    keys = set(_bench_py_artifact()["verify_on_chip"]) | {
        "auto_unaligned_s1.0[sweep]"}
    out = set()
    for k in keys:
        for old, new in RENAMED:
            k = k.replace(old, new)
        out.add(k)
    return out


def _inputs(shape, seed, dtype=np.float64):
    """bench.py's gate inputs from numpy: normal * 200 - 600, a uniform >
    0.25 mask."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * 200.0 - 600.0).astype(dtype)
    m = (rng.random(shape) > 0.25).astype(dtype)
    return v, m


def _assert_close(got, want, tol, eig=()):
    """got / want: sequences of channels; relative to max(max|want|, 1) per
    channel, the channels at `eig` per channel outside ties."""
    got = [np.array(g, np.float64) for g in got]
    want = [np.array(w, np.float64) for w in want]
    if eig:
        scale = max(max(np.abs(want[i]).max() for i in eig), 1.0)
        gc, wc = tie_sorted_eigenvalues(
            [torch.from_numpy(got[i]) for i in eig],
            [torch.from_numpy(want[i]) for i in eig], 2 * tol * scale)
        err = max((g - w).abs().max().item() for g, w in zip(gc, wc))
        assert err <= tol * scale, ("eigenvalues", err / scale)
    for i in range(len(want)):
        if i not in eig:
            err = np.abs(got[i] - want[i]).max() / max(np.abs(want[i]).max(), 1.0)
            assert err <= tol, (i, err)


def _assert_f32(got, want):
    """8 channels in f32: smoothed <= 1e-4 relative, the derivative
    channels <= 1e-3 of their scale."""
    _assert_close(got[:1], want[:1], TOL32_SMOOTHED)
    _assert_close(got[1:], want[1:], TOL32_DERIVATIVE, eig=(1, 2, 3))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j_one_scale8(v, m, sigma):
    """bench.py's one_scale8 on the TPU (bench.py:474-477), its Pallas
    kernels in interpret mode."""
    k = (JF.fused_features8_sweep
         if JO.features8_dispatch_branch(sigma, SPACING, v.shape) == "sweep"
         else JF.fused_features8)
    return k(jnp.asarray(v), jnp.asarray(m), sigma, SPACING, stack=False,
             interpret=True)


# ---------------------------------------------------------------------------
# the timed functions against ife_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 11, 9)])
def test_headline_card_op_matches_the_pallas_stream_kernel(shape):
    x = np.random.default_rng(0).standard_normal(shape)
    want = JF.fused_hessian_eig_stream(jnp.asarray(x), SPACING, block=2,
                                       stack=False, interpret=True)[0]
    _assert_close([B.headline_card(_t(x))], [want], TOL64)
    got32 = B.headline_card(_t(x.astype(np.float32)))
    assert got32.dtype == torch.float32
    _assert_close([got32], [want], TOL32_DERIVATIVE)


def test_headline_cpu_op_matches_hessian_eig_features():
    x = np.random.default_rng(1).standard_normal((16, 15, 14))
    got = B.headline_cpu(_t(x))
    want = np.asarray(JO.hessian_eig_features(jnp.asarray(x), SPACING))[..., 0]
    _assert_close([got], [want], TOL64)
    assert B.headline_op(_t(x)).shape == x.shape  # CPU tensors: this route


def test_config1_op_matches_eigenvalue_features():
    h = np.random.default_rng(2).standard_normal((12, 10, 8, 6))
    got = B.config1_op(_t(h)).unbind(-1)
    want = np.moveaxis(np.asarray(JE.eigenvalue_features(jnp.asarray(h))), -1, 0)
    _assert_close(got, want, TOL64, eig=(0, 1, 2))


@pytest.mark.parametrize("sigma", B.CONFIG3_SCALES)
def test_one_scale8_matches_bench_py(sigma):
    v, m = _inputs(SMALL, 3)
    got = B.one_scale8(_t(v), _t(m), sigma)
    _assert_close(got, _j_one_scale8(v, m, sigma), TOL64, eig=EIG)
    v32, m32 = v.astype(np.float32), m.astype(np.float32)
    _assert_f32(B.one_scale8(_t(v32), _t(m32), sigma),
                _j_one_scale8(v, m, sigma))


def test_config3_forms_match_bench_py():
    v, m = _inputs(SMALL, 4)
    per = B.config3_per_scale(_t(v), _t(m))
    fused = B.config3_fused(_t(v), _t(m))
    assert len(per) == len(fused) == len(B.CONFIG3_SCALES)
    # bench.py's fused form (bench.py:506-513)
    want = [JF.fused_features8_sweep(jnp.asarray(v), jnp.asarray(m), s,
                                     SPACING, stack=False, interpret=True)
            for s in (0.6, 1.2)]
    want += list(JO.multiscale_features8_fused(
        jnp.asarray(v), jnp.asarray(m), (2.4, 4.8), SPACING, stack=False,
        interpret=True))
    for got, w in zip(fused, want):
        _assert_close(got, w, TOL64, eig=EIG)
    for s, got in zip(B.CONFIG3_SCALES, per):
        _assert_close(got, _j_one_scale8(v, m, s), TOL64, eig=EIG)


def test_config4_counts_match_bench_py():
    v, m = _inputs(SMALL, 5, np.float32)
    tv, tm = _t(v), _t(m)
    chans = B.one_scale8(tv, tm, 1.0)
    w = B.config4_weights(tm)
    got = B.config4_counts(chans, tv, w)
    assert got.dtype == torch.int32 and got.shape == (9, 32)
    assert int(got[0].sum()) == int(m.sum())
    # bench.py:573-574, the Pallas histogram in interpret mode, on the same
    # channels
    want = JH.histogram_counts_multi(
        [jnp.asarray(c.numpy()) for c in chans] + [jnp.asarray(v)],
        jnp.asarray(B.CONFIG4_EDGES), weights=jnp.asarray(w.numpy()),
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config4_composed_matches_bench_py():
    v, m = _inputs(SMALL, 6, np.float32)
    got = B.config4_composed(_t(v), _t(m))
    assert got.dtype == torch.int32 and got.shape == (8, 32)
    # bench.py:600-604: histogram_counts of each channel under the mask, on
    # the channels the port binned (the features themselves:
    # test_one_scale8_matches_bench_py)
    chans = B.one_scale8(_t(v), _t(m), 1.0)
    w = jnp.asarray((m != 0).ravel().astype(np.int32))
    want = np.stack([np.asarray(JS.histogram_counts(
        jnp.asarray(c.numpy().ravel()), jnp.asarray(B.CONFIG4_EDGES),
        weights=w)) for c in chans])
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate_report():
    """The gate at its own shape (bench.py's 128^3) on the CPU: the kernels'
    twins against the composed ops."""
    return B.verify_on_card(device="cpu")


def test_gate_reports_bench_py_entries_under_the_port_names(gate_report):
    want = _bench_py_gate_keys()
    assert want <= set(gate_report), want - set(gate_report)
    extra = set(gate_report) - want
    # beside each sorted-triple eigenvalue entry, the per-channel one
    assert extra == {k.replace("eig_sorted", "eig_channel")
                     for k in want if "eig_sorted" in k}
    assert all(v < B.TOL for v in gate_report.values()), gate_report
    branches = {k.split("[")[1] for k in gate_report if k.startswith("auto_s")}
    assert branches == {"sweep]", "xs_stream]", "nc_conv+post]"}


def test_gate_fails_on_a_disagreeing_kernel(monkeypatch):
    """A kernel off by more than the bound fails the gate with its entry."""
    from ife_tpu_torch.kernels import normalized_conv

    real = normalized_conv.fused_normalized_conv_sweep
    monkeypatch.setattr(normalized_conv, "fused_normalized_conv_sweep",
                        lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    with pytest.raises(AssertionError, match="nc_sweep_s48"):
        B.verify_on_card((16, 16, 16), device="cpu")


def test_gate_needs_three_branches(monkeypatch):
    monkeypatch.setattr(B, "GATE_AUTO_SIGMAS", (1.0, 1.2, 2.4))
    with pytest.raises(AssertionError, match="fewer than 3 branches"):
        B.verify_on_card((16, 16, 16), device="cpu")


F32_SLACK = 1.25  # how much farther from f64 a port path may sit
F32_PATHS = ("ife_tpu kernel", "ife_tpu ops", "port twin", "port ops",
             "port ops in tap order")


def f32_distances(shape, sigmas=(2.4, 4.8)):
    """bench.py's gate metric (_worst) of four f32 paths from one reference,
    the port's composed ops in f64, on the gate's inputs of `shape`
    (gate_inputs on the CPU) at the gate's two ys_multi scales: ife_tpu's
    multiscale_features8_fused (its Pallas kernel in interpret mode),
    ife_tpu's features8 (XLA ops), the port's multiscale_features8_fused
    (the ys_multi kernel's twins) and the port's features8; beside them the
    port's features8 with its Gaussian summed in the kernels' tap order
    (kernel_smooth_axis), as the port summed it before ops.stencil._fir.
    {sigma: {path: (worst, per-channel errors)}}."""
    from unittest import mock

    from ife_tpu_torch.ops import stencil as TS
    from ife_tpu_torch.ops.features import (
        features8, multiscale_features8_fused)

    img, msk = B.gate_inputs(tuple(shape), "cpu")
    ji, jm = jnp.asarray(img.numpy()), jnp.asarray(msk.numpy())
    j_multi = torch.from_numpy(np.array(JO.multiscale_features8_fused(
        ji, jm, sigmas, SPACING, interpret=True, stack=True)))
    t_multi = multiscale_features8_fused(img, msk, sigmas, SPACING)
    out = {}
    for k, sigma in enumerate(sigmas):
        ref = features8(img.double(), msk.double(), sigma, SPACING).unbind(-1)
        with mock.patch.object(TS, "gaussian_smooth_axis",
                               TS.kernel_smooth_axis):
            tap_order = features8(img, msk, sigma, SPACING)
        paths = zip(F32_PATHS, (
            j_multi[k].unbind(0),
            torch.from_numpy(np.array(JO.features8(ji, jm, sigma, SPACING))
                             ).unbind(-1),
            t_multi[k].unbind(0),
            features8(img, msk, sigma, SPACING).unbind(-1),
            tap_order.unbind(-1)))
        out[sigma] = {name: (B._worst(got, ref), B._feature_errs(got, ref)[0])
                      for name, got in paths}
    return out


@pytest.fixture(scope="module")
def f32_distances_48():
    return f32_distances((48, 48, 48))


@pytest.mark.parametrize("sigma", [2.4, 4.8])
def test_f32_paths_sit_no_farther_from_f64_than_ife_tpus(f32_distances_48,
                                                         sigma):
    """At 48^3: the twin of the ys_multi kernel no farther from f64 than
    ife_tpu's Pallas kernel, the port's f32 composed ops no farther than
    ife_tpu's f32 composed ops, each within F32_SLACK. The composed ops'
    Gaussian sums each pair of samples that shares a tap first and the pairs
    from the outermost tap in (ops.stencil._fir); summed in tap order, as
    the kernels sum, they sat 1.5x (sigma 2.4) and 2.1x (4.8) as far as
    ife_tpu's here, and the second assert failed."""
    d = {name: worst for name, (worst, _) in f32_distances_48[sigma].items()}
    assert d["port twin"] <= F32_SLACK * d["ife_tpu kernel"], d
    assert d["port ops"] <= F32_SLACK * d["ife_tpu ops"], d


# ---------------------------------------------------------------------------
# the script
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_small(monkeypatch, gate_report):
    """IFE_PLATFORM=cpu, the CPU shapes shrunk, one call a run, and the
    gate's report computed once (gate_report)."""
    monkeypatch.setenv("IFE_PLATFORM", "cpu")
    monkeypatch.setitem(B.HEADLINE_SHAPE, "cpu", (16, 16, 16))
    monkeypatch.setitem(B.CONFIG3_SHAPE, "cpu", (16, 16, 16))
    monkeypatch.setitem(B.CONFIG4_SHAPE, "cpu", (16, 16, 16))
    monkeypatch.setattr(B, "CONFIG1_SHAPE", (8, 8, 8, 6))
    monkeypatch.setattr(B, "CONFIG2_SHAPE", (16, 16, 16))
    monkeypatch.setattr(B, "CALLS", 1)
    monkeypatch.setattr(B, "REPS", 1)
    monkeypatch.setattr(B, "verify_on_card", lambda **k: dict(gate_report))


def test_headline_line_has_bench_py_keys(cpu_small, capsys):
    assert B.main([]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(HEADLINE_KEYS) <= set(out)
    assert out["metric"] == "hessian_eig_voxels_per_sec_chip_16cubed_cpu"
    assert out["unit"] == "voxels/sec/chip" and out["baseline"] == "pinned"
    assert out["value"] > 0 and out["spread"]["reps"] == 1
    assert out["spread"]["worst"] <= out["value"] <= out["spread"]["best"]
    with open(B.BASELINE_FILE) as f:
        pinned = json.load(f)["voxels_per_sec"]
    assert out["vs_baseline"] == pytest.approx(out["value"] / pinned)
    assert out["device"] == {"name": "cpu", "power_limit_w": None}
    assert "verify" not in out  # bench.py adds the gate on the chip alone
    assert out["launches"] == {}  # CPU tensors run the twins, no kernel


def test_verify_line(cpu_small, capsys):
    assert B.main(["--verify"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.pop("verify") == "ok" and out.pop("launches") == {}
    assert _bench_py_gate_keys() <= set(out)


def test_all_artifact_has_bench_py_keys(cpu_small, tmp_path, monkeypatch,
                                       capsys):
    monkeypatch.chdir(tmp_path)
    assert B.main(["--all"]) == 0
    # the default artifact, never bench.py's record BENCH_DETAIL.json
    assert os.listdir(tmp_path) == ["BENCH_DETAIL_TORCH.json"]
    detail = json.loads((tmp_path / "BENCH_DETAIL_TORCH.json").read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == detail
    assert set(_bench_py_artifact()) | {"power_limit_w", "launches"} == set(detail)
    assert detail["platform"] == "cpu" and detail["device"] == "cpu"
    assert detail["config3_shape"] == detail["config4_shape"] == [16, 16, 16]
    assert all(v > 0 for k, v in detail.items()
               if k.endswith(("_per_sec", "_ms")))
    assert _bench_py_gate_keys() <= set(detail["verify_on_chip"])


def test_resume_skips_the_configs_present(cpu_small, tmp_path, monkeypatch):
    out_path = tmp_path / "detail.json"
    kept = {"config1_eigen_64cubed_voxels_per_sec": 1.0,
            "config2_hessian_eig_128cubed_voxels_per_sec": 2.0,
            "verify_on_chip": {"kept": 0.0}}
    out_path.write_text(json.dumps(kept))

    def refuse(*a, **k):
        raise AssertionError("a config the artifact has ran again")

    monkeypatch.setattr(B, "config1_op", refuse)
    monkeypatch.setattr(B, "headline_op", refuse)
    monkeypatch.setattr(B, "verify_on_card", refuse)
    assert B.main(["--all", "--resume", "--out", str(out_path)]) == 0
    detail = json.loads(out_path.read_text())
    assert {k: detail[k] for k in kept} == kept
    assert "config3_per_scale_voxels_per_sec" in detail
    assert "config4_feat_ms" in detail


def test_a_failing_config_writes_the_artifact_and_raises(cpu_small, tmp_path,
                                                         monkeypatch):
    out_path = tmp_path / "detail.json"
    real = B.config3_per_scale

    def fail(*a, **k):
        raise RuntimeError("no such kernel")

    monkeypatch.setattr(B, "config3_per_scale", fail)
    with pytest.raises(RuntimeError, match="no such kernel"):
        B.main(["--all", "--out", str(out_path)])
    detail = json.loads(out_path.read_text())
    assert "config2_hessian_eig_128cubed_voxels_per_sec" in detail
    assert detail["config3_error"] == "RuntimeError: no such kernel"
    assert "config4_feat_ms" not in detail
    # resume runs the failed config again, and its error goes
    monkeypatch.setattr(B, "config3_per_scale", real)
    assert B.main(["--all", "--resume", "--out", str(out_path)]) == 0
    detail = json.loads(out_path.read_text())
    assert "config3_error" not in detail and "config4_feat_ms" in detail


def _run(code, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)


def test_the_script_imports_neither_jax_nor_ife_tpu(tmp_path):
    code = f"""
import json, sys
import bench_torch as B
B.HEADLINE_SHAPE["cpu"] = B.CONFIG3_SHAPE["cpu"] = B.CONFIG4_SHAPE["cpu"] = (16, 16, 16)
B.CONFIG1_SHAPE, B.CONFIG2_SHAPE, B.CALLS, B.REPS = (8, 8, 8, 6), (16, 16, 16), 1, 1
assert B.main([]) == 0
try:  # every module the gate reaches, imported at its start
    B.verify_on_card((16, 16, 16))
except AssertionError:
    pass
B.verify_on_card = lambda **k: {{}}
assert B.main(["--all", "--out", {str(tmp_path / "d.json")!r}]) == 0
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ife_tpu"))))
"""
    res = _run(code, {"IFE_PLATFORM": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a card")
def test_without_a_card_the_script_exits_non_zero():
    res = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={k: v for k, v in os.environ.items()
                              if k != "IFE_PLATFORM"})
    assert res.returncode != 0
    assert "IFE_PLATFORM=cpu" in res.stderr
    assert res.stdout == ""


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_bench.py [N]: f32_distances at
    # N^3 (default the gate's 128^3), on the CPU under x64 as the tests run
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else B.GATE_SHAPE[0]
    for sigma, paths in f32_distances((n, n, n)).items():
        for name, (worst, per_channel) in paths.items():
            print(f"{n}^3 sigma {sigma} {name}: {worst:.4e}; per channel "
                  + " ".join(f"{e:.2e}" for e in per_channel))
