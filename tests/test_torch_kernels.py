"""ife_tpu_torch's kernel modules on the CPU: each wrapper, given CPU
tensors, runs its plain PyTorch twin; the twin is held against the Pallas
kernel it replaces, run in interpret mode as tests/test_kernels.py runs it,
on the same numpy inputs in f64 at <= 1e-9 (eigenvalue channels as
value-sorted triples, normalized convolution inside the mask). The y/z
smoothing ahead of the xs-stream kernel, which ife_tpu runs as XLA ops, is
held against ife_tpu.ops.stencil at <= 1e-12.

The CUDA kernels themselves are tested on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu.kernels import fused as JF
from ife_tpu_torch import kernels as K
from ife_tpu_torch.kernels import _build
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues

torch.set_num_threads(1)

SHAPES = [(16, 16, 16), (13, 12, 11)]
SPACING = (0.7, 0.9, 1.2)
TOL = 1e-9


def _inputs(shape, seed=2, radius_frac=0.45):
    img = np.array(j_synthetic_ct(shape, seed=seed, dtype=jnp.float64).data)
    mask = np.array(j_sphere_mask(shape, radius_frac).data).astype(np.float64)
    return img, mask


def _assert_features(got, want, eig, tol=TOL):
    """got/want: sequences of (X, Y, Z) channels."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    gs = np.sort(np.stack([got[i] for i in eig]), 0)
    ws = np.sort(np.stack([want[i] for i in eig]), 0)
    assert np.abs(gs - ws).max() / max(np.abs(ws).max(), 1.0) <= tol
    # and per channel outside the ties (margin 2 tol of the joint scale):
    # an eigenvalue in another channel than the reference's fails
    scale = max(np.abs(ws).max(), 1.0)
    gc, wc = tie_sorted_eigenvalues(
        [torch.from_numpy(np.array(got[i], np.float64)) for i in eig],
        [torch.from_numpy(np.array(want[i], np.float64)) for i in eig],
        2 * tol * scale)
    assert max((g - w).abs().max().item() for g, w in zip(gc, wc)) <= tol * scale
    for i in range(len(want)):
        if i not in eig:
            err = np.abs(got[i] - want[i]).max() / max(np.abs(want[i]).max(), 1.0)
            assert err <= tol, (i, err)


@pytest.mark.parametrize("shape", SHAPES)
def test_hessian_eig_twin_matches_pallas_interpret(shape):
    img, _ = _inputs(shape)
    got = K.fused_hessian_eig_stream(torch.from_numpy(img), SPACING)
    want = JF.fused_hessian_eig_stream(jnp.asarray(img), SPACING, interpret=True)
    assert got.shape == (6,) + shape
    _assert_features(got.numpy(), np.asarray(want), (0, 1, 2))


def test_hessian_eig_unstacked_and_alias():
    img, _ = _inputs((9, 8, 7))
    x = torch.from_numpy(img)
    stacked = K.fused_hessian_eig_stream(x, SPACING)
    parts = K.fused_hessian_eig(x, SPACING, stack=False)
    # fused_hessian_eig's default variant is the stream kernel's function
    assert torch.equal(K.fused_hessian_eig(x, SPACING), stacked)
    assert len(parts) == 6
    assert all(torch.equal(p, s) for p, s in zip(parts, stacked))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 1.2])
def test_normalized_conv_twin_matches_pallas_interpret(shape, sigma):
    img, mask = _inputs(shape)
    got = K.fused_normalized_conv_sweep(torch.from_numpy(img),
                                        torch.from_numpy(mask), sigma,
                                        SPACING).numpy()
    want = np.asarray(JF.fused_normalized_conv_sweep(
        jnp.asarray(img), jnp.asarray(mask), sigma, SPACING, interpret=True))
    inside = mask != 0
    assert np.abs(got - want)[inside].max() / np.abs(want[inside]).max() <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 1.2])
def test_features8_post_twin_matches_pallas_interpret(shape, sigma):
    img, mask = _inputs(shape, seed=4, radius_frac=0.3)
    s = np.array(JF.fused_normalized_conv_sweep(
        jnp.asarray(img), jnp.asarray(mask), sigma, SPACING, interpret=True))
    if sigma < 1:  # the corners lie beyond the smoothing support: 0/0
        assert np.isnan(s).any()
    got = K.fused_features8_post_stream(torch.from_numpy(s),
                                        torch.from_numpy(mask), SPACING)
    want = JF.fused_features8_post_stream(jnp.asarray(s), jnp.asarray(mask),
                                          SPACING, interpret=True)
    assert got.shape == (8,) + shape
    assert bool(torch.isfinite(got).all())  # NaN selected away, not multiplied
    _assert_features(got.numpy(), np.asarray(want), (2, 3, 4))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 1.2])
def test_features8_sweep_twin_matches_pallas_interpret(shape, sigma):
    img, mask = _inputs(shape, seed=5)
    labels = mask * 3.0  # the sweep clamps the mask itself
    got = K.fused_features8_sweep(torch.from_numpy(img),
                                  torch.from_numpy(labels), sigma, SPACING)
    want = JF.fused_features8_sweep(jnp.asarray(img), jnp.asarray(labels),
                                    sigma, SPACING, interpret=True)
    assert got.shape == (8,) + shape
    assert bool(torch.isfinite(got).all())
    _assert_features(got.numpy(), np.asarray(want), (2, 3, 4))


def _yz_smoothed(img, mask, sigma):
    """ife_tpu's y/z smoothing ahead of its xs-stream kernel
    (kernels/fused.py fused_features8, xs_stream branch)."""
    from ife_tpu.ops.stencil import gaussian_smooth_axis

    def yz(v):
        v = gaussian_smooth_axis(v, 1, sigma, SPACING[1])
        return gaussian_smooth_axis(v, 2, sigma, SPACING[2])

    m = jnp.asarray(mask)
    return yz(jnp.asarray(img) * m), yz(m)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [1.2, 2.4])
def test_smooth_yz_twin_matches_ife_tpu(shape, sigma):
    img, mask = _inputs(shape)
    got = K.fused_smooth_yz(torch.from_numpy(img), torch.from_numpy(mask),
                            sigma, SPACING)
    for g, w in zip(got, _yz_smoothed(img, mask, sigma)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() <= 1e-12


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [1.2, 2.4])
def test_features8_xs_stream_twin_matches_pallas_interpret(shape, sigma):
    img, mask = _inputs(shape, seed=6, radius_frac=0.35)
    num, den = _yz_smoothed(img, mask, sigma)
    got = K.fused_features8_xs_stream(
        torch.from_numpy(np.array(num)), torch.from_numpy(np.array(den)),
        torch.from_numpy(mask), sigma, SPACING)
    want = JF.fused_features8_xs_stream(num, den, jnp.asarray(mask), sigma,
                                        SPACING, interpret=True)
    assert got.shape == (8,) + shape
    assert bool(torch.isfinite(got).all())
    _assert_features(got.numpy(), np.asarray(want), (2, 3, 4))


def test_f32_twins_keep_the_dtype():
    img, mask = _inputs((9, 8, 7))
    x = torch.from_numpy(img).float()
    m = torch.from_numpy(mask).float()
    assert K.fused_hessian_eig_stream(x, SPACING).dtype == torch.float32
    s = K.fused_normalized_conv_sweep(x, m, 0.8, SPACING)
    assert s.dtype == torch.float32
    assert K.fused_features8_post_stream(s, m, SPACING).dtype == torch.float32
    assert K.fused_features8_sweep(x, m, 0.8, SPACING).dtype == torch.float32
    num, den = K.fused_smooth_yz(x, m, 0.8, SPACING)
    assert num.dtype == den.dtype == torch.float32
    assert K.fused_features8_xs_stream(num, den, m, 0.8,
                                       SPACING).dtype == torch.float32


def test_non_cpu_non_cuda_tensors_never_reach_the_plain_twins(monkeypatch):
    # the plain twin runs only for a CPU tensor; any other device must
    # launch the kernel (CUDA) or raise — never fall back
    from ife_tpu_torch.kernels import (
        features8_post as post_mod, features8_sweep as sweep_mod,
        hessian_eig as he_mod, normalized_conv as nc_mod,
    )

    def refuse(*a, **k):
        raise AssertionError("plain twin called for a non-CPU tensor")

    for mod, name in ((he_mod, "hessian_eig_plain"),
                      (post_mod, "features8_post_plain"),
                      (nc_mod, "normalized_conv_plain"),
                      (nc_mod, "smooth_yz_plain"),
                      (sweep_mod, "features8_sweep_plain"),
                      (sweep_mod, "features8_xs_stream_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.empty((4, 4, 4), device="meta")
    for call in (lambda: K.fused_hessian_eig_stream(x),
                 lambda: K.fused_normalized_conv_sweep(x, x, 1.0),
                 lambda: K.fused_features8_post_stream(x, x),
                 lambda: K.fused_smooth_yz(x, x, 1.0),
                 lambda: K.fused_features8_sweep(x, x, 1.0),
                 lambda: K.fused_features8_xs_stream(x, x, x, 1.0)):
        with pytest.raises(ValueError, match="no kernel or plain path"):
            call()


def test_cuda_volume_checks_reject_bad_inputs():
    # the argument checks a CUDA launch goes through, exercised on the CPU
    x = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda_volume("t", x)


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_is_keyed_by_the_sources():
    path = _build.library_path()
    assert path.name == "libife_kernels.so"
    assert path.parent.name == _build.source_hash()
    assert path.parent.parent == _build.BUILD_ROOT
    assert {p.name for p in _build._sources()[0]} == {
        "hessian_eig.cu", "normalized_conv.cu", "features8_post.cu",
        "features8_sweep.cu", "features8_sweep_multi.cu",
        "features8_ys_multi.cu", "histogram.cu", "features8_tap.cu",
        "probes.cu", "dense_hist.cu"}
    assert {p.name for p in _build._sources()[1]} == {
        "features8_tail.cuh", "fir.cuh", "s_ring.cuh", "sweep_passes.cuh"}
    assert set(_build.LAUNCHES) == {"hessian_eig", "normalized_conv",
                                    "features8_post", "features8_sweep",
                                    "features8_xs_stream", "smooth_yz",
                                    "histogram", "smooth_xz",
                                    "normalized_conv_tiled",
                                    "features8_post_windowed",
                                    "features8_ys_multi",
                                    "features8_sweep_multi",
                                    "features8_tap", "features8_xs",
                                    "features8_sweep_clamps",
                                    "features8_sweep_multi_clamps",
                                    "hessian_eig_x_halo",
                                    "hessian_eig_pre_padded",
                                    "features8_post_x_halo",
                                    "features8_post_pre_padded",
                                    "features8_post_windowed_pre_padded",
                                    "pcopy1", "trivial6", "dense_hist",
                                    "hessian_eig_copyfloor",
                                    "hessian_eig_copy6",
                                    "hessian_eig_stencil6",
                                    "hessian_eig_reference",
                                    "features8_tap_copyfloor"}
    # every C entry the wrappers launch has a declared signature; the tiled
    # normalized convolution, the shard modes, the probe outputs and the
    # Hessian's reference output count launches of another name's entry
    # (COUNTED_AS)
    assert {f"ife_{k}" for k in _build.LAUNCHES
            if k not in _build.COUNTED_AS} == set(_build._SIGNATURES)
    assert {f"ife_{k}" for k in _build.COUNTED_AS.values()} <= set(
        _build._SIGNATURES)


def test_build_runs_the_compiles_together_and_reports_a_failure():
    # build() starts one nvcc per source at once through _run_all; here
    # with stand-in commands, since this machine has no nvcc
    import sys

    outs = _build._run_all([[sys.executable, "-c", f"print({i})"]
                            for i in range(3)])
    assert [o.strip() for o in outs] == ["0", "1", "2"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._run_all([[sys.executable, "-c", "print(1)"],
                         [sys.executable, "-c", "import sys; sys.exit(3)"]])


def test_declared_signatures_match_the_c_entries():
    # the CPU tests run without nvcc: hold each ctypes signature against the
    # parameter list of its extern "C" entry in csrc (pointer -> void* or
    # float*, long long -> int64, float -> float)
    import ctypes
    import re

    text = "".join(p.read_text() for p in _build._sources()[0])
    entries = dict(re.findall(r'extern "C" int (ife_\w+)\(([^)]*)\)', text))
    assert set(entries) == set(_build._SIGNATURES)
    for name, params in entries.items():
        kinds = []
        for prm in params.split(","):
            prm = " ".join(prm.split())
            if "*" in prm or prm.startswith("cudaStream_t"):
                kinds.append("p")
            elif prm.startswith("long long"):
                kinds.append("i")
            else:
                assert prm.startswith("float "), (name, prm)
                kinds.append("f")
        want = []
        for t in _build._SIGNATURES[name]:
            if t is ctypes.c_int64:
                want.append("i")
            elif t is ctypes.c_float:
                want.append("f")
            else:
                want.append("p")
        assert kinds == want, name
