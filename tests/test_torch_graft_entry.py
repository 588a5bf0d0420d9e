"""graft_entry_torch.py on the CPU against ife_tpu's __graft_entry__.py.

entry(): the same inputs to the bit (synthetic_ct and sphere_mask are one
numpy recipe), and fn's output against ife_tpu's fn(*args), features8 at
sigma 1.0 in f32: on the CPU the port's fn runs the sweep kernel's plain twin
(polynomial eigen path), ife_tpu's the composed XLA ops (trig path).
dryrun_multichip(n) for n = 1, 2, 4, 8: ife_tpu's passes on conftest's
8-device CPU mesh, and the port's dryrun_step(n) equals ife_tpu's same steps
recomputed here with ife_tpu.parallel on the same inputs. Without a card and
without IFE_PLATFORM=cpu both entry points raise, and the module imports no
JAX. Beside them, chip_smoke.py's main with its phases stubbed: the feature
CLI at its two sizes and the graft phase after multiscale.

Tolerances: the smoothed and gradient channels within TOL of
max(max|ife_tpu|, 1) of ife_tpu's f32 output. The second-derivative channels
(LoG, curvature, Frobenius) of two f32 computations sit apart by the sum of
their distances from f64, each ~1e-5 at these scales, so those and the
eigenvalues are held to ife_tpu's function evaluated in f64: no farther from
it than max(TOL, SLACK x ife_tpu's own f32 output). SLACK is 1.5: on the CPU
the port's fn runs the sweep kernel's twin, whose tap-ordered sums (the
kernels' association) sit up to 1.3x farther from f64 than ife_tpu's XLA
convolution at 13 taps (PERF.md section 6). The eigenvalues per channel
outside ties (tie_sorted_eigenvalues, margin twice the bound of the
triple's scale): the two eigen paths order tied eigenvalues otherwise. The
histogram counts and the mesh's block grid equal.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import __graft_entry__ as JG
import graft_entry_torch as G
from ife_tpu import parallel as JP
from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SLACK = 1.5
FIRST = (0, 1)  # smoothed, gradient
SECOND = (5, 6, 7)  # LoG, curvature, Frobenius
EIG = (2, 3, 4)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("IFE_PLATFORM", "cpu")


@pytest.fixture
def no_card(monkeypatch):
    """A host without a card and without the CPU opt-in."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    monkeypatch.delenv("IFE_PLATFORM", raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _eig_rel(got, want, tol):
    """Three eigenvalue channels of (..., 8) arrays per channel outside ties
    (margin 2 tol of the triple's scale), relative to that scale."""
    g = [torch.from_numpy(np.array(got[..., k], np.float64)) for k in EIG]
    w = [torch.from_numpy(np.array(want[..., k], np.float64)) for k in EIG]
    scale = max(max(x.abs().max().item() for x in w), 1.0)
    g, w = tie_sorted_eigenvalues(g, w, 2 * tol * scale)
    return max((a - b).abs().max().item() for a, b in zip(g, w)) / scale


def _assert_features8(got, want32, want64):
    """(..., 8) arrays: the port's f32 output against ife_tpu's f32 and f64
    outputs, as the module docstring holds them."""
    assert got.shape == want32.shape == want64.shape
    for k in FIRST:
        assert _rel(got[..., k], want32[..., k]) <= TOL, k
    for k in SECOND:
        bound = max(TOL, SLACK * _rel(want32[..., k], want64[..., k]))
        assert _rel(got[..., k], want64[..., k]) <= bound, k
    bound = max(TOL, SLACK * _eig_rel(want32, want64, TOL))
    assert _eig_rel(got, want64, bound) <= bound


def test_entry_matches_ife_tpus_entry(on_cpu):
    fn, (img, mask) = G.entry()
    j_fn, (j_img, j_mask) = JG.entry()
    assert img.device.type == "cpu"
    for got, want in ((img, j_img), (mask, j_mask)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)
    got = fn(img, mask)
    assert tuple(got.shape) == (64, 64, 64, 8)
    assert got.dtype == torch.float32
    assert not bool(got[mask == 0].any())
    _assert_features8(got.numpy(), np.asarray(j_fn(j_img, j_mask)),
                      np.asarray(j_fn(j_img.astype(jnp.float64), j_mask)))


def _ife_tpu_step(n, dtype=jnp.float32):
    """__graft_entry__.dryrun_multichip's step, returning what it computes:
    (features, counts, the mesh's block grid); in f64 for dtype float64."""
    axes = ("x", "y") if n > 1 else ("x",)
    mesh = JP.make_mesh(n, axes, devices=jax.devices()[:n])
    dims = mesh.devices.shape
    shape = (4 * dims[0], 4 * (dims[1] if len(dims) > 1 else 1), 16)
    img = JP.shard_volume(
        j_synthetic_ct(shape, seed=1, dtype=dtype).data, mesh)
    mask = JP.shard_volume(j_sphere_mask(shape, 0.45).data, mesh)
    edges = jnp.asarray(np.linspace(-900.0, -100.0, 5), jnp.float32)

    @jax.jit
    def step(image, msk, e):
        feats = JP.sharded_multiscale_features(
            image, msk, sigmas=(0.8, 1.6), mesh=mesh, spacing=(1.0, 1.0, 1.0))
        return feats, JP.sharded_masked_histogram(feats[..., 0, 0], msk, e,
                                                  mesh)

    feats, hist = step(img, mask, edges)
    return np.asarray(feats), np.asarray(hist), tuple(dims)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_matches_ife_tpus(on_cpu, n):
    JG.dryrun_multichip(n)
    G.dryrun_multichip(n)
    feats, counts, dims = G.dryrun_step(n)
    want_feats, want_counts, want_dims = _ife_tpu_step(n)
    want64 = _ife_tpu_step(n, jnp.float64)[0]
    assert tuple(dims) == want_dims
    assert tuple(feats.shape) == want_feats.shape
    for s in range(len(G.DRYRUN_SIGMAS)):
        _assert_features8(feats[..., s, :].numpy(), want_feats[..., s, :],
                          want64[..., s, :])
    assert counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), want_counts.astype(np.int32))


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_without_a_card_both_entry_points_raise(no_card, call):
    with pytest.raises(RuntimeError, match="IFE_PLATFORM=cpu"):
        G.entry() if call == "entry" else G.dryrun_multichip(4)


def test_the_module_imports_neither_jax_nor_ife_tpu():
    code = """
import json, sys
import graft_entry_torch as G
fn, args = G.entry()
fn(*args)
G.dryrun_multichip(2)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0]
                        in ("jax", "jaxlib", "ife_tpu", "__graft_entry__"))))
"""
    env = dict(os.environ, IFE_PLATFORM="cpu", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# chip_smoke.py's main with its phases stubbed: the feature CLI's two sizes
# and the graft phase's place in the default run

def _stub_phases(monkeypatch, C, until):
    """Every phase of the default run up to `until` returns what main needs;
    `until` records that it ran and stops the run."""
    stubs = {"phase_device": None, "phase_build": None, "phase_kernels": None,
             "phase_main": ({}, None, None), "phase_bags": (None, None, None),
             "phase_tools": {}, "phase_dicom": {},
             "phase_sharded_cli": dict.fromkeys(C.SHARDED_PATH, 1),
             "phase_sharded": dict.fromkeys(C.SHARDED_PATH, 1),
             "phase_multiscale": {}}
    seen = []
    for name, value in stubs.items():
        monkeypatch.setattr(C, name, lambda *a, n=name, v=value, **k:
                            seen.append((n, a[1:], k)) or v)

    def stop(*a, **k):
        seen.append((until, a[1:], k))
        raise C.PhaseError(f"stopped in {until}")

    monkeypatch.setattr(C, until, stop)
    monkeypatch.setattr(sys, "path", list(sys.path))
    return seen


@pytest.mark.parametrize("argv", [[], ["--cli-full"]])
def test_chip_smoke_runs_the_feature_cli_at_its_two_sizes(monkeypatch, capsys,
                                                         argv):
    import inspect

    import chip_smoke as C

    assert C.CLI_SHAPE == (256, 256, 128)
    assert C.CLI_SMOKE_SHAPE == (128, 128, 64)
    default = inspect.signature(C.phase_main).parameters["cli_shape"].default
    assert default == C.CLI_SMOKE_SHAPE
    seen = _stub_phases(monkeypatch, C, "phase_main")
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", *argv])
    assert C.main() == 1
    assert "failed: stopped in phase_main" in capsys.readouterr().err
    # the default run leaves phase_main its default; --cli-full passes the
    # full size
    (_, args, kwargs), = [s for s in seen if s[0] == "phase_main"]
    assert (args, kwargs) == (((C.CLI_SHAPE,), {}) if argv else ((), {}))


def test_chip_smoke_runs_the_graft_phase_after_multiscale(monkeypatch,
                                                          capsys):
    import chip_smoke as C

    seen = _stub_phases(monkeypatch, C, "phase_graft")
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert C.main() == 1
    assert "phase graft failed: stopped in phase_graft" in \
        capsys.readouterr().err
    assert [n for n, _, _ in seen][-3:] == ["phase_sharded",
                                           "phase_multiscale", "phase_graft"]

if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_graft_entry.py: per channel, the
    # distances of entry()'s f32 output (the port's and ife_tpu's) from
    # ife_tpu's fn in f64, on the CPU under x64 as the tests run
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.environ["IFE_PLATFORM"] = "cpu"
    fn, (img, mask) = G.entry()
    j_fn, (j_img, j_mask) = JG.entry()
    got = fn(img, mask).numpy()
    want32 = np.asarray(j_fn(j_img, j_mask))
    want64 = np.asarray(j_fn(j_img.astype(jnp.float64), j_mask))
    for k in FIRST + SECOND:
        print(f"channel {k}: port {_rel(got[..., k], want64[..., k]):.3e}, "
              f"ife_tpu {_rel(want32[..., k], want64[..., k]):.3e}")
    print(f"eigenvalues per channel: port {_eig_rel(got, want64, TOL):.3e}, "
          f"ife_tpu {_eig_rel(want32, want64, TOL):.3e}")
