"""ife_tpu_torch.ops.eigen against ife_tpu.ops.eigen on the same numpy
matrices: both flag paths in f64 at <= 1e-12 (eigenvalues as value-sorted
sets), the f32 polynomial path at <= 1e-6, and numpy's eigvalsh as an
independent oracle."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.ops import eigen as J
from ife_tpu_torch.ops import eigen as T

torch.set_num_threads(1)


def _matrices(n=4000, seed=0):
    """Packed [A11, A12, A13, A22, A23, A33] rows: general symmetric
    matrices, diagonal ones (the reference's diagonal branch, with ties)
    and scalar ones (p2 == 0)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, 6)) * 50.0
    A[: n // 8, [1, 2, 4]] = 0.0                      # diagonal
    A[n // 8 : n // 8 + 20, [1, 2, 4]] = 0.0
    A[n // 8 : n // 8 + 20, [3, 5]] = A[n // 8 : n // 8 + 20, [0]]  # scalar
    return A


def _near_repeated(n=500, seed=3):
    """Matrices with two eigenvalues ~1e-3 apart on a scale of ~50."""
    A = _matrices(n, seed)
    A[:, [1, 2, 4]] *= 1e-4
    A[:, 3] = A[:, 0] + 1e-3
    return A


def _well_separated(A, gap=0.1):
    """Rows whose eigenvalues are at least `gap` of the matrix scale apart
    (away from the sqrt(ulp) amplification at repeated eigenvalues)."""
    M = np.empty((len(A), 3, 3))
    for (i, j), c in zip([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)], range(6)):
        M[:, i, j] = M[:, j, i] = A[:, c]
    ev = np.linalg.eigvalsh(M.astype(np.float64))
    scale = np.abs(ev).max(-1) + 1e-30
    return np.diff(ev, axis=-1).min(-1) > gap * scale


def _channels(A, lib):
    if lib == "torch":
        return [torch.from_numpy(np.ascontiguousarray(A[:, i])) for i in range(6)]
    return [jnp.asarray(A[:, i]) for i in range(6)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_features(got, want, tol):
    got = [_np(g) for g in got]
    want = [_np(w) for w in want]
    g3 = np.sort(np.stack(got[:3], -1), -1)
    w3 = np.sort(np.stack(want[:3], -1), -1)
    assert np.abs(g3 - w3).max() / max(np.abs(w3).max(), 1.0) <= tol
    for g, w in zip(got[3:], want[3:]):
        assert np.abs(g - w).max() / max(np.abs(w).max(), 1.0) <= tol


def _channel_errors(got, want, over_rows=np.max):
    """Per channel over_rows(|got - want|) / max(max|want|, 1), the
    eigenvalues as value-sorted triples."""
    got = [_np(g).astype(np.float64) for g in got]
    want = [_np(w).astype(np.float64) for w in want]
    g3 = np.sort(np.stack(got[:3], -1), -1)
    w3 = np.sort(np.stack(want[:3], -1), -1)
    pairs = [(g3[:, k], w3[:, k]) for k in range(3)] + list(zip(got[3:], want[3:]))
    return [float(over_rows(np.abs(g - w)) / max(np.abs(w).max(), 1.0))
            for g, w in pairs]


def test_polynomial_constants_are_ife_tpus():
    assert T._COS13_COEF == J._COS13_COEF


@pytest.mark.parametrize("use_trig", [True, False])
@pytest.mark.parametrize("diag_path", [True, False])
def test_f64_both_paths_match_ife_tpu(use_trig, diag_path):
    A = _matrices()
    got = T.eigenvalue_feature_channels(*_channels(A, "torch"), use_trig=use_trig,
                                        diag_path=diag_path)
    want = J.eigenvalue_feature_channels(*_channels(A, "jax"), use_trig=use_trig,
                                         diag_path=diag_path)
    _assert_features(got, want, 1e-12)


def test_diag_path_keeps_the_reference_order_exactly():
    A = _matrices()[:500]  # diagonal and scalar rows included
    got = T.eigenvalues_from_channels(*_channels(A, "torch"))
    want = J.eigenvalues_from_channels(*_channels(A, "jax"))
    for g, w in zip(got, want):
        diag = (A[:, 1] == 0) & (A[:, 2] == 0) & (A[:, 4] == 0)
        assert np.array_equal(_np(g)[diag], _np(w)[diag])


def test_f32_polynomial_path_matches_ife_tpu_f32():
    # ATen's and XLA's f32 rsqrt differ by 1 ulp on ~1/3 of inputs, and an
    # eigenvalue moves by that ulp over the relative gap to its neighbour:
    # rows with eigenvalues closer than 10% of the scale are left to the
    # near-repeated test below
    # the rows left out: the port's f32 error against f64 is within twice
    # ife_tpu's own f32 error (the repo's criterion, tests/test_kernels.py),
    # per channel. There one row's error is a sqrt(ulp)-amplified draw, so
    # the error of the worst row swings both ways between two f32
    # implementations (ratios 0.6 to 3.0 over seeds 1-4); the mean over the
    # rows is the stable measure of accuracy and is the one compared
    A = _matrices(seed=1).astype(np.float32)
    sep = _well_separated(A)
    got = T.eigenvalue_feature_channels(*_channels(A[sep], "torch"),
                                        use_trig=False, diag_path=False)
    want = J.eigenvalue_feature_channels(*_channels(A[sep], "jax"),
                                         use_trig=False, diag_path=False)
    assert all(_np(g).dtype == np.float32 for g in got)
    _assert_features(got, want, 1e-6)

    near = A[~sep]
    assert len(near) > 100
    f64 = J.eigenvalue_feature_channels(*_channels(near.astype(np.float64), "jax"),
                                        use_trig=False, diag_path=False)
    port = T.eigenvalue_feature_channels(*_channels(near, "torch"),
                                         use_trig=False, diag_path=False)
    ref = J.eigenvalue_feature_channels(*_channels(near, "jax"),
                                        use_trig=False, diag_path=False)
    e_port = _channel_errors(port, f64, np.mean)
    e_ref = _channel_errors(ref, f64, np.mean)
    assert all(e <= max(2 * r, 1e-6) for e, r in zip(e_port, e_ref)), (
        e_port, e_ref)


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-7), (np.float32, 2e-3)])
def test_near_repeated_eigenvalues_within_the_sqrt_ulp_floor(dt, tol):
    # two eigenvalues 1e-3 apart: a 1-ulp difference between the two
    # implementations (rsqrt) moves them by ~sqrt(ulp) of the scale, in any
    # closed-form solver (docs/design.md "Precision policy")
    A = _near_repeated().astype(dt)
    got = T.eigenvalue_feature_channels(*_channels(A, "torch"), use_trig=False,
                                        diag_path=False)
    want = J.eigenvalue_feature_channels(*_channels(A, "jax"), use_trig=False,
                                         diag_path=False)
    _assert_features(got, want, tol)


def test_cos_sin_third_arccos_matches_ife_tpu():
    m = np.linspace(0.0, 1.0, 2001)
    for dt in (np.float32, np.float64):
        c, s = T._cos_sin_third_arccos(torch.from_numpy(m.astype(dt)))
        cj, sj = J._cos_sin_third_arccos(jnp.asarray(m.astype(dt)))
        tol = 1e-6 if dt == np.float32 else 1e-13
        assert np.abs(c.numpy() - np.asarray(cj)).max() <= tol
        assert np.abs(s.numpy() - np.asarray(sj)).max() <= 10 * tol
        assert np.abs(c.numpy() - np.cos(np.arccos(m) / 3)).max() <= 10 * tol


@pytest.mark.parametrize("use_trig", [True, False])
def test_packed_forms_match_ife_tpu_and_eigvalsh(use_trig):
    A = _matrices(n=600, seed=2)
    got = T.eigenvalue_features(torch.from_numpy(A), use_trig=use_trig).numpy()
    want = np.asarray(J.eigenvalue_features(jnp.asarray(A), use_trig=use_trig))
    _assert_features(list(np.moveaxis(got, -1, 0)),
                     list(np.moveaxis(want, -1, 0)), 1e-12)
    ev = T.eigenvalues_sym3x3(torch.from_numpy(A), use_trig=use_trig).numpy()
    M = np.empty((len(A), 3, 3))
    for (i, j), c in zip([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)], range(6)):
        M[:, i, j] = M[:, j, i] = A[:, c]
    oracle = np.linalg.eigvalsh(M)
    assert np.abs(np.sort(ev, -1) - oracle).max() / np.abs(oracle).max() < 1e-7
    # |e3| <= |e2| <= |e1|
    assert (np.abs(ev[:, 0]) >= np.abs(ev[:, 1])).all()
    assert (np.abs(ev[:, 1]) >= np.abs(ev[:, 2])).all()
