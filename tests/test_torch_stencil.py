"""ife_tpu_torch.ops.stencil against ife_tpu.ops.stencil: the same numpy
inputs through both, f64, at <= 1e-12 relative to the output scale; the
Gaussian taps bit-identical."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.kernels import fused as jfused
from ife_tpu.ops import stencil as J
from ife_tpu_torch.ops import stencil as T

torch.set_num_threads(1)

SHAPES = [(16, 16, 16), (13, 12, 11)]
SPACING = (0.7, 0.9, 1.2)
TOL = 1e-12


def _vol(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * 200.0 - 600.0


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


@pytest.mark.parametrize("sigma_vox,truncate", [(0.77, 4.5), (1.54, 4.5),
                                                (6.15, 4.5), (2.0, 3.0)])
def test_gaussian_taps_radius_and_band_bitwise(sigma_vox, truncate):
    r = T.gaussian_radius(sigma_vox, truncate)
    assert r == J.gaussian_radius(sigma_vox, truncate)
    assert np.array_equal(T._gaussian_taps(sigma_vox, r), J._gaussian_taps(sigma_vox, r))
    assert np.array_equal(T._band_matrix(11, sigma_vox, r), J._band_matrix(11, sigma_vox, r))


@pytest.mark.parametrize("sigma,h", [(0.6, 0.78), (1.2, 0.78), (4.8, 0.78),
                                     (1.2, 1.0), (0.0, 1.0)])
def test_smooth_taps_equal_the_tpu_kernels_taps(sigma, h):
    # the taps every CUDA kernel rounds to f32 are ife_tpu's kernel taps
    assert T.smooth_taps(sigma, h, 4.5) == jfused._smooth_taps(sigma, h, 4.5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("order", [1, 2])
def test_derivative_matches_ife_tpu(shape, axis, order):
    x = _vol(shape, 1)
    _close(T.derivative(torch.from_numpy(x), axis, order, SPACING[axis]),
           J.derivative(jnp.asarray(x), axis, order, SPACING[axis]))


def test_derivative_rejects_order_3():
    with pytest.raises(ValueError):
        T.derivative(torch.zeros(3, 3, 3), 0, 3)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_magnitude_and_hessian_match_ife_tpu(shape):
    x = _vol(shape, 2)
    _close(T.gradient_magnitude(torch.from_numpy(x), SPACING),
           J.gradient_magnitude(jnp.asarray(x), SPACING))
    _close(T.hessian(torch.from_numpy(x), SPACING), J.hessian(jnp.asarray(x), SPACING))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 1.2, 2.4])
def test_gaussian_smooth_matches_ife_tpu(shape, sigma):
    x = _vol(shape, 3)
    for axis in range(3):
        _close(T.gaussian_smooth_axis(torch.from_numpy(x), axis, sigma, SPACING[axis]),
               J.gaussian_smooth_axis(jnp.asarray(x), axis, sigma, SPACING[axis]))
    _close(T.gaussian_smooth(torch.from_numpy(x), sigma, SPACING),
           J.gaussian_smooth(jnp.asarray(x), sigma, SPACING))


def test_gaussian_smooth_sigma_zero_is_identity():
    x = torch.from_numpy(_vol((5, 4, 3)))
    assert T.gaussian_smooth(x, 0.0) is x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 1.2])
def test_normalized_convolution_matches_ife_tpu_no_epsilon(shape, sigma):
    # a small certainty blob in one corner: far from it G*c underflows to 0
    # and both sides divide 0/0 = NaN (no epsilon, as the reference)
    x = _vol(shape, 4)
    rng = np.random.default_rng(5)
    c = np.zeros(shape)
    c[:5, :5, :5] = rng.uniform(0.2, 2.0, (5, 5, 5))  # raw, not clamped
    got = T.normalized_gaussian_convolution(
        torch.from_numpy(x), torch.from_numpy(c), sigma, SPACING).numpy()
    want = np.asarray(J.normalized_gaussian_convolution(
        jnp.asarray(x), jnp.asarray(c), sigma, SPACING))
    assert np.isnan(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    _close(got[ok], want[ok])
