"""The port's Deriche IIR Gaussian (ife_tpu_torch/ops/deriche.py) against
ife_tpu's, to the bit, and the yardstick it exists for: the port's FIR
gaussian_smooth in f64 stays within the bounds that ife_tpu's FIR holds
against the reference's IIR smoother (tests/test_stencil.py), and closer
to the exact Gaussian than the IIR is."""
import numpy as np
import pytest
import torch

from ife_tpu.ops.deriche import (
    _deriche_coeffs as j_coeffs,
    deriche_gaussian_smooth as j_deriche,
)
from ife_tpu_torch.core.volume import synthetic_ct
from ife_tpu_torch.ops.deriche import _deriche_coeffs, deriche_gaussian_smooth
from ife_tpu_torch.ops.stencil import gaussian_smooth

torch.set_num_threads(1)

SPACING = (0.78, 0.78, 1.0)


@pytest.fixture(scope="module")
def ct():
    return synthetic_ct((48, 48, 48), seed=3, dtype=torch.float64).data


@pytest.mark.parametrize("sigma_vox", [0.3, 0.6, 1.0, 2.4, 7.5, 30.0])
def test_coefficients_equal_ife_tpu(sigma_vox):
    num, den = _deriche_coeffs(sigma_vox)
    jnum, jden = j_coeffs(sigma_vox)
    np.testing.assert_array_equal(num, jnum)
    np.testing.assert_array_equal(den, jden)


@pytest.mark.parametrize("sigma,spacing,shape", [
    (0.6, SPACING, (17, 12, 9)),
    (1.2, (1.0, 1.0, 1.0), (9, 20, 5)),
    (4.8, (0.7, 0.9, 1.2), (30, 7, 11)),
    (2.0, (1.0, 1.0), (13, 8)),
])
def test_deriche_equals_ife_tpu_to_the_bit(sigma, spacing, shape):
    x = np.random.default_rng(len(shape) + int(sigma * 10)).normal(
        size=shape) * 300.0
    got = deriche_gaussian_smooth(x, sigma, spacing)
    assert got.dtype == np.float64 and got.shape == x.shape
    np.testing.assert_array_equal(got, j_deriche(x, sigma, spacing))


def test_deriche_keeps_a_constant():
    # unit DC gain up to the 4-digit coefficients' recursion: 1.4e-8 seen
    x = np.full((20, 16, 12), -400.0)
    np.testing.assert_allclose(deriche_gaussian_smooth(x, 1.5, SPACING), x,
                               rtol=1e-7)


# measured in ife_tpu on this volume (tests/test_stencil.py): FIR vs IIR
# 1.7e-4 / 2.0e-4 / 4.6e-5 of the value scale, the IIR's own error
@pytest.mark.parametrize("sigma,iir_bound", [(0.6, 3e-4), (1.2, 3e-4),
                                             (4.8, 1e-4)])
def test_fir_vs_deriche_iir_divergence_bounded(ct, sigma, iir_bound):
    x = ct.numpy()
    scale = np.abs(x).max()
    fir = gaussian_smooth(ct, sigma, SPACING).numpy()
    exact = gaussian_smooth(ct, sigma, SPACING, truncate=12.0).numpy()
    iir = deriche_gaussian_smooth(x, sigma, SPACING)
    assert np.abs(fir - exact).max() / scale < 1e-5
    assert np.abs(fir - iir).max() / scale < iir_bound
    # the FIR path is strictly closer to the true Gaussian than the
    # reference's own IIR approximation
    assert np.abs(fir - exact).max() < np.abs(iir - exact).max()
