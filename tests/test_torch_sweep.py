"""The redesigned sweep kernels' host side on the CPU: what a launch takes
(x radii instantiated, register and shared-memory budgets), the dispatcher
passing a scale on where the sweep has no instantiation, and the plain
twins of fused_features8_sweep and fused_features8_sweep_multi against
ife_tpu's Pallas kernels in interpret mode at every x radius the CUDA
kernels are instantiated for.

Tolerance, as tests/test_torch_kernels.py and tests/test_torch_multiscale.py
state it: f64 <= 1e-9 of max(max|reference|, 1) per channel, the three
eigenvalue channels per channel, as value-sorted triples only where two
magnitudes tie within twice the tolerance; f32 within the budget of
docs/design.md "Precision policy" (smoothed <= 1e-4 relative, derivative
channels <= 1e-3 of their scale).

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
from ife_tpu_torch.kernels import features8_sweep as KS
from ife_tpu_torch.ops import features as TO
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues
from ife_tpu_torch.ops.stencil import smooth_taps

torch.set_num_threads(1)

SPACING = (0.7, 0.9, 1.2)
CARD_SPACING = (0.78, 0.78, 1.0)
TOL = 1e-9
EIG = (2, 3, 4)
RADII = tuple(range(1, KS.SWEEP_MAX_RX + 1))


def _inputs(shape, seed, dtype=jnp.float64):
    img = np.array(j_synthetic_ct(shape, seed=seed, dtype=dtype).data)
    mask = np.array(j_sphere_mask(shape, 0.45).data).astype(img.dtype)
    return img, mask


def _sigma_of(rx, h=SPACING[0]):
    """A sigma whose x radius at spacing h is rx (radius = ceil(4.5 s / h))."""
    sigma = (rx - 0.5) * h / 4.5
    assert smooth_taps(sigma, h)[1] == rx
    return sigma


def _errors(got, want, tol=TOL):
    """(worst of the other channels, worst eigenvalue channel), relative;
    the eigenvalues against their joint scale, per channel where want's
    adjacent |e_k| differ by more than 2 * tol of it, as value-sorted
    triples where they tie (tie_sorted_eigenvalues)."""
    got = [np.array(g, np.float64) for g in got]
    want = [np.array(w, np.float64) for w in want]
    scale = max(max(np.abs(want[i]).max() for i in EIG), 1.0)
    gs, ws = tie_sorted_eigenvalues([torch.from_numpy(got[i]) for i in EIG],
                                    [torch.from_numpy(want[i]) for i in EIG],
                                    2 * tol * scale)
    e_eig = max((g - w).abs().max().item() for g, w in zip(gs, ws)) / scale
    e_rest = max(np.abs(got[i] - want[i]).max() / max(np.abs(want[i]).max(), 1.0)
                 for i in range(8) if i not in EIG)
    return e_rest, e_eig


# ---------------------------------------------------------------------------
# what a launch takes
# ---------------------------------------------------------------------------

def test_the_sweep_is_instantiated_for_x_radii_up_to_ten():
    assert KS.SWEEP_MAX_RX == 10 == K.SWEEP_MAX_RX
    assert K.sweep_fits(0.6, CARD_SPACING)   # rx 4
    assert K.sweep_fits(1.2, CARD_SPACING)   # rx 7
    assert K.sweep_fits(1.7, CARD_SPACING)   # rx 10
    assert not K.sweep_fits(1.8, CARD_SPACING)  # rx 11: no instantiation
    # the limit is on x alone: y and z radii beyond 10 still fit
    assert K.sweep_fits(1.0, (0.78, 0.2, 0.3))  # radii (6, 23, 15)
    assert K.sweep_fits(0.0, CARD_SPACING)      # sigma 0: rx 0, the identity


@pytest.mark.parametrize("r", [(4, 4, 3), (7, 7, 6), (10, 13, 7), (1, 1, 1),
                               (0, 0, 0), (6, 23, 15)])
def test_sweep_shared_memory_is_two_raw_planes_a_y_pass_and_three_s_planes(r):
    rx, ry, rz = r
    cells = 16 * 34
    pad = 34 + -(-2 * rz // 32) * 32   # rows of the y pass buffer: 34 mod 32
    assert pad >= 34 + 2 * rz and pad % 32 == 2
    want = 4 * (2 * 2 * (16 + 2 * ry) * (34 + 2 * rz) + 2 * 16 * pad
                + 3 * cells)
    assert KS.sweep_smem_bytes(rx, ry, rz) == want
    # the x queue lives in registers: rx does not count
    assert KS.sweep_smem_bytes(0, ry, rz) == KS.sweep_smem_bytes(10, ry, rz)
    # the xs-stream kernel keeps its x ring in shared memory: the window of
    # 2rx + 1 planes and the plane in flight, on the s region of its
    # narrowest tile (4 rows)
    xs_cells = 6 * 34
    assert KS.sweep_smem_bytes(rx, 0, 0, smooth_yz=False) == 4 * (
        2 * (2 * rx + 2) * xs_cells + 3 * xs_cells)


def test_sweep_shared_memory_at_the_cards_scales():
    # sigma 1.2 at 0.78 mm: 37 KB where the x ring took 89 KB
    assert KS.sweep_smem_bytes(7, 7, 6) == 37056
    assert KS.sweep_smem_bytes(7, 7, 6) < 48 * 1024
    # the y and z radii are still bounded by the block's 227 KB
    assert not K.sweep_fits(1.0, (0.78, 0.05, 0.05))    # ry = rz = 90
    assert KS.sweep_smem_bytes(6, 90, 90) > 227 * 1024


def test_xs_stream_takes_the_radii_its_ring_fits():
    assert K.xs_stream_fits(2.4, CARD_SPACING)       # rx 14
    assert K.xs_stream_fits(1.8, CARD_SPACING)       # rx 11
    assert K.xs_stream_fits(4.8, CARD_SPACING)       # rx 28: 95 KB at 4 rows
    assert KS.sweep_smem_bytes(69, 0, 0, smooth_yz=False) <= 227 * 1024
    assert KS.sweep_smem_bytes(70, 0, 0, smooth_yz=False) > 227 * 1024
    assert not K.xs_stream_fits(12.0, CARD_SPACING)  # rx 70


@pytest.mark.parametrize("sigma,branch", [(0.6, "sweep"), (1.7, "sweep"),
                                          (1.8, "xs_stream"),
                                          (2.4, "xs_stream"),
                                          (4.8, "nc_conv+post")])
def test_dispatch_branch_by_x_radius(sigma, branch):
    assert TO.features8_dispatch_branch(sigma, CARD_SPACING, None) == branch


def test_dispatch_passes_a_scale_on_where_the_sweep_has_no_instantiation(
        monkeypatch):
    # were the dispatcher's own threshold raised, the sweep would still not
    # take rx 11: sweep_fits knows the instantiated radii
    monkeypatch.setattr(TO, "_SWEEP_RX_MAX", 12)
    assert TO.features8_dispatch_branch(1.8, CARD_SPACING, None) == "xs_stream"
    assert TO.features8_dispatch_branch(1.7, CARD_SPACING, None) == "sweep"
    # and a scale whose y/z radii overflow the block's shared memory goes on
    # although its x radius is small
    assert TO.features8_dispatch_branch(1.0, (0.78, 0.05, 0.05), None) != "sweep"


def test_sweep_refuses_a_plane_beyond_32_bit_offsets():
    with pytest.raises(ValueError, match="2\\^31"):
        KS._check_plane("fused_features8_sweep", (4, 65535, 40000))
    KS._check_plane("fused_features8_sweep", (4, 512, 512))


@pytest.mark.parametrize("rx_max,scales", [(1, 4), (2, 4), (3, 3), (4, 3),
                                           (5, 2), (7, 2), (8, 1), (10, 1),
                                           (11, 0), (28, 0)])
def test_sweep_multi_scales_by_largest_x_radius(rx_max, scales):
    assert K.sweep_multi_max_scales(rx_max) == scales
    # the budget behind the table: every scale's queue of 2 * class + 1
    # numerators and denominators within 60 registers a thread
    for cls, n in KS.SWEEP_MULTI_CLASSES:
        assert n * 2 * (2 * cls + 1) <= 60


# ---------------------------------------------------------------------------
# the twins against ife_tpu at every instantiated radius
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rx", RADII)
def test_sweep_twin_matches_pallas_interpret_at_every_radius(rx):
    shape = (13, 12, 11) if rx % 2 else (9, 16, 8)
    img, mask = _inputs(shape, seed=rx)
    labels = mask * 3.0  # the sweep clamps the mask itself
    sigma = _sigma_of(rx)
    got = K.fused_features8_sweep(torch.from_numpy(img),
                                  torch.from_numpy(labels), sigma, SPACING)
    want = np.asarray(JF.fused_features8_sweep(
        jnp.asarray(img), jnp.asarray(labels), sigma, SPACING, interpret=True))
    assert got.shape == (8,) + shape == want.shape
    assert bool(torch.isfinite(got).all())
    e_rest, e_eig = _errors(got.numpy(), want)
    assert e_rest <= TOL and e_eig <= TOL, (e_rest, e_eig)


@pytest.mark.parametrize("rx", (2, 4, 7, 10))
def test_sweep_twin_f32_within_the_precision_budget(rx):
    shape = (13, 12, 11)
    img64, mask = _inputs(shape, seed=20 + rx)
    sigma = _sigma_of(rx)
    got = K.fused_features8_sweep(torch.from_numpy(img64.astype(np.float32)),
                                  torch.from_numpy(mask.astype(np.float32)),
                                  sigma, SPACING)
    assert got.dtype == torch.float32
    want = np.asarray(JF.fused_features8_sweep(
        jnp.asarray(img64), jnp.asarray(mask), sigma, SPACING, interpret=True))
    g, w = got.numpy().astype(np.float64), want
    assert np.abs(g[0] - w[0]).max() / max(np.abs(w[0]).max(), 1.0) <= 1e-4
    e_rest, e_eig = _errors(g, w, 1e-3)
    assert e_rest <= 1e-3 and e_eig <= 1e-3, (e_rest, e_eig)


# one set per class of the largest x radius and per scale count a launch of
# the CUDA kernel takes (x radii at spacing 0.7: sigma 0.3 -> 2, 0.6 -> 4,
# 1.0 -> 7, 1.5 -> 10)
MULTI_SETS = [(1.5,), (1.0,), (0.6, 1.0), (0.3, 0.45, 0.6), (0.25, 0.3),
              (0.3, 0.29, 0.31, 0.25)]


@pytest.mark.parametrize("sigmas", MULTI_SETS)
def test_sweep_multi_twin_matches_pallas_interpret_in_every_class(sigmas):
    assert K.sweep_multi_fits(sigmas, SPACING)
    shape = (12, 13, 11)
    img, mask = _inputs(shape, seed=8)
    labels = mask * 3.0
    got = K.fused_features8_sweep_multi(
        torch.from_numpy(img), torch.from_numpy(labels), sigmas, SPACING)
    want = np.asarray(JF.fused_features8_sweep_multi(
        jnp.asarray(img), jnp.asarray(labels), sigmas, SPACING,
        interpret=True, stack=True))
    assert got.shape == (len(sigmas), 8) + shape == want.shape
    assert bool(torch.isfinite(got).all())
    for si in range(len(sigmas)):
        e_rest, e_eig = _errors(got[si].numpy(), want[si])
        assert e_rest <= TOL and e_eig <= TOL, (si, e_rest, e_eig)


@pytest.mark.parametrize("name", ["empty", "half of x", "one voxel", "ones"])
def test_sweep_twin_is_zero_outside_the_mask_whatever_the_mask_leaves_empty(name):
    """The CUDA sweeps skip the planes of a chunk that hold no voxel inside
    the mask and store zeros there; the twin, which they must equal to the
    bit, gives exact zeros outside any mask (NaN selected away)."""
    shape = (14, 9, 10)
    img, mask = _inputs(shape, seed=3)
    m = {"empty": mask * 0, "ones": np.ones_like(mask),
         "half of x": mask * (np.arange(shape[0]) > 6)[:, None, None],
         "one voxel": np.zeros_like(mask)}[name]
    if name == "one voxel":
        m[-1, -1, -1] = 2.0
    got = K.fused_features8_sweep(torch.from_numpy(img), torch.from_numpy(m),
                                  0.8, SPACING)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, torch.from_numpy(m) == 0] == 0).all())
    want = np.asarray(JF.fused_features8_sweep(
        jnp.asarray(img), jnp.asarray(m), 0.8, SPACING, interpret=True))
    e_rest, e_eig = _errors(got.numpy(), want)
    assert e_rest <= TOL and e_eig <= TOL, (e_rest, e_eig)
