"""ife_tpu_torch's multi-scale feature path on the CPU, against ife_tpu.

The same numpy inputs (made from a seed) go through the JAX function, its
Pallas kernel run in interpret mode as tests/test_kernels.py runs it, and
through the port, whose wrappers run their plain PyTorch twins for CPU
tensors. Tolerances:

  * f64: <= 1e-9 of max(max|reference|, 1) per channel on the smoothed,
    gradient and symmetric channels (LoG, curvature, Frobenius norm); the
    three eigenvalue channels as value-sorted triples (their order may swap
    where two eigenvalues tie in magnitude). ife_tpu sums the y Gaussian as
    a band-matrix product, the port in tap order: the same numbers in
    another association, ~1e-13 apart.
  * f32: the error budget of docs/design.md "Precision policy": smoothed
    <= 1e-4 relative, derivative channels <= 1e-3 of their scale.
  * the tiled normalized convolution: bit-equal to the untiled twin.

The CUDA kernels themselves are tested on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu.kernels import fused as JF
from ife_tpu.ops import features as JO
from ife_tpu.ops import stencil as JS
from ife_tpu_torch import kernels as K
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues
from ife_tpu_torch.ops import features as TO
from ife_tpu_torch.ops import stencil as TS

torch.set_num_threads(1)

SPACING = (0.7, 0.9, 1.2)
TOL = 1e-9
EIG = (2, 3, 4)


def _inputs(shape, seed, radius_frac=0.45):
    img = np.array(j_synthetic_ct(shape, seed=seed, dtype=jnp.float64).data)
    mask = np.array(j_sphere_mask(shape, radius_frac).data).astype(np.float64)
    return img, mask


def _assert_features(got, want, tol=TOL, eig=EIG):
    """got/want: sequences of 8 (X, Y, Z) channels."""
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


# ---------------------------------------------------------------------------
# the state carried across: ife_tpu's band matrix and the port's taps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,sigma,h", [(40, 1.8, 0.9), (33, 2.4, 0.78),
                                       (64, 4.8, 0.78)])
def test_taps_are_the_rows_of_the_band_matrix(n, sigma, h):
    """ife_tpu feeds its ys_multi kernel a band matrix, the port feeds taps:
    an interior row of the matrix is the taps, the first and last rows are
    the taps with the out-of-range weight folded onto the edge column."""
    taps, r = TS.smooth_taps(sigma, h)
    taps = np.asarray(taps)
    assert 2 * r + 1 < n
    W = JS._band_matrix(n, sigma / h, r)
    o = n // 2
    assert np.abs(W[o, o - r:o + r + 1] - taps).max() <= 1e-15
    assert np.count_nonzero(W[o]) == 2 * r + 1
    first = np.concatenate([[taps[:r + 1].sum()], taps[r + 1:]])
    assert np.abs(W[0, :r + 1] - first).max() <= 1e-15
    last = np.concatenate([taps[:r], [taps[r:].sum()]])
    assert np.abs(W[n - 1, n - r - 1:] - last).max() <= 1e-15
    # a row near the face: the weight of the clamped taps on column 0
    assert abs(W[2, 0] - taps[:r - 1].sum()) <= 1e-15


def test_taps_times_clamped_column_is_the_band_product():
    rng = np.random.default_rng(0)
    n, sigma, h = 12, 2.5, 0.9  # the band is wider than the axis
    v = rng.standard_normal((3, n, 4))
    taps, r = TS.smooth_taps(sigma, h)
    assert 2 * r + 1 > n
    got = TS.gaussian_smooth_axis(torch.from_numpy(v), 1, sigma, h).numpy()
    want = np.einsum("oi,xiz->xoz", JS._band_matrix(n, sigma / h, r), v)
    assert np.abs(got - want).max() <= 1e-13


# ---------------------------------------------------------------------------
# multiscale_features8_fused: the path as a whole
# ---------------------------------------------------------------------------

MULTI_CASES = [((16, 16, 16), 5, (0.9, 1.8)),
               ((13, 11, 16), 7, (0.9, 1.4)),
               ((16, 16, 16), 6, (2.5,))]  # the band wider than Y


@pytest.mark.parametrize("shape,seed,sigmas", MULTI_CASES)
def test_multiscale_features8_fused_matches_ife_tpu(shape, seed, sigmas):
    img, mask = _inputs(shape, seed)
    labels = mask * 2.0  # labels 2 count as 1: the entry clamps
    got = TO.multiscale_features8_fused(
        torch.from_numpy(img), torch.from_numpy(labels), sigmas, SPACING)
    want = np.asarray(JO.multiscale_features8_fused(
        jnp.asarray(img), jnp.asarray(labels), sigmas, SPACING,
        interpret=True, stack=True))
    assert got.shape == (len(sigmas), 8) + shape == want.shape
    assert bool(torch.isfinite(got).all())  # NaN selected away
    assert bool((got[:, :, torch.from_numpy(mask) == 0] == 0).all())
    for si in range(len(sigmas)):
        _assert_features(got[si].numpy(), want[si])


@pytest.mark.parametrize("shape,seed,sigmas", MULTI_CASES)
def test_multiscale_features8_fused_matches_features8_per_scale(shape, seed,
                                                                sigmas):
    # against ife_tpu's plain op, at the tolerance ife_tpu holds its own
    # kernel to (tests/test_kernels.py: 1e-7, polynomial vs trig eigen path)
    img, mask = _inputs(shape, seed)
    got = TO.multiscale_features8_fused(
        torch.from_numpy(img), torch.from_numpy(mask), sigmas, SPACING,
        stack=False)
    for g, s in zip(got, sigmas):
        want = np.moveaxis(np.asarray(JO.features8(
            jnp.asarray(img), jnp.asarray(mask), s, SPACING)), -1, 0)
        _assert_features([c.numpy() for c in g], want, tol=1e-7)


def test_multiscale_features8_fused_stack_and_tuple_forms():
    img, mask = _inputs((9, 8, 7), 3)
    x, m = torch.from_numpy(img), torch.from_numpy(mask)
    stacked = TO.multiscale_features8_fused(x, m, (0.8, 1.1, 1.5), SPACING)
    groups = TO.multiscale_features8_fused(x, m, (0.8, 1.1, 1.5), SPACING,
                                           stack=False)
    assert stacked.shape == (3, 8, 9, 8, 7)
    assert isinstance(groups, tuple) and len(groups) == 3
    assert all(isinstance(g, tuple) and len(g) == 8 for g in groups)
    for si, g in enumerate(groups):
        assert all(torch.equal(c, stacked[si, k]) for k, c in enumerate(g))
    # one scale of the multi-scale entry is the same numbers whatever
    # stands beside it
    alone = TO.multiscale_features8_fused(x, m, (1.1,), SPACING)
    assert torch.equal(alone[0], stacked[1])


def test_multiscale_features8_fused_f32_within_the_precision_budget():
    img, mask = _inputs((16, 16, 16), 5)
    x, m = torch.from_numpy(img), torch.from_numpy(mask)
    got = TO.multiscale_features8_fused(x.float(), m.float(), (0.9, 1.8),
                                        SPACING)
    want = TO.multiscale_features8_fused(x, m, (0.9, 1.8), SPACING)
    assert got.dtype == torch.float32
    for si in range(2):
        g, w = got[si].double().numpy(), want[si].numpy()
        assert np.abs(g[0] - w[0]).max() / np.abs(w[0]).max() <= 1e-4
        _assert_features(g, w, tol=1e-3)


# ---------------------------------------------------------------------------
# fused_features8_ys_multi, fused_smooth_xz
# ---------------------------------------------------------------------------

def _xz_smoothed(img, mask, sigma):
    """ife_tpu's x/z smoothing ahead of its ys_multi kernel
    (ops/features.py multiscale_features8_fused)."""
    def sxz(v):
        v = JS.gaussian_smooth_axis(v, 0, sigma, SPACING[0])
        return JS.gaussian_smooth_axis(v, 2, sigma, SPACING[2])

    m = jnp.asarray(mask)
    return sxz(jnp.asarray(img) * m), sxz(m)


@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 12, 11)])
@pytest.mark.parametrize("sigma", [0.6, 1.2, 2.4])
def test_smooth_xz_twin_matches_ife_tpu(shape, sigma):
    img, mask = _inputs(shape, 2)
    got = K.fused_smooth_xz(torch.from_numpy(img), torch.from_numpy(mask),
                            sigma, SPACING)
    for g, w in zip(got, _xz_smoothed(img, mask, sigma)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() <= 1e-12


@pytest.mark.parametrize("pad_to", [None, (16, 16)])
def test_ys_multi_twin_matches_pallas_interpret_unaligned_y(pad_to):
    # Y = 13: ife_tpu pads it to 16 under pad_to and folds the true-face
    # clamp into its band matrix; the port runs on the exact shape
    shape, sigmas = (14, 13, 16), (1.2, 0.8)
    img, mask = _inputs(shape, 11)
    pairs = [_xz_smoothed(img, mask, s) for s in sigmas]
    nums, dens = [p[0] for p in pairs], [p[1] for p in pairs]
    got = K.fused_features8_ys_multi(
        [torch.from_numpy(np.array(v)) for v in nums],
        [torch.from_numpy(np.array(v)) for v in dens],
        torch.from_numpy(mask), sigmas, SPACING)
    want = np.asarray(JF.fused_features8_ys_multi(
        tuple(nums), tuple(dens), jnp.asarray(mask), sigmas, SPACING,
        interpret=True, stack=True, pad_to=pad_to))
    assert got.shape == (2, 8) + shape
    for si in range(2):
        _assert_features(got[si].numpy(), want[si])


def test_ys_multi_rejects_mismatched_scale_lists():
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="equal length"):
        K.fused_features8_ys_multi([x, x], [x], x, (1.0, 2.0))
    with pytest.raises(ValueError, match="equal length"):
        K.fused_features8_ys_multi([], [], x, ())


# ---------------------------------------------------------------------------
# fused_features8_sweep_multi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed,sigmas,kw", [
    ((16, 16, 16), 5, (0.7, 1.4), {}),
    ((13, 11, 16), 7, (0.9, 1.3), {"block": 1}),
    ((13, 11, 16), 7, (0.9, 1.3), {"block": 2}),
    ((12, 13, 11), 8, (0.9, 1.3), {"pad_to": (16, 16)}),
    ((12, 13, 11), 8, (0.6, 0.9, 1.2), {}),
])
def test_sweep_multi_twin_matches_pallas_interpret(shape, seed, sigmas, kw):
    img, mask = _inputs(shape, seed)
    labels = mask * 3.0  # the sweep clamps the mask itself
    got = K.fused_features8_sweep_multi(
        torch.from_numpy(img), torch.from_numpy(labels), sigmas, SPACING)
    want = np.asarray(JF.fused_features8_sweep_multi(
        jnp.asarray(img), jnp.asarray(labels), sigmas, SPACING,
        interpret=True, stack=True, **kw))
    assert got.shape == (len(sigmas), 8) + shape
    assert bool(torch.isfinite(got).all())
    for si in range(len(sigmas)):
        _assert_features(got[si].numpy(), want[si])


def test_sweep_multi_is_the_single_sweep_per_scale():
    img, mask = _inputs((11, 10, 9), 4)
    x, m = torch.from_numpy(img), torch.from_numpy(mask)
    groups = K.fused_features8_sweep_multi(x, m, (0.6, 1.2), SPACING,
                                           stack=False)
    assert len(groups) == 2 and all(len(g) == 8 for g in groups)
    for g, s in zip(groups, (0.6, 1.2)):
        one = K.fused_features8_sweep(x, m, s, SPACING, stack=False)
        assert all(torch.equal(a, b) for a, b in zip(g, one))


def test_sweep_multi_fits_and_clamps():
    sp = (0.78, 0.78, 1.0)
    assert K.sweep_multi_fits((0.6, 1.2), sp)        # rx 4, 7: two scales
    assert K.sweep_multi_fits((1.2,), sp) == K.sweep_fits(1.2, sp)
    assert not K.sweep_multi_fits((2.4, 4.8), sp)   # rx 14, 28: no x queue
    assert not K.sweep_multi_fits((0.6,) * 9, sp)   # the queues: registers
    assert not K.sweep_multi_fits((), sp)
    assert not K.sweep_multi_fits((0.6,), (1.0, 0.004, 1.0))  # ry > 128
    # the register budget: the scales a launch takes fall with the largest
    # x radius (x queues of 2 * class + 1 planes per scale)
    assert [K.sweep_multi_max_scales(r) for r in (1, 2, 3, 4, 5, 7, 8, 10, 11)
            ] == [4, 4, 3, 3, 2, 2, 1, 1, 0]
    assert K.sweep_multi_fits((0.3, 0.45, 0.6), sp)       # rx 2, 3, 4
    assert not K.sweep_multi_fits((0.6, 0.9, 1.2), sp)    # three with rx 7
    assert K.sweep_multi_fits((0.2,) * 4, sp)             # rx 2
    assert not K.sweep_multi_fits((0.2,) * 5, sp)
    assert K.sweep_multi_fits((1.7,), sp)                 # rx 10
    assert not K.sweep_multi_fits((0.6, 1.7), sp)
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    # the array's own faces are the default clamps
    img, mask = _inputs((9, 8, 7), 3)
    a = K.fused_features8_sweep_multi(torch.from_numpy(img),
                                      torch.from_numpy(mask), (1.0,), SPACING)
    b = K.fused_features8_sweep_multi(torch.from_numpy(img),
                                      torch.from_numpy(mask), (1.0,), SPACING,
                                      clamps=[0, 8, 0, 7])
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="clamps"):
        K.fused_features8_sweep_multi(x, x, (1.0,), clamps=[0, 3, 0])
    with pytest.raises(ValueError, match="no scale"):
        K.fused_features8_sweep_multi(x, x, ())


def test_sweep_multi_shared_memory_matches_the_single_sweep_formula():
    from ife_tpu_torch.kernels.features8_sweep import (
        sweep_multi_smem_bytes, sweep_smem_bytes,
    )

    # one scale: the single sweep's block plus its taps
    for r in [(4, 4, 3), (7, 7, 6), (1, 1, 1), (10, 13, 7)]:
        assert sweep_multi_smem_bytes([r]) == sweep_smem_bytes(*r) + 4 * (
            2 * sum(r) + 3)
    # two scales share the raw plane (two buffers of c*f and c), sized by the
    # larger radii; each has its own y pass buffer (rows padded to 34 + 32)
    # and three s planes. No x ring: the queues are in registers.
    two = sweep_multi_smem_bytes([(4, 4, 3), (7, 7, 6)])
    cells = 16 * 34
    assert two == 4 * (2 * 11 + 3 + 2 * 20 + 3
                       + 2 * (2 * 16 * 66 + 3 * cells)
                       + 4 * (16 + 14) * (34 + 12))
    assert two == sweep_multi_smem_bytes([(7, 4, 3), (4, 7, 6)])


# ---------------------------------------------------------------------------
# fused_features8_post (the windowed form)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 12, 11)])
@pytest.mark.parametrize("block", [(8, 128), 4, (3, 5)])
def test_features8_post_twin_matches_pallas_interpret(shape, block):
    img, mask = _inputs(shape, 4, radius_frac=0.3)
    s = np.array(JF.fused_normalized_conv_sweep(
        jnp.asarray(img), jnp.asarray(mask), 0.6, SPACING, interpret=True))
    assert np.isnan(s).any()  # the corners lie beyond the support: 0/0
    got = K.fused_features8_post(torch.from_numpy(s), torch.from_numpy(mask),
                                 SPACING, block=block)
    want = JF.fused_features8_post(jnp.asarray(s), jnp.asarray(mask), SPACING,
                                   block=block, interpret=True)
    assert got.shape == (8,) + shape
    assert bool(torch.isfinite(got).all())
    _assert_features(got.numpy(), np.asarray(want))


def test_features8_post_forms_and_refusals():
    img, mask = _inputs((9, 8, 7), 3)
    s, m = torch.from_numpy(img), torch.from_numpy(mask)
    parts = K.fused_features8_post(s, m, SPACING, stack=False)
    stream = K.fused_features8_post_stream(s, m, SPACING)
    assert len(parts) == 8
    assert all(torch.equal(p, c) for p, c in zip(parts, stream))
    # pre_padded: the block carries its boundary layer, the core comes out
    core = K.fused_features8_post(s, m[1:-1, 1:-1], SPACING, pre_padded=True)
    assert torch.equal(core, stream[:, 1:-1, 1:-1])
    with pytest.raises(ValueError, match="block"):
        K.fused_features8_post(s, m, SPACING, block=(0, 8))


# ---------------------------------------------------------------------------
# fused_normalized_conv_sweep_tiled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,sigma", [((12, 17, 16), 1.3),
                                         ((10, 23, 16), 2.1)])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4])
def test_nc_tiled_twin_matches_ife_tpu_and_the_untiled_twin(shape, sigma,
                                                            n_tiles):
    img, mask = _inputs(shape, 10)
    x, m = torch.from_numpy(img), torch.from_numpy(mask)
    got = K.fused_normalized_conv_sweep_tiled(x, m, sigma, SPACING,
                                              n_tiles=n_tiles)
    untiled = K.fused_normalized_conv_sweep(x, m, sigma, SPACING)
    same = (got == untiled) | (torch.isnan(got) & torch.isnan(untiled))
    assert bool(same.all())  # to the bit, NaN where the untiled twin has NaN
    want = np.asarray(JF.fused_normalized_conv_sweep_tiled(
        jnp.asarray(img), jnp.asarray(mask), sigma, SPACING, n_tiles=n_tiles,
        interpret=True))
    inside = mask != 0
    err = np.abs(got.numpy() - want)[inside].max() / np.abs(want[inside]).max()
    assert err <= TOL


@pytest.mark.parametrize("Y,ry,n_tiles", [(17, 2, 2), (23, 3, 3), (512, 28, 3),
                                          (5, 9, 4), (3, 1, 5)])
def test_tile_slabs_follow_ife_tpu(Y, ry, n_tiles):
    from ife_tpu_torch.kernels.normalized_conv import tile_slabs

    slabs = tile_slabs(Y, ry, n_tiles)
    bounds = [round(t * Y / n_tiles) for t in range(n_tiles + 1)]
    assert [(a, b) for a, b, _, _ in slabs] == list(zip(bounds[:-1], bounds[1:]))
    assert slabs[0][2] == 0 and slabs[-1][3] == Y
    for y0, y1, e0, e1 in slabs:
        assert e0 == max(0, y0 - ry) and e1 == min(Y, y1 + ry)
    with pytest.raises(ValueError, match="n_tiles"):
        tile_slabs(Y, ry, 0)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors run twins, other devices raise
# ---------------------------------------------------------------------------

def test_new_wrappers_never_reach_a_twin_off_the_cpu(monkeypatch):
    from ife_tpu_torch.kernels import (
        features8_post as post_mod, features8_sweep as sweep_mod,
        features8_ys_multi as ys_mod, normalized_conv as nc_mod,
    )

    def refuse(*a, **k):
        raise AssertionError("plain twin called for a non-CPU tensor")

    for mod, name in ((post_mod, "features8_post_plain"),
                      (nc_mod, "normalized_conv_tiled_plain"),
                      (nc_mod, "smooth_xz_plain"),
                      (sweep_mod, "features8_sweep_multi_plain"),
                      (ys_mod, "features8_ys_multi_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.empty((4, 4, 4), device="meta")
    for call in (lambda: K.fused_features8_post(x, x),
                 lambda: K.fused_normalized_conv_sweep_tiled(x, x, 1.0),
                 lambda: K.fused_smooth_xz(x, x, 1.0),
                 lambda: K.fused_features8_sweep_multi(x, x, (1.0,)),
                 lambda: K.fused_features8_ys_multi([x], [x], x, (1.0,))):
        with pytest.raises(ValueError, match="no kernel or plain path"):
            call()


def test_multi_scale_taps_tensor_rounds_once_and_pads():
    from ife_tpu_torch.kernels._build import MAX_TAPS, scale_taps_tensor

    rows = [TS.smooth_taps(s, 0.78)[0] for s in (0.6, 4.8)]
    t = scale_taps_tensor(rows, torch.device("cpu"))
    assert t.shape == (2, MAX_TAPS) and t.dtype == torch.float32
    for i, row in enumerate(rows):
        assert torch.equal(t[i, :len(row)],
                           torch.tensor(row, dtype=torch.float64).float())
        assert bool((t[i, len(row):] == 0).all())
    with pytest.raises(ValueError, match="taps"):
        scale_taps_tensor([(0.0,) * (MAX_TAPS + 2)], torch.device("cpu"))


def test_new_modules_import_without_jax():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import ife_tpu_torch.kernels.features8_ys_multi\n"
        "from ife_tpu_torch.ops.features import multiscale_features8_fused\n"
        "from ife_tpu_torch import kernels as K\n"
        "assert K.fused_features8_sweep_multi and K.fused_features8_post\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ife_tpu' or m.startswith('ife_tpu.')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
