"""The shard modes of ife_tpu_torch's kernels on the CPU: `clamps` of the two
sweeps, `x_halo` and `pre_padded` of the Hessian and post kernels. Given CPU
tensors each wrapper runs its plain twin in the same mode; the twin is held
against the Pallas kernel it replaces, run in interpret mode on the cases of
tests/test_kernels.py (test_sweep_halo_extended_clamps,
test_post_stream_matches_windowed_post, test_stream_kernel_x_halo_rows,
test_post_stream_x_halo_rows), in f64 at <= 1e-9 of the channel's scale
(eigenvalue channels as value-sorted triples; 1e-8 for the Hessian of the raw,
unsmoothed volume, whose near-repeated eigenvalues amplify the two
implementations' different association in the closed-form solve), and against the port's own
whole-volume result, which a mode must reproduce on the core to the bit.

The CUDA kernels' modes are tested on the card (tests/test_torch_gpu.py).
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu.kernels import fused as JF
from ife_tpu.ops.stencil import gaussian_smooth as j_gaussian_smooth
from ife_tpu_torch import kernels as K

torch.set_num_threads(1)

SPACING = (0.7, 0.9, 1.2)
TOL = 1e-9
BIG = 1 << 30


def _inputs(shape, seed):
    img = np.array(j_synthetic_ct(shape, seed=seed, dtype=jnp.float64).data)
    mask = np.array(j_sphere_mask(shape, 0.45).data).astype(np.float64)
    return img, mask


def _assert_channels(got, want, eig, tol=TOL):
    """got/want: sequences of (X, Y, Z) channels; `eig` the indices of the
    eigenvalue channels, compared as value-sorted triples."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    gs = np.sort(np.stack([got[i] for i in eig]), 0)
    ws = np.sort(np.stack([want[i] for i in eig]), 0)
    assert np.abs(gs - ws).max() / max(np.abs(ws).max(), 1.0) <= tol
    for i in range(len(want)):
        if i not in eig:
            err = np.abs(got[i] - want[i]).max() / max(np.abs(want[i]).max(), 1.0)
            assert err <= tol, (i, err)


def _pad(a, r, q):
    return np.pad(a, ((r, r), (q, q), (0, 0)), mode="edge")


# (extend x, extend y): a 1D-sharded block with both faces true; a 2D-mesh
# block with all four faces true
@pytest.mark.parametrize("ext_y", [False, True])
def test_sweep_clamps_on_a_halo_extended_block(ext_y):
    shape, sigma = (20, 18, 16), 1.0
    img, mask = _inputs(shape, 9)
    r = max(1, math.ceil(4.5 * sigma / SPACING[0])) + 1
    q = max(1, math.ceil(4.5 * sigma / SPACING[1])) + 1 if ext_y else 0
    xe, me = _pad(img, r, q), _pad(mask, r, q)
    clamps = [r, r + shape[0] - 1, q, q + shape[1] - 1]
    core = (slice(None), slice(r, r + shape[0]), slice(q, q + shape[1]))
    got = K.fused_features8_sweep(torch.from_numpy(xe), torch.from_numpy(me),
                                  sigma, SPACING, clamps=clamps)[core]
    want = JF.fused_features8_sweep(
        jnp.asarray(xe), jnp.asarray(me), sigma, SPACING, interpret=True,
        clamps=jnp.asarray(clamps, jnp.int32))
    _assert_channels(got.numpy(), np.asarray(want)[core], (2, 3, 4))
    # the core equals the whole-volume sweep to the bit: the halo's edge
    # replication is clamp smoothing, the clamps put the stencil's phantom on
    # the smoothed field
    whole = K.fused_features8_sweep(torch.from_numpy(img),
                                    torch.from_numpy(mask), sigma, SPACING)
    assert torch.equal(got, whole)
    # without the clamps the outermost derivative layers are wrong (seen
    # with a mask that keeps them: the sphere zeroes the faces)
    ones, ones_e = torch.ones(shape, dtype=torch.float64), torch.ones(xe.shape, dtype=torch.float64)
    whole1 = K.fused_features8_sweep(torch.from_numpy(img), ones, sigma, SPACING)
    good = K.fused_features8_sweep(torch.from_numpy(xe), ones_e, sigma,
                                   SPACING, clamps=clamps)[core]
    bad = K.fused_features8_sweep(torch.from_numpy(xe), ones_e, sigma,
                                  SPACING)[core]
    assert torch.equal(good, whole1)
    assert not torch.equal(bad[1], whole1[1])
    assert torch.equal(bad[:, 1:-1, 1:-1] if ext_y else bad[:, 1:-1],
                       whole1[:, 1:-1, 1:-1] if ext_y else whole1[:, 1:-1])


def test_sweep_clamps_with_an_interior_side():
    # block [8, 16) of a 24-row volume, extended by real neighbour rows: no
    # true face in x (+-2^30), both in y
    shape, sigma = (24, 12, 10), 0.8
    img, mask = _inputs(shape, 11)
    r = max(1, math.ceil(4.5 * sigma / SPACING[0])) + 1
    assert 8 - r >= 0 and 16 + r <= 24
    xe, me = img[8 - r:16 + r], mask[8 - r:16 + r]
    clamps = [-BIG, BIG, 0, shape[1] - 1]
    got = K.fused_features8_sweep(torch.from_numpy(xe), torch.from_numpy(me),
                                  sigma, SPACING, clamps=clamps)[:, r:r + 8]
    whole = K.fused_features8_sweep(torch.from_numpy(img),
                                    torch.from_numpy(mask), sigma, SPACING)
    assert torch.equal(got, whole[:, 8:16])
    want = JF.fused_features8_sweep(
        jnp.asarray(xe), jnp.asarray(me), sigma, SPACING, interpret=True,
        clamps=jnp.asarray(clamps, jnp.int32))
    _assert_channels(got.numpy(), np.asarray(want)[:, r:r + 8], (2, 3, 4))


def test_sweep_multi_clamps_match_pallas_and_the_single_sweep():
    shape, sigmas = (14, 12, 10), (0.6, 0.9)
    img, mask = _inputs(shape, 12)
    r = max(1, math.ceil(4.5 * max(sigmas) / SPACING[0])) + 1
    xe, me = _pad(img, r, 0), _pad(mask, r, 0)
    clamps = [r, r + shape[0] - 1, 0, shape[1] - 1]
    got = K.fused_features8_sweep_multi(
        torch.from_numpy(xe), torch.from_numpy(me), sigmas, SPACING,
        clamps=clamps)
    want = np.asarray(JF.fused_features8_sweep_multi(
        jnp.asarray(xe), jnp.asarray(me), sigmas, SPACING, interpret=True,
        stack=True, clamps=jnp.asarray(clamps, jnp.int32)))
    for i, s in enumerate(sigmas):
        _assert_channels(got[i, :, r:-r].numpy(), want[i][:, r:-r], (2, 3, 4))
        one = K.fused_features8_sweep(torch.from_numpy(xe),
                                      torch.from_numpy(me), s, SPACING,
                                      clamps=clamps)
        assert torch.equal(got[i], one)


def test_default_clamps_are_the_arrays_faces_and_bad_clamps_raise():
    img, mask = _inputs((9, 8, 7), 3)
    x, m = torch.from_numpy(img), torch.from_numpy(mask)
    a = K.fused_features8_sweep(x, m, 1.0, SPACING)
    assert torch.equal(a, K.fused_features8_sweep(x, m, 1.0, SPACING,
                                                  clamps=[0, 8, 0, 7]))
    assert torch.equal(a, K.fused_features8_sweep(
        x, m, 1.0, SPACING, clamps=torch.tensor([0, 8, 0, 7])))
    with pytest.raises(ValueError, match="clamps"):
        K.fused_features8_sweep(x, m, 1.0, SPACING, clamps=[0, 8, 0])
    with pytest.raises(ValueError, match="clamps"):
        K.fused_features8_sweep(x, m, 1.0, SPACING, clamps=[0, 8, 0, 1 << 31])


@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 11, 16)])
@pytest.mark.parametrize("entry", ["post_stream", "post"])
def test_post_pre_padded_matches_pallas_interpret(shape, entry):
    img, mask = _inputs(shape, 12)
    s = np.array(j_gaussian_smooth(jnp.asarray(img), 1.0, SPACING))
    sp = _pad(s, 1, 1)
    t_fn = {"post_stream": K.fused_features8_post_stream,
            "post": K.fused_features8_post}[entry]
    j_fn = {"post_stream": JF.fused_features8_post_stream,
            "post": JF.fused_features8_post}[entry]
    got = t_fn(torch.from_numpy(sp), torch.from_numpy(mask), SPACING,
               pre_padded=True)
    assert got.shape == (8,) + shape
    want = j_fn(jnp.asarray(sp), jnp.asarray(mask), SPACING, interpret=True,
                pre_padded=True)
    _assert_channels(got.numpy(), np.asarray(want), (2, 3, 4))
    # an edge-replicated layer is the whole-volume clamp
    assert torch.equal(got, K.fused_features8_post_stream(
        torch.from_numpy(s), torch.from_numpy(mask), SPACING))


def test_post_stream_x_halo_rows_match_pallas_interpret():
    img, mask = _inputs((14, 10, 16), 15)
    s = np.array(j_gaussian_smooth(jnp.asarray(img), 1.0, SPACING))
    whole = K.fused_features8_post_stream(torch.from_numpy(s),
                                          torch.from_numpy(mask), SPACING)
    h = 7
    halves = []
    for sl, (lo, hi) in ((slice(0, h), (s[:1], s[h:h + 1])),
                         (slice(h, None), (s[h - 1:h], s[-1:]))):
        got = K.fused_features8_post_stream(
            torch.from_numpy(s[sl]), torch.from_numpy(mask[sl]), SPACING,
            x_halo=(torch.from_numpy(lo), torch.from_numpy(hi)))
        want = JF.fused_features8_post_stream(
            jnp.asarray(s[sl]), jnp.asarray(mask[sl]), SPACING,
            interpret=True, x_halo=(jnp.asarray(lo), jnp.asarray(hi)))
        _assert_channels(got.numpy(), np.asarray(want), (2, 3, 4))
        halves.append(got)
    assert torch.equal(torch.cat(halves, dim=1), whole)


@pytest.mark.parametrize("X", [12, 14])
def test_hessian_x_halo_rows_match_pallas_interpret(X):
    img, _ = _inputs((X, 10, 16), 14)
    whole = K.fused_hessian_eig_stream(torch.from_numpy(img), SPACING)
    h = X // 2
    halves = []
    for sl, (lo, hi) in ((slice(0, h), (img[:1], img[h:h + 1])),
                         (slice(h, None), (img[h - 1:h], img[-1:]))):
        got = K.fused_hessian_eig_stream(
            torch.from_numpy(img[sl]), SPACING,
            x_halo=(torch.from_numpy(lo), torch.from_numpy(hi)))
        want = JF.fused_hessian_eig_stream(
            jnp.asarray(img[sl]), SPACING, block=2, interpret=True,
            x_halo=(jnp.asarray(lo), jnp.asarray(hi)))
        _assert_channels(got.numpy(), np.asarray(want), (0, 1, 2), tol=1e-8)
        halves.append(got)
    assert torch.equal(torch.cat(halves, dim=1), whole)


def test_hessian_pre_padded_matches_pallas_interpret():
    img, _ = _inputs((12, 10, 16), 13)
    ext = _pad(img, 1, 1)
    got = K.fused_hessian_eig(torch.from_numpy(ext), SPACING, pre_padded=True)
    assert got.shape == (6, 12, 10, 16)
    want = JF.fused_hessian_eig(jnp.asarray(ext), SPACING, interpret=True,
                                pre_padded=True)
    _assert_channels(got.numpy(), np.asarray(want), (0, 1, 2), tol=1e-8)
    assert torch.equal(got, K.fused_hessian_eig(torch.from_numpy(img), SPACING))
    # real neighbour data in the layer: the core of a larger volume
    big, _ = _inputs((14, 12, 16), 13)
    inner = K.fused_hessian_eig(torch.from_numpy(big), SPACING,
                                pre_padded=True)
    assert torch.equal(inner, K.fused_hessian_eig(
        torch.from_numpy(big), SPACING)[:, 1:-1, 1:-1])


def test_x_halo_and_pre_padded_exclude_each_other():
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    halo = (x[:1], x[:1])
    with pytest.raises(ValueError, match="mutually exclusive"):
        K.fused_features8_post_stream(x, x, pre_padded=True, x_halo=halo)
    with pytest.raises(ValueError, match="mutually exclusive"):
        K.fused_hessian_eig_stream(x, pre_padded=True, x_halo=halo)
