"""ife_tpu_torch.parallel on the CPU against ife_tpu.parallel on its 8-device
CPU mesh, for the cases of tests/test_parallel.py: the same numpy inputs go
through the JAX sharded function (one shard_map program over 8 virtual
devices) and the port's (a mesh of 8 blocks owned by this one process, or by
two gloo processes in the CLI test), and through the port's single-device op.

Tolerances: f64 features <= 1e-9 of the channel's scale against ife_tpu
(eigenvalue channels as value-sorted triples where the eigen solve differs)
and <= 1e-12 absolute against the port's own single-device plain ops, ife_tpu's
own bound; the kernel route (use_fused=True: the plain twins of the shard
modes on CPU blocks) equals the single-device kernel route to the bit where
both take the same passes; integer counts equal; bags <= 1e-6 (f32
frequencies); the f32 two-process CLI run within the per-channel f32 budget.
"""
import os
import socket
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ife_tpu import parallel as JP
from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu.parallel import stats as JPS
from ife_tpu.roi.bag import make_bag_sharded as j_make_bag_sharded
from ife_tpu.roi.generate import generate_random_rois as j_generate_random_rois
from ife_tpu_torch import parallel as P
from ife_tpu_torch.io import read_volume, write_volume
from ife_tpu_torch.core.volume import Volume
from ife_tpu_torch.kernels import fused_hessian_eig
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues
from ife_tpu_torch.ops.features import (
    FEATURE_NAMES, features8, fused_features8, hessian_eig_features,
    multiscale_features,
)
from ife_tpu_torch.parallel import halo as halo_mod
from ife_tpu_torch.parallel import stats as PS
from ife_tpu_torch.roi.bag import make_bag, make_bag_device, make_bag_sharded
from ife_tpu_torch.roi.generate import ROI
from ife_tpu_torch.stats.equalize import edges_from_dense_counts
from ife_tpu_torch.stats.histogram import histogram_counts

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACING = (0.7, 0.9, 1.2)
TOL = 1e-9
MESHES = [("x",), ("x", "y")]


def _data(shape=(48, 40, 40), dtype=jnp.float64):
    img = np.array(j_synthetic_ct(shape, seed=5, dtype=dtype).data)
    mask = np.array(j_sphere_mask(shape, 0.42).data)
    return img, mask


def _mesh(n, axes):
    return P.make_mesh(n, axes, device="cpu")


def _jmesh(n, axes):
    return JP.make_mesh(n, axes, devices=jax.devices()[:n])


def _shard(mesh, *arrays):
    return tuple(P.shard_volume(a, mesh) for a in arrays)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _assert_features_last(got, want, eig, tol=TOL):
    """Channels last; `eig` the eigenvalue channels, compared sorted and
    per channel outside the ties (margin 2 tol of their joint scale)."""
    e = list(eig)
    assert _rel(np.sort(got[..., e], -1), np.sort(want[..., e], -1)) <= tol
    scale = max(np.abs(want[..., e]).max(), 1.0)
    gc, wc = tie_sorted_eigenvalues(
        [torch.from_numpy(np.array(got[..., c], np.float64)) for c in e],
        [torch.from_numpy(np.array(want[..., c], np.float64)) for c in e],
        2 * tol * scale)
    assert max((g - w).abs().max().item() for g, w in zip(gc, wc)) <= tol * scale
    for c in range(want.shape[-1]):
        if c not in e:
            assert _rel(got[..., c], want[..., c]) <= tol, c


# --------------------------------------------------------------------------
# meshes, sharding, halos
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_factors_like_ife_tpu(n):
    for axes in MESHES:
        assert _mesh(n, axes).dims == _jmesh(n, axes).devices.shape
    assert P.mesh_dims(_mesh(n, ("x",))) == (n, 1)
    with pytest.raises(ValueError, match="1D"):
        _mesh(n, ("x", "y", "z"))


def test_blocks_are_dealt_contiguously_to_processes():
    m = P.BlockMesh((4, 2), ("x", "y"), torch.device("cpu"), rank=1, world_size=2)
    assert m.local_blocks == [4, 5, 6, 7]
    assert [m.owner(b) for b in range(8)] == [0] * 4 + [1] * 4
    assert m.coords(5) == (2, 1) and m.index((2, 1)) == 5
    with pytest.raises(ValueError, match="evenly"):
        _mesh(0, ("x",))


@pytest.mark.parametrize("axes", MESHES)
def test_shard_gather_round_trip_and_pad_crop(axes):
    mesh = _mesh(8, axes)
    img, _ = _data((45, 37, 6))
    padded, orig = P.pad_to_mesh(img, mesh)
    j_padded, j_orig = JP.pad_to_mesh(img, _jmesh(8, axes))
    np.testing.assert_array_equal(padded, np.asarray(j_padded))
    assert orig == tuple(j_orig)
    t_padded, _ = P.pad_to_mesh(torch.from_numpy(img), mesh)
    np.testing.assert_array_equal(t_padded.numpy(), padded)
    zeros, _ = P.pad_to_mesh(torch.from_numpy(img), mesh, mode="constant")
    assert float(zeros[45:].abs().sum()) == 0 and float(zeros[:, 37:].abs().sum()) == 0
    sv = P.shard_volume(padded, mesh)
    assert sv.shape == padded.shape and len(sv.blocks) == 8
    assert all(b.is_contiguous() for b in sv.blocks)
    back = P.crop_from_mesh(P.gather_volume(sv), orig)
    np.testing.assert_array_equal(back.numpy(), img)
    np.testing.assert_array_equal(P.fetch_to_host(sv), padded)
    with pytest.raises(ValueError, match="pad_to_mesh"):
        P.shard_volume(img, mesh)


def test_halo_pad_is_edge_replication():
    x = torch.arange(24.0).reshape(4, 3, 2)
    y = P.halo_pad(x, 0, 2)
    want = np.asarray(JP.halo_pad(jnp.arange(24.0).reshape(4, 3, 2), 0, 2))
    np.testing.assert_array_equal(y.numpy(), want)
    assert y.shape == (8, 3, 2)


# h <= block extent (one neighbour), h > it (several blocks away: the
# multi-hop path, which must replicate the GLOBAL edge plane), both axes
@pytest.mark.parametrize("axes,axis,h", [(("x",), 0, 2), (("x",), 0, 6),
                                         (("x",), 0, 13), (("x", "y"), 0, 5),
                                         (("x", "y"), 1, 3), (("x", "y"), 1, 17),
                                         (("x",), 1, 2)])
def test_halo_exchange_is_the_edge_padded_volume_cut_into_blocks(axes, axis, h):
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((48, 40, 5))
    mesh = _mesh(8, axes)
    ext = P.halo_exchange(P.shard_volume(vol, mesh), axis, h)
    pad = [(0, 0)] * 3
    pad[axis] = (h, h)
    padded = np.pad(vol, pad, mode="edge")
    mx, my = P.mesh_dims(mesh)
    bx, by = 48 // mx, 40 // my
    for b, blk in zip(mesh.local_blocks, ext.blocks):
        c = mesh.coords(b)
        i, j = c[0], (c[1] if len(c) > 1 else 0)
        sx = slice(i * bx, (i + 1) * bx + (2 * h if axis == 0 else 0))
        sy = slice(j * by, (j + 1) * by + (2 * h if axis == 1 else 0))
        np.testing.assert_array_equal(blk.numpy(), padded[sx, sy])
    lo, hi = P.halo_slabs(P.shard_volume(vol, mesh), axis, h)
    for blk, a, b in zip(ext.blocks, lo, hi):
        assert torch.equal(blk.narrow(axis, 0, h), a)
        assert torch.equal(blk.narrow(axis, blk.shape[axis] - h, h), b)


def test_halo_pieces_reach_over_several_blocks():
    # block 1 of 4 blocks of 3 planes, 8 planes low: all of block 0, then 5
    # replicas of the global edge; high: blocks 2 and 3, 2 of them
    assert halo_mod._pieces(1, 4, 3, 8, True) == ([(0, 0, 3)], 5)
    assert halo_mod._pieces(1, 4, 3, 8, False) == ([(2, 0, 3), (3, 0, 3)], 2)
    assert halo_mod._pieces(2, 4, 3, 2, True) == ([(1, 1, 2)], 0)
    assert halo_mod._pieces(0, 1, 3, 2, True) == ([], 2)


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("sigma", [1.1, 2.5])
def test_sharded_features8_matches_ife_tpu_and_single_device(axes, sigma):
    # sigma 2.5: the radius (17 planes on x) exceeds the 6-plane blocks
    img, mask = _data()
    mesh = _mesh(8, axes)
    xi, mi = _shard(mesh, img, mask)
    got = P.gather_volume(P.sharded_features8(xi, mi, sigma, mesh, SPACING))
    single = features8(torch.from_numpy(img), torch.from_numpy(mask), sigma,
                       SPACING)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-12)
    jmesh = _jmesh(8, axes)
    want = np.asarray(JP.sharded_features8(
        JP.shard_volume(jnp.asarray(img), jmesh),
        JP.shard_volume(jnp.asarray(mask), jmesh), sigma, jmesh, SPACING))
    _assert_features_last(got.numpy(), want, (2, 3, 4))


@pytest.mark.parametrize("axes", MESHES)
# sigma 4.0 at 0.7 mm: x radius 26, past the xs-stream kernel's (rx <= 24),
# where the dispatcher takes the staged pair as the sharded route does
@pytest.mark.parametrize("sigma,branch", [(1.1, "sweep"), (4.0, "nc_conv+post")])
def test_sharded_features8_kernel_route_equals_the_single_device_kernels(
        axes, sigma, branch):
    # use_fused=True on CPU blocks runs the plain twins of the kernels' shard
    # modes: clamps on the extended block (sweep), x_halo / pre_padded after
    # the normalized convolution of the extended block (staged). Each equals
    # the single-device dispatcher where that takes the same passes.
    from ife_tpu_torch.ops.features import features8_dispatch_branch

    assert features8_dispatch_branch(sigma, SPACING, None) == branch
    img, mask = _data((32, 24, 12))
    mesh = _mesh(4, axes)
    xi, mi = _shard(mesh, img, mask)
    chans = P.sharded_features8(xi, mi, sigma, mesh, SPACING, use_fused=True,
                                stack=False)
    assert len(chans) == 8
    got = torch.stack([P.gather_volume(c) for c in chans])
    want = fused_features8(torch.from_numpy(img), torch.from_numpy(mask),
                           sigma, SPACING)
    assert torch.equal(got, want)


def test_sharded_hessian_eig_matches_ife_tpu_and_single_device():
    img, _ = _data()
    for axes in MESHES:
        mesh = _mesh(8, axes)
        (xi,) = _shard(mesh, img)
        got = P.gather_volume(P.sharded_hessian_eig(xi, mesh, SPACING))
        single = hessian_eig_features(torch.from_numpy(img), SPACING)
        assert torch.equal(got, single)
        # kernel route: x_halo rows on the 1D mesh, pre_padded on the 2D one
        fused = P.sharded_hessian_eig(xi, mesh, SPACING, use_fused=True,
                                      stack=False)
        assert torch.equal(torch.stack([P.gather_volume(c) for c in fused]),
                           fused_hessian_eig(torch.from_numpy(img), SPACING))
    jmesh = _jmesh(8, ("x", "y"))
    want = np.asarray(JP.sharded_hessian_eig(
        JP.shard_volume(jnp.asarray(img), jmesh), jmesh, SPACING))
    # ife_tpu's own bound for this raw-noise Hessian (its jitted program's
    # fusion-level rounding, amplified by the eigen solve)
    np.testing.assert_allclose(np.sort(got.numpy()[..., :3], -1),
                               np.sort(want[..., :3], -1), atol=1e-5)
    np.testing.assert_allclose(got.numpy()[..., 3:], want[..., 3:], atol=1e-5)


def test_sharded_multiscale_matches_ife_tpu_and_single_device():
    img, mask = _data((32, 32, 32))
    mesh = _mesh(4, ("x",))
    sigmas = (0.8, 1.6)
    xi, mi = _shard(mesh, img, mask)
    got = P.gather_volume(P.sharded_multiscale_features(xi, mi, sigmas, mesh,
                                                        SPACING))
    assert got.shape == (32, 32, 32, 2, 8)
    single = multiscale_features(torch.from_numpy(img), torch.from_numpy(mask),
                                 sigmas, SPACING)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-12)
    jmesh = _jmesh(4, ("x",))
    want = np.asarray(JP.sharded_multiscale_features(
        JP.shard_volume(jnp.asarray(img), jmesh),
        JP.shard_volume(jnp.asarray(mask), jmesh), sigmas, jmesh, SPACING))
    for i in range(2):
        _assert_features_last(got.numpy()[..., i, :], want[..., i, :], (2, 3, 4))


def test_features8_sharded_auto_nondivisible_shape():
    # 45x37x24: neither axis divides the 4x2 mesh -> pad-and-crop path
    img = np.array(j_synthetic_ct((45, 37, 24), seed=8, dtype=jnp.float64).data)
    mask = np.array(j_sphere_mask((45, 37, 24), 0.44).data)
    mesh = _mesh(8, ("x", "y"))
    got = P.features8_sharded_auto(img, mask, 0.9, mesh, SPACING)
    single = features8(torch.from_numpy(img), torch.from_numpy(mask), 0.9,
                       SPACING)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-12)
    want = np.asarray(JP.features8_sharded_auto(
        jnp.asarray(img), jnp.asarray(mask), 0.9, _jmesh(8, ("x", "y")),
        SPACING))
    _assert_features_last(got.numpy(), want, (2, 3, 4))


# --------------------------------------------------------------------------
# statistics
# --------------------------------------------------------------------------

def test_sharded_masked_histogram_matches_ife_tpu_and_single_device():
    img, mask = _data((32, 32, 32))
    mesh = _mesh(8, ("x", "y"))
    edges = np.linspace(-900, -100, 7)
    xi, mi = _shard(mesh, img, mask)
    got = P.sharded_masked_histogram(xi, mi, edges, mesh)
    assert got.dtype == torch.int32
    single = histogram_counts(torch.from_numpy(img), torch.from_numpy(edges),
                              torch.from_numpy((mask != 0).astype(np.int32)))
    assert torch.equal(got, single)
    assert int(got.sum()) == int((mask != 0).sum())
    jmesh = _jmesh(8, ("x", "y"))
    want = np.asarray(JP.sharded_masked_histogram(
        JP.shard_volume(jnp.asarray(img), jmesh),
        JP.shard_volume(jnp.asarray(mask), jmesh), jnp.asarray(edges), jmesh))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_masked_histogram_many_edges():
    rng = np.random.default_rng(5)
    img = rng.standard_normal((32, 64, 64)).astype(np.float32)
    mask = (rng.uniform(size=(32, 64, 64)) > 0.4).astype(np.uint8)
    mesh = _mesh(2, ("x",))
    edges = np.linspace(-3, 3, 4097).astype(np.float32)
    got = P.sharded_masked_histogram(*_shard(mesh, img, mask), edges, mesh)
    jmesh = _jmesh(2, ("x",))
    want = np.asarray(JP.sharded_masked_histogram(
        JP.shard_volume(jnp.asarray(img), jmesh),
        JP.shard_volume(jnp.asarray(mask), jmesh), jnp.asarray(edges), jmesh))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_fine", [64, 100])
def test_masked_fine_histogram_matches_ife_tpu(n_fine):
    # 64: the snapped power-of-two grid, binned arithmetically; 100: the
    # linspace grid through the histogram
    rng = np.random.default_rng(13)
    v = rng.standard_normal((16, 16, 16)).astype(np.float32)
    m = (rng.uniform(size=(16, 16, 16)) > 0.4).astype(np.uint8)
    mesh = _mesh(4, ("x",))
    vs, ms = _shard(mesh, v, m)
    bounds, counts = P.masked_fine_histogram(vs, ms, mesh, n_fine=n_fine)
    jmesh = _jmesh(4, ("x",))
    jb, jc = JPS.masked_fine_histogram(
        JP.shard_volume(jnp.asarray(v), jmesh),
        JP.shard_volume(jnp.asarray(m), jmesh), jmesh, n_fine=n_fine)
    np.testing.assert_array_equal(bounds, jb)
    np.testing.assert_array_equal(counts, jc)
    assert counts.size == n_fine and counts.sum() == int((m != 0).sum())
    vals = v[m != 0]
    assert bounds[0] <= vals.min() and bounds[-1] >= vals.max()
    with pytest.raises(ValueError, match="no voxels"):
        P.masked_fine_histogram(vs, ms.map(torch.zeros_like), mesh, n_fine)


def test_masked_fine_histograms_multi_matches_single():
    rng = np.random.default_rng(6)
    mesh = _mesh(4, ("x",))
    chans = [P.shard_volume(rng.standard_normal((16, 16, 16)).astype(np.float32),
                            mesh) for _ in range(3)]
    mask = P.shard_volume((rng.uniform(size=(16, 16, 16)) > 0.4).astype(np.uint8),
                          mesh)
    multi = P.masked_fine_histograms_multi(chans, mask, mesh, n_fine=64)
    for c, ch in enumerate(chans):
        b_s, c_s = P.masked_fine_histogram(ch, mask, mesh, n_fine=64)
        np.testing.assert_allclose(multi[c][0], b_s)
        np.testing.assert_array_equal(multi[c][1], c_s)


def test_quantile_edges_and_merge_equal_ife_tpu():
    rng = np.random.default_rng(0)
    samples = rng.normal(size=50_000)
    pre = np.linspace(-5, 5, 501)
    counts = histogram_counts(torch.from_numpy(samples),
                              torch.from_numpy(pre)).numpy()
    np.testing.assert_array_equal(P.histogram_quantile_edges(counts, pre, 10),
                                  JP.histogram_quantile_edges(counts, pre, 10))
    with pytest.raises(ValueError, match="counts"):
        P.histogram_quantile_edges(counts[:-1], pre, 10)

    def fine(v, n=256):
        bounds = np.linspace(v.min(), v.max(), n + 1)
        return bounds, np.histogram(v, bins=bounds)[0].astype(np.float64)

    hists = [fine(rng.normal(0, 1, 20_000)), fine(rng.normal(3, 2, 10_000))]
    for a, b in zip(P.merge_fine_histograms(hists),
                    JP.merge_fine_histograms(hists)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no histograms"):
        P.merge_fine_histograms([])


def test_sharded_feature_fine_histograms_match_host_quantiles():
    img, mask = _data((41, 35, 24))  # non-divisible: exercises the zero-pad mask
    mesh = _mesh(8, ("x", "y"))
    hists = P.sharded_feature_fine_histograms(img, mask, (1.0,), mesh, SPACING,
                                              n_fine=512)
    assert len(hists) == 8
    feats = features8(torch.from_numpy(img).float(), torch.from_numpy(mask),
                      1.0, SPACING).numpy()
    fg = mask != 0
    j_hists = JPS.sharded_feature_fine_histograms(
        img, mask, (1.0,), _jmesh(8, ("x", "y")), SPACING, n_fine=512)
    for k, (bounds, counts) in enumerate(hists):
        assert counts.sum() == fg.sum()
        vals = feats[fg][:, k]
        approx = edges_from_dense_counts(bounds, counts, 5)
        exact = np.quantile(vals, np.arange(1, 5) / 5)
        tol = max((vals.max() - vals.min()) / 512 * 1.5, 1e-12)
        np.testing.assert_allclose(approx, exact, atol=tol)
        # against ife_tpu's pipeline: the same edges within one fine bin
        # (the f32 features of the two differ in their last bits)
        j_edges = edges_from_dense_counts(*j_hists[k], 5)
        np.testing.assert_allclose(approx, j_edges, atol=tol)


def test_make_bag_sharded_matches_host_bag_and_ife_tpu():
    img, mask = _data((41, 35, 24))
    img = img.astype(np.float32)
    mask = mask.astype(np.uint8)
    rois = j_generate_random_rois(mask, n=6, size=(9, 9, 9), seed=3)
    rois = [ROI(r.index, r.size) for r in rois]
    rng = np.random.default_rng(2)
    edges = [np.sort(rng.normal(0, 50, 5)) for _ in range(8)]
    mesh = _mesh(8, ("x", "y"))
    mixed = rois[:3] + [ROI(rois[3].index, (5, 7, 5)),
                        ROI(rois[4].index, (5, 7, 5)), rois[5]]
    for boxes in (rois, mixed):
        got = make_bag_sharded(img, mask, (1.0,), edges, boxes, mesh, SPACING)
        host = make_bag(img, mask, (1.0,), edges, boxes, SPACING, device="cpu")
        np.testing.assert_allclose(got, host, atol=1e-6)
        dev = make_bag_device(img, mask, (1.0,), edges, boxes, SPACING,
                              device="cpu")
        np.testing.assert_allclose(got, dev, atol=1e-6)
        # a bool mask clamps to the same uint8 labels: the same bags
        on = mask.astype(bool)
        assert np.array_equal(
            make_bag_sharded(img, on, (1.0,), edges, boxes, mesh, SPACING), got)
        assert np.array_equal(
            make_bag(img, on, (1.0,), edges, boxes, SPACING, device="cpu"), host)
    want = j_make_bag_sharded(img, mask, (1.0,), edges, rois,
                              _jmesh(8, ("x", "y")), SPACING)
    np.testing.assert_allclose(
        make_bag_sharded(img, mask, (1.0,), edges, rois, mesh, SPACING), want,
        atol=1e-6)


class _GatherMeter:
    """Wraps parallel.mesh.gather_volume (behind make_bag_sharded and, on
    one process, gather_volume_to): the bytes of the arrays it handed out
    that are still alive, at their peak. A view of a gathered array (a
    crop) keeps it alive through its ._base."""

    def __init__(self, fn):
        self.fn, self.live, self.peak, self.calls = fn, 0, 0, 0

    def __call__(self, sv):
        out = self.fn(sv)
        n = out.numel() * out.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        self.calls += 1
        weakref.finalize(out, self._drop, n)
        return out

    def _drop(self, n):
        self.live -= n


@pytest.mark.parametrize("axes", MESHES)
def test_sharded_routes_hold_at_most_one_gathered_channel(tmp_path,
                                                          monkeypatch, axes):
    # make_bag_sharded and extract-features --sharded gather the 8 channels
    # one at a time (one live), and end equal to the all-channels-at-once
    # gathers they replace: the same bag, the same files
    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.parallel import mesh as mesh_mod
    from ife_tpu_torch.roi.bag import (
        _edges_block, roi_feature_histograms_device,
    )

    shape = (41, 35, 24)  # padded to the mesh grid: (44, 35, 24) / (42, 36, 24)
    img, mask = _data(shape)
    img, mask = img.astype(np.float32), mask.astype(np.uint8)
    rois = [ROI(r.index, r.size)
            for r in j_generate_random_rois(mask, n=6, size=(9, 9, 9), seed=3)]
    rng = np.random.default_rng(2)
    edges = [np.sort(rng.normal(0, 50, 5)) for _ in range(8)]
    mesh = _mesh(4, axes)
    padded = P.pad_to_mesh(img, mesh)[0].shape
    one_channel = int(np.prod(padded)) * 4

    # today's bag: all eight gathered channels binned at once
    chans = P.sharded_features8(*_shard(mesh, P.pad_to_mesh(img, mesh)[0],
                                        P.pad_to_mesh(mask, mesh)[0]),
                                1.0, mesh, SPACING, stack=False)
    feats = [P.crop_from_mesh(P.gather_volume(c), shape) for c in chans]
    starts = np.asarray([r.index for r in rois])
    want = roi_feature_histograms_device(
        feats, torch.from_numpy(mask), starts, _edges_block(edges, 0),
        (9, 9, 9))
    want = want.numpy().astype(np.float64).reshape(len(rois), -1)
    del chans, feats

    meter = _GatherMeter(mesh_mod.gather_volume)
    monkeypatch.setattr(mesh_mod, "gather_volume", meter)
    got = make_bag_sharded(img, mask, (1.0,), edges, rois, mesh, SPACING)
    assert np.array_equal(got, want)
    assert (meter.calls, meter.peak, meter.live) == (8, one_channel, 0)

    # extract-features --sharded: each channel gathered, written, dropped
    d = tmp_path
    write_volume(str(d / "img.nii.gz"),
                 Volume(torch.from_numpy(img), spacing=SPACING))
    write_volume(str(d / "mask.nii.gz"),
                 Volume(torch.from_numpy(mask), spacing=SPACING))
    meter.calls = meter.peak = 0
    assert main(["extract-features", "-i", str(d / "img.nii.gz"), "-m",
                 str(d / "mask.nii.gz"), "-s", "1.0", "-o", str(d / "sh"),
                 "--sharded", "--blocks", "4"]) == 0
    cli_mesh = _mesh(4, ("x", "y"))  # the CLI's mesh of 4 blocks: 2 x 2
    cli_channel = int(np.prod(P.pad_to_mesh(img, cli_mesh)[0].shape)) * 4
    assert (meter.calls, meter.peak, meter.live) == (8, cli_channel, 0)
    monkeypatch.undo()
    vol, msk = read_volume(str(d / "img.nii.gz")), read_volume(str(d / "mask.nii.gz"))
    # today's files: the whole stacked array on every process, unbound
    old = P.features8_sharded_auto(vol.data.float(), msk.data, 1.0, cli_mesh,
                                   vol.spacing).unbind(-1)
    for name, o in zip(FEATURE_NAMES, old):
        assert torch.equal(read_volume(str(d / f"sh_scale_1{name}.nii.gz")).data,
                           o), name


def test_sharded_runs_are_bitwise_deterministic_and_order_independent():
    img, mask = _data((32, 32, 32), jnp.float32)
    mesh = _mesh(8, ("x", "y"))
    xi, mi = _shard(mesh, img, mask)
    edges = np.linspace(-900.0, -100.0, 7).astype(np.float32)

    def run():
        f = P.sharded_features8(xi, mi, 1.0, mesh, SPACING, stack=False)
        h = P.sharded_masked_histogram(f[0], mi, edges, mesh)
        return torch.stack([P.gather_volume(c) for c in f]), h

    (f1, h1), (f2, h2) = run(), run()
    assert torch.equal(f1, f2) and torch.equal(h1, h2)
    assert h1.dtype == torch.int32
    # flipped along x: the same (value, mask) pairs in other blocks
    h_ref = P.sharded_masked_histogram(xi, mi, edges, mesh)
    h_flip = P.sharded_masked_histogram(
        *_shard(mesh, img[::-1].copy(), mask[::-1].copy()), edges, mesh)
    assert torch.equal(h_ref, h_flip)


# --------------------------------------------------------------------------
# two processes through the CLI (gloo)
# --------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    """The port runs on the card unless asked: the CLI runs in this process
    ask for the CPU, as the subprocesses of _run_distributed do."""
    monkeypatch.setenv("IFE_PLATFORM", "cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_distributed(args, nprocs=2, timeout=150):
    """The same port command in `nprocs` coordinated CPU processes."""
    env = dict(os.environ, IFE_PLATFORM="cpu", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ife_tpu_torch", *[str(a) for a in args],
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(nprocs),
         "--process-id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_two_process_cli_matches_single_process(tmp_path):
    d = tmp_path
    img, mask = _data((24, 20, 16), jnp.float32)
    write_volume(str(d / "img.nii.gz"),
                 Volume(torch.from_numpy(img), spacing=SPACING))
    write_volume(str(d / "mask.nii.gz"),
                 Volume(torch.from_numpy(mask), spacing=SPACING))
    base = ["extract-features", "-i", d / "img.nii.gz", "-m",
            d / "mask.nii.gz", "-s", "1.0"]
    from ife_tpu_torch.cli.main import main

    assert main([str(a) for a in (*base, "-o", d / "single")]) == 0
    # 4 blocks over 2 processes: halos cross both a local and a remote face
    cmd = [*base, "-o", d / "mp", "--sharded", "--blocks", "4", "--manifest",
           d / "mp.manifest.json"]
    for rc, out in _run_distributed(cmd):
        assert rc == 0, out
        assert "sharding over 4 blocks" in out
    budget = dict(zip(FEATURE_NAMES, (1e-6, 2e-6, 1e-5, 1e-5, 2.4e-5, 1.5e-5,
                                      1.5e-5, 1.3e-5)))
    for name in FEATURE_NAMES:
        a = read_volume(str(d / f"single_scale_1{name}.nii.gz")).numpy()
        b = read_volume(str(d / f"mp_scale_1{name}.nii.gz")).numpy()
        assert _rel(b, a) < budget[name], name
    # restart: the manifest marks scale 1 complete -> both processes skip
    for rc, out in _run_distributed(cmd):
        assert rc == 0, out
        assert "Skipping completed scale" in out
    # the bin edges of two processes equal those of one (integer counts)
    (d / "pairs.txt").write_text(f"{d / 'img.nii.gz'},{d / 'mask.nii.gz'}\n")
    edges = ["determine-bin-edges", "-l", d / "pairs.txt", "-s", "1.0",
             "--bins", "4", "--sharded", "--blocks", "4", "--fine-bins", "256"]
    assert main([str(a) for a in (*edges, "-o", d / "edges_1p.txt")]) == 0
    for rc, out in _run_distributed([*edges, "-o", d / "edges_2p.txt"]):
        assert rc == 0, out
    assert (d / "edges_1p.txt").read_text() == (d / "edges_2p.txt").read_text()
