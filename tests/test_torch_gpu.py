"""ife_tpu_torch's CUDA kernels on the card, against their plain PyTorch
twins. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor ife_tpu, so it runs on a machine without
JAX; tests/conftest.py imports JAX, so run it there without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from ife_tpu_torch.core.volume import sphere_mask, synthetic_ct
from ife_tpu_torch import kernels as K

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

TOL = 1e-4  # bench.py's on-chip bound, relative to max(max|plain|, 1)
SHAPES = [(13, 12, 11), (40, 36, 33)]
SPACING = (0.7, 0.9, 1.2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`")
    return torch.device("cuda")


def _inputs(shape, dev):
    img = synthetic_ct(shape, seed=3, device=dev).data.contiguous()
    mask = sphere_mask(shape, 0.42, dtype=torch.float32, device=dev).data
    return img, mask.contiguous()


def _rel(got, ref):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _same(got, ref):
    """Bit-equal, NaN where ref is NaN: the kernels are built without FMA
    contraction and keep their twins' association (kernels/_build.py)."""
    both_nan = torch.isnan(got) & torch.isnan(ref)
    return bool(((got == ref) | both_nan).all())


def _feature_err(got, ref, eig):
    gs = np.sort(np.stack([got[i].double().cpu().numpy() for i in eig]), 0)
    rs = np.sort(np.stack([ref[i].double().cpu().numpy() for i in eig]), 0)
    errs = [np.abs(gs - rs).max() / max(np.abs(rs).max(), 1.0)]
    errs += [_rel(got[i], ref[i]) for i in range(len(ref)) if i not in eig]
    return max(errs)


# the Hessian kernel's edges (csrc/hessian_eig.cu: (y, z) tiles of 8 x 128
# marching chunks of x, kernels.hessian_plan): one voxel over a tile on y and
# on z, rows of 16-byte pieces (Z % 4 == 0) with a ragged last tile and
# without, x chunks of many planes (33 and 64 planes over 66 and 99 tiles)
HESSIAN_EDGE_SHAPES = [(9, 9, 129), (33, 257, 132), (64, 257, 260), (2, 1, 4),
                       (17, 8, 128)]


def _halo_and_layer(img):
    """Random x_halo rows for img and img inside a random one-voxel layer
    on x and y: neighbour rows that are no face of img."""
    g = torch.Generator(device=img.device).manual_seed(4)
    X, Y, Z = img.shape
    lo, hi = (torch.randn((1, Y, Z), generator=g, device=img.device) * 300.0
              for _ in range(2))
    pad = torch.randn((X + 2, Y + 2, Z), generator=g, device=img.device) * 300.0
    pad[1:-1, 1:-1] = img
    return (lo, hi), pad


@pytest.mark.parametrize("shape", SHAPES + HESSIAN_EDGE_SHAPES)
def test_hessian_eig_kernel_matches_plain(cuda, shape):
    img, _ = _inputs(shape, cuda)
    got = K.fused_hessian_eig_stream(img, SPACING, stack=False)
    want = K.hessian_eig_plain(img, SPACING)
    assert _feature_err(got, want, (0, 1, 2)) < TOL
    assert all(_same(g, w) for g, w in zip(got, want))
    halo, pad = _halo_and_layer(img)
    for kw, x in ((dict(x_halo=halo), img), (dict(pre_padded=True), pad)):
        got = K.fused_hessian_eig_stream(x, SPACING, stack=False, **kw)
        want = K.hessian_eig_plain(x, SPACING, **kw)
        assert all(_same(g, w) for g, w in zip(got, want)), kw


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 2.4, 4.8])
def test_normalized_conv_kernel_matches_plain(cuda, shape, sigma):
    img, mask = _inputs(shape, cuda)
    got = K.fused_normalized_conv_sweep(img, mask, sigma, SPACING)
    want = K.normalized_conv_plain(img, mask, sigma, SPACING)
    inside = mask != 0
    assert _rel(got[inside], want[inside]) < TOL
    # the no-epsilon divide: NaN exactly where the plain version has NaN
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert _same(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_features8_post_kernel_matches_plain(cuda, shape):
    img, mask = _inputs(shape, cuda)
    s = K.normalized_conv_plain(img, mask, 1.2, SPACING)
    got = K.fused_features8_post_stream(s, mask, SPACING, stack=False)
    want = K.features8_post_plain(s, mask, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _feature_err(got, want, (2, 3, 4)) < TOL
    assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 1.2, 2.4])
def test_features8_sweep_kernel_matches_plain(cuda, shape, sigma):
    # the sweep is instantiated for x radii up to 10 (its x queue lives in
    # registers) and raises beyond: sigma 2.4 at 0.7 mm is rx 16
    img, mask = _inputs(shape, cuda)
    if not K.sweep_fits(sigma, SPACING):
        assert sigma == 2.4
        with pytest.raises(ValueError, match="sweep_fits"):
            K.fused_features8_sweep(img, mask, sigma, SPACING)
        return
    got = K.fused_features8_sweep(img, mask, sigma, SPACING, stack=False)
    want = K.features8_sweep_plain(img, mask, sigma, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(_same(g, w) for g, w in zip(got, want))


THIN = [(5, 40, 33), (40, 9, 33), (23, 17, 1), (3, 2, 70), (140, 15, 35)]
ANISOTROPIC = (0.78, 0.6, 1.1)  # ry != rx != rz


def _sigma_of(rx):
    """A sigma whose x radius at 0.78 mm is rx (radius = ceil(4.5 s / h))."""
    return (rx - 0.5) * ANISOTROPIC[0] / 4.5


@pytest.mark.parametrize("shape", SHAPES + THIN)
@pytest.mark.parametrize("rx", range(1, 11))
def test_sweep_kernel_at_every_instantiated_radius(cuda, shape, rx):
    # thin volumes: X below a chunk, Y below a tile, Z = 1, radii beyond the
    # extent; (140, 15, 35): X over a chunk
    img, mask = _inputs(shape, cuda)
    labels = mask * 3.0
    sigma = _sigma_of(rx)
    assert K.sweep_fits(sigma, ANISOTROPIC)
    X, Y, _ = shape
    cl = [min(2, X - 1), K.NO_FACE, -K.NO_FACE, max(Y - 3, 0)]
    for clamps in (None, cl):
        got = K.fused_features8_sweep(img, labels, sigma, ANISOTROPIC,
                                      stack=False, clamps=clamps)
        want = K.features8_sweep_plain(img, labels, sigma, ANISOTROPIC,
                                       clamps=clamps)
        assert all(_same(g, w) for g, w in zip(got, want)), clamps


@pytest.mark.parametrize("shape", THIN)
@pytest.mark.parametrize("sigmas", [(1.2,), (0.6, 1.2), (0.3, 0.45, 0.6),
                                    (0.2,) * 4, (1.7,), (0.34, 0.2, 0.3, 0.1)])
def test_sweep_multi_kernel_in_every_class_on_thin_volumes(cuda, shape, sigmas):
    sp = (0.78, 0.9, 1.0)
    img, mask = _inputs(shape, cuda)
    labels = mask * 3.0
    assert K.sweep_multi_fits(sigmas, sp)
    X, Y, _ = shape
    cl = [min(2, X - 1), K.NO_FACE, -K.NO_FACE, max(Y - 3, 0)]
    for clamps in (None, cl):
        got = K.fused_features8_sweep_multi(img, labels, sigmas, sp,
                                            stack=False, clamps=clamps)
        want = K.features8_sweep_multi_plain(img, labels, sigmas, sp,
                                             clamps=clamps)
        assert all(_same(g, w) for g, w in zip(_flat(got), _flat(want)))


@pytest.mark.parametrize("name", ["empty", "half of x", "the last voxel",
                                  "the first voxel", "ones"])
def test_sweeps_skip_what_the_mask_leaves_empty(cuda, name):
    """The sweeps store zeros on the planes of a chunk whose tile holds no
    voxel inside the mask, and run no tail outside it: the same bits as the
    twin, which computes everything and selects."""
    shape = (70, 40, 45)
    img, mask = _inputs(shape, cuda)
    m = torch.zeros_like(mask)
    if name == "half of x":
        m[31:] = mask[31:]
    elif name == "the last voxel":
        m[-1, -1, -1] = 2.0
    elif name == "the first voxel":
        m[0, 0, 0] = 1.0
    elif name == "ones":
        m += 1.0
    for sigma in (0.3, 1.0):
        got = K.fused_features8_sweep(img, m, sigma, ANISOTROPIC, stack=False)
        want = K.features8_sweep_plain(img, m, sigma, ANISOTROPIC)
        assert all(_same(g, w) for g, w in zip(got, want)), sigma
        assert all(bool((g[m == 0] == 0).all()) for g in got)
    got = K.fused_features8_sweep_multi(img, m, (0.3, 0.6), ANISOTROPIC,
                                        stack=False)
    want = K.features8_sweep_multi_plain(img, m, (0.3, 0.6), ANISOTROPIC)
    assert all(_same(g, w) for g, w in zip(_flat(got), _flat(want)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 2.4, 3.4, 4.8])
def test_smooth_yz_and_xs_stream_kernels_match_plain(cuda, shape, sigma):
    img, mask = _inputs(shape, cuda)
    num, den = K.fused_smooth_yz(img, mask, sigma, SPACING)
    pnum, pden = K.smooth_yz_plain(img, mask, sigma, SPACING)
    assert _same(num, pnum) and _same(den, pden)
    # rx 31 at sigma 4.8: the ring fits the narrowest tile (rx <= 69)
    assert K.xs_stream_fits(sigma, SPACING)
    got = K.fused_features8_xs_stream(num, den, mask, sigma, SPACING,
                                      stack=False)
    want = K.features8_xs_stream_plain(num, den, mask, sigma, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["empty", "one octant", "full", "sphere"])
def test_xs_stream_and_ys_multi_skip_what_the_mask_leaves_empty(cuda, name):
    """xs_stream at x radii that its launcher serves with each of its tiles
    (14, 8, 6 and 4 rows) and ys_multi at S = 1 .. 3 store zeros on the
    planes of a chunk whose tile holds no voxel inside the mask and run no
    tail outside it: the same bits as the twins."""
    shape = (70, 40, 45)
    img, mask = _inputs(shape, cuda)
    m = {"empty": torch.zeros_like(mask), "full": torch.ones_like(mask),
         "sphere": mask, "one octant": torch.zeros_like(mask)}[name]
    if name == "one octant":
        m[:35, :20, :23] = 1.0
    for rx in (11, 12, 14, 20, 28):
        sigma = _sigma_of(rx)
        num, den = K.smooth_yz_plain(img, m, sigma, ANISOTROPIC)
        got = K.fused_features8_xs_stream(num, den, m, sigma, ANISOTROPIC,
                                          stack=False)
        want = K.features8_xs_stream_plain(num, den, m, sigma, ANISOTROPIC)
        assert all(_same(g, w) for g, w in zip(got, want)), rx
        assert all(bool((g[m == 0] == 0).all()) for g in got)
    for sigmas in ((2.4,), (1.2, 3.0), (0.6, 2.4, 4.8)):
        pairs = [K.smooth_xz_plain(img, m, s, ANISOTROPIC) for s in sigmas]
        nums, dens = [a for a, _ in pairs], [b for _, b in pairs]
        got = K.fused_features8_ys_multi(nums, dens, m, sigmas, ANISOTROPIC,
                                         stack=False)
        want = K.features8_ys_multi_plain(nums, dens, m, sigmas, ANISOTROPIC)
        assert all(_same(g, w) for g, w in zip(_flat(got), _flat(want)))


def test_cuda_tensors_launch_kernels_never_plain_twins(cuda, monkeypatch):
    from ife_tpu_torch.kernels import (
        features8_post as post_mod, features8_sweep as sweep_mod,
        hessian_eig as he_mod, histogram as hist_mod, normalized_conv as nc_mod,
    )
    from ife_tpu_torch.ops.features import (
        features8_auto_channels, features8_dispatch_branch,
    )
    from ife_tpu_torch.stats import histogram_counts

    def refuse(*a, **k):
        raise AssertionError("plain twin called for a CUDA tensor")

    for mod, name in ((he_mod, "hessian_eig_plain"),
                      (post_mod, "features8_post_plain"),
                      (nc_mod, "normalized_conv_plain"),
                      (nc_mod, "smooth_yz_plain"),
                      (sweep_mod, "features8_sweep_plain"),
                      (sweep_mod, "features8_xs_stream_plain"),
                      (hist_mod, "histogram_plain"),
                      (hist_mod, "histogram_boxes_plain"),
                      (hist_mod, "_counts_plain")):
        monkeypatch.setattr(mod, name, refuse)
    img, mask = _inputs((13, 12, 11), cuda)
    sp = (0.78, 0.78, 1.0)
    assert [features8_dispatch_branch(s, sp, img.shape)
            for s in (1.2, 2.4, 4.8)] == ["sweep", "xs_stream", "nc_conv+post"]
    before = dict(K.LAUNCHES)
    for sigma in (1.2, 2.4, 4.8):
        features8_auto_channels(img, mask, sigma, sp)
    K.fused_hessian_eig(img, SPACING)
    histogram_counts(img, torch.linspace(-900.0, -100.0, 31, dtype=torch.float64))
    torch.cuda.synchronize()
    single = ("hessian_eig", "normalized_conv", "features8_post",
              "features8_sweep", "features8_xs_stream", "smooth_yz", "histogram")
    assert {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES} == {
        k: int(k in single) for k in K.LAUNCHES}


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int16,
                                   torch.bool])
def test_features8_on_card_takes_label_masks(cuda, dtype):
    # NIfTI masks arrive as any integer type; labels 2, 3, ... count as 1
    from ife_tpu_torch.ops.features import features8_auto_channels

    img, mask = _inputs((13, 12, 11), cuda)
    labels = mask.to(torch.uint8) * 3 if dtype != torch.bool else mask != 0
    got = features8_auto_channels(img, labels.to(dtype), 1.2, SPACING)
    want = features8_auto_channels(img, mask, 1.2, SPACING)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img, mask = _inputs((13, 12, 11), cuda)
    with pytest.raises(ValueError, match="float32"):
        K.fused_hessian_eig_stream(img.double())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_hessian_eig_stream(img.transpose(0, 2))
    with pytest.raises(ValueError, match="shape"):
        K.fused_features8_post_stream(img, mask[:-1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_normalized_conv_sweep(img, mask.cpu(), 1.0)
    with pytest.raises(ValueError, match="shape"):
        K.fused_features8_sweep(img, mask[:, :-1].contiguous(), 1.0)
    with pytest.raises(ValueError, match="float32"):
        K.fused_features8_xs_stream(img, img, mask.double(), 1.0)
    with pytest.raises(ValueError, match="sweep_fits"):
        K.fused_features8_sweep(img, mask, 1.0, (1.0, 0.01, 1.0))
    with pytest.raises(ValueError, match="sweep_fits"):  # rx 11: no instantiation
        K.fused_features8_sweep(img, mask, 1.8, (0.78, 0.78, 1.0))


# ---------------------------------------------------------------------------
# the multi-scale path: smooth_xz, features8_ys_multi, features8_sweep_multi,
# the windowed post kernel, the tiled normalized convolution
# ---------------------------------------------------------------------------

def _flat(groups):
    return [c for g in groups for c in g]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 2.4, 4.8])
def test_smooth_xz_kernel_matches_plain(cuda, shape, sigma):
    img, mask = _inputs(shape, cuda)
    num, den = K.fused_smooth_xz(img, mask, sigma, SPACING)
    pnum, pden = K.smooth_xz_plain(img, mask, sigma, SPACING)
    assert _same(num, pnum) and _same(den, pden)


# csrc/normalized_conv.cu's passes: radii on each axis (1 - 4 below a run
# of 8 outputs, 128 the largest), anisotropic radii; shapes thin, Z of 1,
# 2, 5, 127, 513, one voxel over a z chunk (1025) and past the 29056 that
# bounded the old z pass, one voxel over the x / y tile of 128
NC_RADII = [1, 2, 4, 11, 14, 22, 28, 64, 128]
NC_ANISO = [(28, 14, 22), (128, 1, 64), (2, 64, 11), (14, 28, 128)]
NC_SHAPES = [(7, 9, 1), (9, 7, 2), (6, 5, 5), (5, 6, 127), (3, 4, 513),
             (2, 3, 1025), (1, 2, 30001), (129, 3, 33), (3, 129, 33)]


def _radii_spacing(radii):
    """The spacing at which sigma 1 has these x / y / z radii."""
    return tuple(4.5 / (r - 0.5) for r in radii)


def _assert_nc_entries(img, m, sigma, sp):
    """The four entries on csrc/normalized_conv.cu equal their twins to the
    bit (NaN of 0/0 included), and the tiled entry the untiled kernel."""
    got = K.fused_normalized_conv_sweep(img, m, sigma, sp)
    assert _same(got, K.normalized_conv_plain(img, m, sigma, sp))
    for n_tiles in (1, 2, 3):
        assert _same(K.fused_normalized_conv_sweep_tiled(
            img, m, sigma, sp, n_tiles=n_tiles), got)
    for kern, plain in ((K.fused_smooth_yz, K.smooth_yz_plain),
                        (K.fused_smooth_xz, K.smooth_xz_plain)):
        num, den = kern(img, m, sigma, sp)
        pnum, pden = plain(img, m, sigma, sp)
        assert _same(num, pnum) and _same(den, pden), kern.__name__


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("r", NC_RADII)
def test_nc_kernels_match_plain_at_each_radius(cuda, axis, r):
    img, mask = _inputs((37, 35, 33), cuda)
    radii = tuple(r if a == axis else 2 for a in range(3))
    _assert_nc_entries(img, mask, 1.0, _radii_spacing(radii))


@pytest.mark.parametrize("radii", NC_ANISO + [None])
def test_nc_kernels_match_plain_anisotropic_and_sigma_0(cuda, radii):
    img, mask = _inputs((37, 35, 33), cuda)
    if radii is None:  # sigma 0: one tap on every axis
        _assert_nc_entries(img, mask, 0.0, SPACING)
    else:
        _assert_nc_entries(img, mask, 1.0, _radii_spacing(radii))


@pytest.mark.parametrize("shape", NC_SHAPES)
def test_nc_kernels_match_plain_on_thin_and_tile_edge_shapes(cuda, shape):
    img, mask = _inputs(shape, cuda)
    for sigma, sp in ((4.8, (0.78, 0.78, 1.0)), (0.6, (0.78, 0.78, 1.0)),
                      (1.0, _radii_spacing((128, 64, 11)))):
        _assert_nc_entries(img, mask, sigma, sp)


@pytest.mark.parametrize("kind", ["empty", "octant", "ones", "nan_inf"])
def test_nc_kernels_match_plain_under_each_mask(cuda, kind):
    """An empty mask (0/0 = NaN everywhere in nc), one octant, a mask of
    ones, and an image with NaN and +-inf where the sphere is 0."""
    img, mask = _inputs((40, 36, 33), cuda)
    if kind == "empty":
        mask = torch.zeros_like(mask)
    elif kind == "octant":
        mask = torch.zeros_like(mask)
        mask[:20, :18, :17] = 1.0
    elif kind == "ones":
        mask = torch.ones_like(mask)
    else:
        off = mask == 0
        vals = torch.tensor([float("nan"), float("inf"), -float("inf")],
                            device=cuda)
        img = img.clone()
        img[off] = vals.repeat(int(off.sum()) // 3 + 1)[:int(off.sum())]
    for sigma in (2.4, 4.8):
        _assert_nc_entries(img, mask, sigma, (0.78, 0.78, 1.0))


@pytest.mark.parametrize("shape", SHAPES + [(40, 9, 33)])
@pytest.mark.parametrize("sigmas", [(4.8,), (2.4, 4.8), (0.6, 2.4, 4.8),
                                    (9.0, 0.3)])
def test_ys_multi_kernel_matches_plain(cuda, shape, sigmas):
    # (40, 9, 33): every y radius but the smallest exceeds Y
    img, mask = _inputs(shape, cuda)
    pairs = [K.smooth_xz_plain(img, mask, s, SPACING) for s in sigmas]
    nums, dens = [p[0] for p in pairs], [p[1] for p in pairs]
    before = K.LAUNCHES["features8_ys_multi"]
    got = K.fused_features8_ys_multi(nums, dens, mask, sigmas, SPACING,
                                     stack=False)
    assert K.LAUNCHES["features8_ys_multi"] - before == 1
    want = K.features8_ys_multi_plain(nums, dens, mask, sigmas, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in _flat(got))
    assert all(_same(g, w) for g, w in zip(_flat(got), _flat(want)))
    stacked = K.fused_features8_ys_multi(nums, dens, mask, sigmas, SPACING)
    assert stacked.shape == (len(sigmas), 8) + tuple(shape)
    assert all(torch.equal(c, stacked[i, k])
               for i, g in enumerate(got) for k, c in enumerate(g))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigmas", [(1.2,), (0.6, 1.0), (0.3, 0.45, 0.6),
                                    (0.3, 0.25, 0.28, 0.2), (1.5,)])
def test_sweep_multi_kernel_matches_plain_and_the_single_sweep(cuda, shape,
                                                               sigmas):
    img, mask = _inputs(shape, cuda)
    labels = mask * 3.0  # the kernel clamps the mask itself
    assert K.sweep_multi_fits(sigmas, SPACING)
    before = K.LAUNCHES["features8_sweep_multi"]
    got = K.fused_features8_sweep_multi(img, labels, sigmas, SPACING,
                                        stack=False)
    assert K.LAUNCHES["features8_sweep_multi"] - before == 1
    want = K.features8_sweep_multi_plain(img, labels, sigmas, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in _flat(got))
    assert all(_same(g, w) for g, w in zip(_flat(got), _flat(want)))
    for g, s in zip(got, sigmas):
        one = K.fused_features8_sweep(img, labels, s, SPACING, stack=False)
        assert all(torch.equal(a, b) for a, b in zip(g, one))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [(8, 128), 1, (64, 8), (5, 7)])
def test_features8_post_windowed_kernel_matches_plain(cuda, shape, block):
    img, mask = _inputs(shape, cuda)
    s = K.normalized_conv_plain(img, mask, 1.2, SPACING)
    before = K.LAUNCHES["features8_post_windowed"]
    got = K.fused_features8_post(s, mask, SPACING, block=block, stack=False)
    assert K.LAUNCHES["features8_post_windowed"] - before == 1
    want = K.features8_post_plain(s, mask, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(_same(g, w) for g, w in zip(got, want))
    stream = K.fused_features8_post_stream(s, mask, SPACING, stack=False)
    assert all(torch.equal(g, w) for g, w in zip(got, stream))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [1.2, 4.8])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4])
def test_nc_tiled_kernel_equals_the_untiled_kernel(cuda, shape, sigma, n_tiles):
    img, mask = _inputs(shape, cuda)
    before = dict(K.LAUNCHES)
    got = K.fused_normalized_conv_sweep_tiled(img, mask, sigma, SPACING,
                                              n_tiles=n_tiles)
    assert K.LAUNCHES["normalized_conv_tiled"] - before[
        "normalized_conv_tiled"] == n_tiles
    assert K.LAUNCHES["normalized_conv"] == before["normalized_conv"]
    assert _same(got, K.fused_normalized_conv_sweep(img, mask, sigma, SPACING))
    assert _same(got, K.normalized_conv_tiled_plain(img, mask, sigma, SPACING,
                                                    n_tiles=n_tiles))


def test_multiscale_path_launches_kernels_never_plain_twins(cuda, monkeypatch):
    from ife_tpu_torch.kernels import (
        features8_post as post_mod, features8_sweep as sweep_mod,
        features8_ys_multi as ys_mod, normalized_conv as nc_mod,
    )
    from ife_tpu_torch.ops.features import (
        features8_auto_channels, multiscale_features8_fused,
    )

    def refuse(*a, **k):
        raise AssertionError("plain twin called for a CUDA tensor")

    for mod, name in ((post_mod, "features8_post_plain"),
                      (nc_mod, "normalized_conv_plain"),
                      (nc_mod, "normalized_conv_tiled_plain"),
                      (nc_mod, "smooth_xz_plain"),
                      (sweep_mod, "features8_sweep_plain"),
                      (sweep_mod, "features8_sweep_multi_plain"),
                      (ys_mod, "features8_ys_multi_plain"),
                      (ys_mod, "features8_post_plain")):
        monkeypatch.setattr(mod, name, refuse)
    img, mask = _inputs((40, 36, 33), cuda)
    sp = (0.78, 0.78, 1.0)
    before = dict(K.LAUNCHES)
    got = multiscale_features8_fused(img, mask.to(torch.uint8) * 2, (2.4, 4.8),
                                     sp, stack=False)
    K.fused_features8_sweep_multi(img, mask, (0.6, 1.2), sp)
    K.fused_features8_post(
        K.fused_normalized_conv_sweep_tiled(img, mask, 4.8, sp, n_tiles=3),
        mask, sp)
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES} == {
        **dict.fromkeys(K.LAUNCHES, 0), "smooth_xz": 2, "features8_ys_multi": 1,
        "features8_sweep_multi": 1, "normalized_conv_tiled": 3,
        "features8_post_windowed": 1}
    # each scale within the f32 budget of the per-scale pass (another order
    # of the three passes: x, z, y against y, z, x or x, y, z)
    for g, s in zip(got, (2.4, 4.8)):
        one = features8_auto_channels(img, mask, s, sp)
        assert _rel(g[0], one[0]) < 1e-5
        assert _feature_err(g, one, (2, 3, 4)) < 5e-3


def test_multiscale_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img, mask = _inputs((13, 12, 11), cuda)
    with pytest.raises(ValueError, match="float32"):
        K.fused_smooth_xz(img.double(), mask.double(), 1.0)
    with pytest.raises(ValueError, match="shape"):
        K.fused_features8_ys_multi([img], [img[:-1].contiguous()], mask, (1.0,))
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_features8_ys_multi([img.transpose(0, 2)], [img], mask, (1.0,))
    with pytest.raises(ValueError, match="scales"):
        K.fused_features8_ys_multi([img] * 9, [img] * 9, mask, (1.0,) * 9)
    with pytest.raises(ValueError, match="radius"):
        K.fused_features8_ys_multi([img], [img], mask, (1.0,), (1.0, 0.01, 1.0))
    with pytest.raises(ValueError, match="sweep_multi_fits"):
        K.fused_features8_sweep_multi(img, mask, (2.4, 4.8), (0.78, 0.78, 1.0))
    # the register budget: three scales with an x radius of 7, two with 10
    with pytest.raises(ValueError, match="sweep_multi_fits"):
        K.fused_features8_sweep_multi(img, mask, (0.6, 0.9, 1.2),
                                      (0.78, 0.78, 1.0))
    with pytest.raises(ValueError, match="sweep_multi_fits"):
        K.fused_features8_sweep_multi(img, mask, (0.6, 1.7), (0.78, 0.78, 1.0))
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_features8_sweep_multi(img, mask.cpu(), (1.0,))
    with pytest.raises(ValueError, match="clamps"):
        K.fused_features8_sweep_multi(img, mask, (1.0,), clamps=[0, 12, 0])
    with pytest.raises(ValueError, match="host integers"):
        K.fused_features8_sweep(img, mask, 1.0,
                                clamps=torch.tensor([0, 12, 0, 11], device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        K.fused_features8_post(img, mask, pre_padded=True)  # m is not the core's
    with pytest.raises(ValueError, match="mutually exclusive"):
        K.fused_features8_post_stream(img, mask, pre_padded=True,
                                      x_halo=(img[:1], img[:1]))
    with pytest.raises(ValueError, match="shape"):
        K.fused_features8_post(img, mask[:, :-1].contiguous())
    with pytest.raises(ValueError, match="float32"):
        K.fused_normalized_conv_sweep_tiled(img, mask.double(), 1.0)


# ---------------------------------------------------------------------------
# the histogram kernel (csrc/histogram.cu): counts equal to the twin's,
# exactly (integer atomics do not depend on their order)
# ---------------------------------------------------------------------------

def _hist_values(rng, n, edges, dev):
    v = rng.standard_normal(n).astype(np.float32)
    plant = np.concatenate([[np.nan, np.inf, -np.inf],
                            np.asarray(edges, np.float32).ravel()])[:n]
    v[: plant.size] = plant
    return torch.from_numpy(v).to(dev)


def _hist_edges(rng, C, E):
    """(C, E) sorted f64 edges with a run of duplicates, +-inf at the ends."""
    e = np.sort(rng.standard_normal((C, E)), axis=1)
    if E >= 6:
        e[:, 2:6] = e[:, 2:3]
        e[:, 0], e[:, -1] = -np.inf, np.inf
    return torch.from_numpy(e)


def _hist_weights(rng, kind, shape, dev):
    if kind is None:
        return None
    w = rng.integers(0, 3, shape)
    dtype = {"uint8": torch.uint8, "int32": torch.int32, "bool": torch.bool,
             "float": torch.float32}[kind]
    return torch.from_numpy(w).to(dtype).to(dev)


@pytest.mark.parametrize("E", [0, 1, 31, 200, 4096])
@pytest.mark.parametrize("weights", [None, "uint8", "int32", "bool", "float"])
def test_histogram_multi_kernel_matches_plain(cuda, E, weights):
    rng = np.random.default_rng(E + 7)
    n = 100_003  # not a multiple of a block or a warp
    edges = _hist_edges(rng, 3, E)
    chans = [_hist_values(rng, n, edges, cuda) for _ in range(3)]
    w = _hist_weights(rng, weights, n, cuda)
    for e in (edges, edges[0]):  # per-channel and shared edges
        got = K.histogram_counts_multi(chans, e, w)
        assert got.dtype == torch.int32 and got.shape == (3, E + 1)
        assert torch.equal(got, K.histogram_counts_multi_plain(chans, e, w))
    one = K.histogram_counts_kernel(chans[0], edges[0], w)
    assert torch.equal(one, K.histogram_counts_multi_plain(chans[:1], edges[0], w)[0])
    assert torch.equal(K.histogram_counts_multi([c[:0] for c in chans], edges),
                       torch.zeros((3, E + 1), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("C,E", [(64, 4096), (70, 31)])
def test_histogram_kernel_global_path_and_channel_groups(cuda, C, E):
    # 64 x 4097 bins exceed a block's shared memory: the kernel counts in
    # global memory; 70 channels run as two launches of <= 64 channels
    from ife_tpu_torch.kernels.histogram import _plan

    rng = np.random.default_rng(C)
    n = 20_011
    edges = _hist_edges(rng, C, E)
    chans = [_hist_values(rng, n, edges[c], cuda) for c in range(C)]
    w = _hist_weights(rng, "uint8", n, cuda)
    assert (_plan(C, E, n).copies == 0) == (E == 4096)
    before = K.LAUNCHES["histogram"]
    got = K.histogram_counts_multi(chans, edges, w)
    assert K.LAUNCHES["histogram"] - before == -(-C // 64)
    assert torch.equal(got, K.histogram_counts_multi_plain(chans, edges, w))


@pytest.mark.parametrize("E", [1, 31, 4096])
@pytest.mark.parametrize("weights", ["uint8", None])
def test_histogram_boxes_kernel_matches_plain(cuda, E, weights):
    from ife_tpu_torch.kernels.histogram import _edges_f32_round_down

    rng = np.random.default_rng(E)
    shape, size = (40, 37, 33), (11, 9, 13)
    edges = _hist_edges(rng, 8, E)
    chans = [_hist_values(rng, int(np.prod(shape)), edges[c], cuda).reshape(shape)
             for c in range(8)]
    w = _hist_weights(rng, weights, shape, cuda)
    if w is not None:
        w[29:, 28:, 20:] = 0  # the last box holds no weight
    starts = np.concatenate([rng.integers(0, 20, (40, 3)), [[29, 28, 20]]])
    got = K.histogram_boxes(chans, w, starts, size, edges)
    want = K.histogram_boxes_plain(chans, w, starts, size,
                                   _edges_f32_round_down(edges.to(cuda)))
    assert got.shape == (41, 8, E + 1)
    assert torch.equal(got, want)
    if w is not None:
        assert int(got[-1].sum()) == 0


def test_histogram_kernel_512_cubed_eight_channels(cuda):
    # the config-4 shape: 8 f32 channels at 512^3, 31 shared edges, mask
    # weights
    g = torch.Generator(device=cuda).manual_seed(0)
    shape = (512, 512, 512)
    chans = [torch.randn(shape, device=cuda, generator=g) * 300.0 - 600.0
             for _ in range(8)]
    chans[0][0, 0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    w = (torch.rand(shape, device=cuda, generator=g) > 0.25).to(torch.uint8)
    edges = torch.linspace(-1200.0, 600.0, 31, dtype=torch.float64)
    got = K.histogram_counts_multi(chans, edges, w)
    assert torch.equal(got, K.histogram_counts_multi_plain(chans, edges, w))
    assert int(got[0].sum()) == int(w.sum())


HIST_CASES = ["constant field", "E = 1", "8 x 4096 edges", "odd offset",
              "NaN values", "int32 weights", "empty mask",
              "runs empty and full", "conflict-free"]


def _hist_case(case, dev):
    """(channels, edges, weights) of one design case of the kernel."""
    g = torch.Generator(device=dev).manual_seed(HIST_CASES.index(case))
    n = 100_003  # n % 4 == 3
    base = torch.randn(8 * n + 1, device=dev, generator=g) * 300.0 - 600.0
    views = [base[1 + c * n: 1 + (c + 1) * n] for c in range(8)]  # odd offsets
    e31 = torch.linspace(-1200.0, 600.0, 31, dtype=torch.float64)
    ones = torch.ones(n, dtype=torch.uint8, device=dev)
    runs = torch.arange(n, device=dev) // 32
    patchy = ((runs % 3 == 0) | ((runs % 3 == 1)
                                 & (torch.rand(n, device=dev, generator=g) > 0.5)))
    if case == "constant field":
        return [torch.full((n,), 0.5, device=dev)] * 8, e31, ones
    if case == "E = 1":
        return views, torch.tensor([-600.0], dtype=torch.float64), patchy
    if case == "8 x 4096 edges":
        return views, torch.linspace(-1500.0, 300.0, 4096,
                                     dtype=torch.float64), ones
    if case == "odd offset":
        return views, e31, patchy.to(torch.uint8)
    if case == "NaN values":
        views[3] = views[3].clone()
        views[3][::5] = float("nan")
        return views, e31, None
    if case == "int32 weights":
        return views, e31, torch.randint(0, 1000, (n,), dtype=torch.int32,
                                         device=dev, generator=g)
    if case == "empty mask":
        return views, e31, torch.zeros_like(ones)
    if case == "runs empty and full":
        return views, e31, (runs % 2 == 0).to(torch.uint8)
    # conflict-free: every voxel of a run of 32 in its own bin
    e = e31.to(dev, torch.float32)
    mids = torch.cat([e[:1] - 10.0, (e[:-1] + e[1:]) / 2, e[-1:] + 10.0])
    t = torch.arange(n, device=dev)
    key = torch.randint(0, 32, (n // 32 + 1,), device=dev, generator=g)
    return [mids[(t % 32) ^ key[t // 32]]] * 8, e31, ones


@pytest.mark.parametrize("case", HIST_CASES)
def test_histogram_kernel_design_cases(cuda, case):
    # the cases the kernel's design must get right: its loads, its skipped
    # runs and its warp-aggregated adds; counts equal the twin's exactly
    from ife_tpu_torch.kernels.histogram import _plan

    chans, edges, w = _hist_case(case, cuda)
    before = K.LAUNCHES["histogram"]
    got = K.histogram_counts_multi(chans, edges, w)
    assert K.LAUNCHES["histogram"] - before == 1
    assert torch.equal(got, K.histogram_counts_multi_plain(chans, edges, w))
    if case == "empty mask":
        assert int(got.sum()) == 0
    if case == "constant field":
        assert int(got[0].max()) == len(chans[0])
    if case == "8 x 4096 edges":  # the bins alone in shared memory
        assert _plan(8, 4096, len(chans[0]))[:2] == (False, 1)


@pytest.mark.parametrize("size", [(17, 15, 13), (3, 5, 33), (1, 1, 43),
                                  (11, 9, 41)])
@pytest.mark.parametrize("weights", [None, "uint8", "int32"])
def test_histogram_boxes_at_odd_starts(cuda, size, weights):
    # rows shorter and longer than a warp, starts at odd corners
    from ife_tpu_torch.kernels.histogram import _edges_f32_round_down

    rng = np.random.default_rng(sum(size))
    shape = (37, 29, 43)
    edges = _hist_edges(rng, 8, 31)
    chans = [_hist_values(rng, int(np.prod(shape)), edges[c], cuda).reshape(shape)
             for c in range(8)]
    w = _hist_weights(rng, weights, shape, cuda)
    starts = [(1, 3, 5), (7, 1, 0), (36 - size[0], 28 - size[1], 43 - size[2]),
              (5, 11, 1)]
    got = K.histogram_boxes(chans, w, starts, size, edges)
    assert torch.equal(got, K.histogram_boxes_plain(
        chans, w, starts, size, _edges_f32_round_down(edges)))


def test_histogram_wrappers_reject_what_the_kernel_does_not_take(cuda):
    from ife_tpu_torch.stats import histogram_counts

    v = torch.zeros((4, 4, 4), device=cuda)
    e = torch.tensor([0.0, 1.0])
    with pytest.raises(ValueError, match="float32"):
        histogram_counts(v.double(), e)
    with pytest.raises(ValueError, match="float32"):
        K.histogram_boxes([v.double()], None, [[0, 0, 0]], (2, 2, 2), e[None])
    with pytest.raises(ValueError, match="CUDA"):
        K.histogram_boxes([v, v.cpu()], None, [[0, 0, 0]], (2, 2, 2),
                          torch.stack([e, e]))
    with pytest.raises(ValueError, match="non-decreasing"):
        K.histogram_counts_multi([v], torch.tensor([1.0, 0.0]))
    with pytest.raises(ValueError, match="host"):  # checked before they move
        K.histogram_counts_multi([v], e.to(cuda))


# ---------------------------------------------------------------------------
# the windowed kernels, the shard modes and the sharded path
# ---------------------------------------------------------------------------

def _stacked(chans):
    return chans if isinstance(chans, torch.Tensor) else torch.stack(list(chans))


# the direct entries' tiles (csrc/features8_tap.cu): the tap sweeps y over
# (x, z) tiles of 14 x 32 in chunks of >= 128 rows, xs takes (y, z) tiles of
# 14 x 32 and 16 planes of x; shapes thin, prime, and one voxel over a tile
# or a chunk on each axis
TAP_XS_SHAPES = SHAPES + [(5, 40, 33), (40, 9, 33), (15, 129, 33),
                          (17, 15, 33), (29, 31, 97)]
UNIT = (1.0, 1.0, 1.0)
# (sigma, spacing): sigma 0.6 and 1.2 at SPACING (rx != ry != rz); equal
# radii 1, 8, 11 (the last with the tap's ring in shared memory), 12 (in
# global scratch) and 29 at unit spacing; radii 2 / 25 / 2 (a ring in global
# scratch beside small x and z radii)
TAP_XS_SCALES = [(0.6, SPACING), (1.2, SPACING), (1 / 4.5, UNIT),
                 (8 / 4.5, UNIT), (11 / 4.5, UNIT), (12 / 4.5, UNIT),
                 (29 / 4.5, UNIT), (1.1, (4.0, 0.2, 4.0))]


def _region_mask(kind, shape, dev):
    """The sphere (times 2: the kernels clamp it), or a mask that leaves
    everything, all but one octant, or nothing empty: the kernels skip rows
    (tap) and blocks (xs) with no voxel inside and store zeros there."""
    if kind == "sphere":
        return _inputs(shape, dev)[1] * 2.0
    m = torch.zeros(shape, device=dev)
    if kind == "one octant":
        m[: (shape[0] + 1) // 2, : (shape[1] + 1) // 2, : (shape[2] + 1) // 2] = 1.0
    elif kind == "full":
        m += 1.0
    return m


@pytest.mark.parametrize("shape", TAP_XS_SHAPES)
@pytest.mark.parametrize("sigma,spacing", TAP_XS_SCALES)
@pytest.mark.parametrize("mask_kind", ["sphere", "empty", "one octant", "full"])
def test_tap_and_xs_equal_their_twins(cuda, shape, sigma, spacing, mask_kind):
    img = _inputs(shape, cuda)[0]
    labels = _region_mask(mask_kind, shape, cuda)
    assert _same(K.fused_features8_tap(img, labels, sigma, spacing),
                 _stacked(K.features8_tap_plain(img, labels, sigma, spacing)))
    assert _same(K.fused_features8_xs(img, labels, sigma, spacing),
                 _stacked(K.features8_xs_plain(img, labels, sigma, spacing)))
    # xs runs the sweep's passes in the sweep's order
    if K.sweep_fits(sigma, spacing):
        assert _same(K.fused_features8_xs(img, labels, sigma, spacing),
                     K.fused_features8_sweep(img, labels, sigma, spacing))


def test_tap_and_xs_raise_beyond_their_windows(cuda):
    img, mask = _inputs((13, 12, 11), cuda)
    with pytest.raises(ValueError, match="tap_fits"):
        K.fused_features8_tap(img, mask, 10.0)      # r = 45 > 44
    with pytest.raises(ValueError, match="xs_fits"):
        K.fused_features8_xs(img, mask, 29.0)       # rx = 131 > 128
    assert K.fused_features8_tap(img, mask, 44 / 4.5).shape == (8, 13, 12, 11)
    assert K.fused_features8_xs(img, mask, 7.0).shape == (8, 13, 12, 11)
    assert K.fused_features8_xs(img, mask, 4.8, (0.78, 0.78, 1.0)).shape == (8, 13, 12, 11)


# ---------------------------------------------------------------------------
# the roofline probes (kernels/probes.py) and the copy-floor variants
# ---------------------------------------------------------------------------

# (128, 124, 120) and extents that are no multiple of a warp, a block or 4:
# 5 * 7 * 9 = 315 voxels leave a float4 tail of 3
PROBE_SHAPES = [(128, 124, 120), (13, 12, 11), (5, 7, 9)]


def _bits(got, ref):
    """Bit for bit, the sign of a zero included."""
    return all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(got, ref))


def _with_signed_zeros(img):
    x = img.clone()
    x.view(-1)[::97] = -0.0
    return x


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("width", [1, 4])
def test_scaled_copy_probes_equal_their_twins(cuda, shape, width):
    from ife_tpu_torch.kernels import probes as P

    x = _with_signed_zeros(_inputs(shape, cuda)[0])
    before = dict(K.LAUNCHES)
    assert _bits(P.trivial6(x, width), P.trivial6_plain(x))
    assert _bits([P.pcopy1(x, width)], [P.pcopy1_plain(x)])
    torch.cuda.synchronize()
    assert K.LAUNCHES["trivial6"] - before["trivial6"] == 1
    assert K.LAUNCHES["pcopy1"] - before["pcopy1"] == 1


@pytest.mark.parametrize("shape", PROBE_SHAPES + HESSIAN_EDGE_SHAPES)
@pytest.mark.parametrize("mode", ["copyfloor", "copy6", "stencil6"])
def test_hessian_probe_outputs_equal_their_twins(cuda, shape, mode):
    from ife_tpu_torch.kernels import probes as P

    x = _with_signed_zeros(_inputs(shape, cuda)[0])
    before = dict(K.LAUNCHES)
    if mode == "copyfloor":
        got = P.floor_window(x)
        assert _bits(K.fused_hessian_eig(x, SPACING, variant="copyfloor"),
                     torch.stack(K.hessian_eig_copyfloor_plain(x)))
        want, launches = P.floor_window_plain(x), 2
    else:
        got = P.variant(x, mode, SPACING)
        want, launches = P.variant_plain(x, mode, SPACING), 1
    assert _bits(got, want)
    torch.cuda.synchronize()
    name = f"hessian_eig_{mode}"
    assert {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES} == {
        k: launches if k == name else 0 for k in K.LAUNCHES}


HESSIAN_CALLS = {
    "features": (lambda x, h, p: K.fused_hessian_eig_stream(x, SPACING),
                 lambda x, h, p: K.hessian_eig_plain(x, SPACING)),
    "x_halo": (lambda x, h, p: K.fused_hessian_eig_stream(x, SPACING, x_halo=h),
               lambda x, h, p: K.hessian_eig_plain(x, SPACING, x_halo=h)),
    "pre_padded": (
        lambda x, h, p: K.fused_hessian_eig(p, SPACING, pre_padded=True),
        lambda x, h, p: K.hessian_eig_plain(p, SPACING, pre_padded=True)),
    "copyfloor": (
        lambda x, h, p: K.fused_hessian_eig(x, SPACING, variant="copyfloor"),
        lambda x, h, p: K.hessian_eig_copyfloor_plain(x)),
    "reference": (
        lambda x, h, p: K.hessian_eig_reference_features(x, SPACING),
        lambda x, h, p: K.hessian_eig_reference_plain(x, SPACING)),
}


@pytest.mark.parametrize("shape", SHAPES + THIN + PROBE_SHAPES
                         + HESSIAN_EDGE_SHAPES + [(1, 5, 9), (1, 1, 1)])
@pytest.mark.parametrize("call", sorted(HESSIAN_CALLS))
def test_hessian_kernel_in_every_mode_and_output_equals_its_twin(cuda, shape,
                                                                 call):
    # x_halo with X = 1 (both neighbour rows from lo / hi) and pre_padded on
    # a 1 x 1 core among them; signed zeros in the input
    x = _with_signed_zeros(_inputs(shape, cuda)[0])
    halo, pad = _halo_and_layer(x)
    kern, twin = HESSIAN_CALLS[call]
    assert _bits(_stacked(kern(x, halo, pad)), _stacked(twin(x, halo, pad)))


def _tie_volumes(dev):
    """i^2 - j^2 (Hessian diag(2, -2, 0): |e1| = |e2| at every voxel) and
    random small integers (diagonal and tied Hessians), f32."""
    i, j, _ = torch.meshgrid(*(torch.arange(n, dtype=torch.float32)
                               for n in (12, 11, 10)), indexing="ij")
    g = torch.Generator().manual_seed(11)
    ints = torch.randint(-3, 4, (19, 17, 24), generator=g).float()
    return (i * i - j * j).to(dev), ints.to(dev)


def test_hessian_features_route_gives_the_reference_at_ties(cuda):
    # hessian_eig_features_channels (the hessian-features CLI without
    # --fused) is ife_tpu's hessian_eig_features: the reference's eigen path,
    # which orders tied eigenvalues by its diagonal branch; the Pallas
    # kernel's polynomial path (fused_hessian_eig_stream) swaps e1 and e2
    from ife_tpu_torch.ops.features import hessian_eig_features_channels

    square, ints = _tie_volumes(cuda)
    for vol in (square, ints):
        before = dict(K.LAUNCHES)
        got = hessian_eig_features_channels(vol, (1.0, 1.0, 1.0))
        assert {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES} == {
            k: int(k == "hessian_eig_reference") for k in K.LAUNCHES}
        assert _bits(got, K.hessian_eig_reference_plain(vol))
    got = hessian_eig_features_channels(square)
    assert [float(c[5, 5, 5]) for c in got[:3]] == [-2.0, 2.0, 0.0]
    poly = K.fused_hessian_eig_stream(square, stack=False)
    assert float(poly[0][5, 5, 5]) > 0 > float(poly[1][5, 5, 5])


@pytest.mark.parametrize("shape", TAP_XS_SHAPES + [(128, 124, 120)])
@pytest.mark.parametrize("sigma,spacing", TAP_XS_SCALES)
@pytest.mark.parametrize("mask_kind", ["sphere", "empty", "one octant", "full"])
def test_tap_copyfloor_equals_its_twin(cuda, shape, sigma, spacing, mask_kind):
    img = _inputs(shape, cuda)[0]
    labels = _region_mask(mask_kind, shape, cuda) - 0.5  # clamped to [0, 1]
    before = K.LAUNCHES["features8_tap_copyfloor"]
    got = K.fused_features8_tap(img, labels, sigma, spacing, stack=False,
                                variant="copyfloor")
    assert _bits(got, K.features8_tap_copyfloor_plain(img, labels))
    assert K.LAUNCHES["features8_tap_copyfloor"] - before == 1


def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from ife_tpu_torch.kernels import probes as P

    img, _ = _inputs((13, 12, 11), cuda)
    offset = torch.empty(img.numel() + 1, device=cuda)[1:].view(img.shape)
    offset.copy_(img)
    with pytest.raises(ValueError, match="aligned"):
        P.trivial6(offset)
    assert _bits(P.trivial6(offset, width=1), P.trivial6_plain(offset))
    with pytest.raises(ValueError, match="float32"):
        P.pcopy1(img.double())
    with pytest.raises(ValueError, match="contiguous"):
        P.variant(img.transpose(0, 2), "stencil6")
    with pytest.raises(ValueError, match="whole volume"):
        K.fused_hessian_eig(img, variant="copyfloor", pre_padded=True)
    with pytest.raises(ValueError, match="tap_fits"):
        K.fused_features8_tap(img, img, 10.0, variant="copyfloor")  # r = 45


@pytest.mark.parametrize("shape", SHAPES + [(5, 40, 33)])
def test_shard_modes_equal_their_twins(cuda, shape):
    img, mask = _inputs(shape, cuda)
    X, Y, _ = shape
    before = dict(K.LAUNCHES)
    cl = [2, K.NO_FACE, -K.NO_FACE, Y - 3]
    assert _same(K.fused_features8_sweep(img, mask, 1.0, SPACING, clamps=cl),
                 _stacked(K.features8_sweep_plain(img, mask, 1.0, SPACING,
                                                  clamps=cl)))
    got = K.fused_features8_sweep_multi(img, mask, (0.6, 1.0), SPACING, clamps=cl)
    want = K.features8_sweep_multi_plain(img, mask, (0.6, 1.0), SPACING, clamps=cl)
    assert _same(got, torch.stack([_stacked(w) for w in want]))
    whole = [0, X - 1, 0, Y - 1]
    assert _same(K.fused_features8_sweep(img, mask, 1.0, SPACING, clamps=whole),
                 K.fused_features8_sweep(img, mask, 1.0, SPACING))
    s = torch.nan_to_num(K.fused_normalized_conv_sweep(img, mask, 1.0, SPACING))
    core, mc = s[1:-1].contiguous(), mask[1:-1].contiguous()
    halo = (s[:1].contiguous(), s[-1:].contiguous())
    got = K.fused_features8_post_stream(core, mc, SPACING, x_halo=halo)
    assert _same(got, _stacked(K.features8_post_plain(core, mc, SPACING,
                                                      x_halo=halo)))
    assert _same(got, K.fused_features8_post_stream(s, mask, SPACING)[:, 1:-1])
    mcc = mask[1:-1, 1:-1].contiguous()
    want = _stacked(K.features8_post_plain(s, mcc, SPACING, pre_padded=True))
    assert _same(K.fused_features8_post_stream(s, mcc, SPACING, pre_padded=True),
                 want)
    assert _same(K.fused_features8_post(s, mcc, SPACING, pre_padded=True), want)
    ih = (img[:1].contiguous(), img[-1:].contiguous())
    ic = img[1:-1].contiguous()
    assert _same(K.fused_hessian_eig_stream(ic, SPACING, x_halo=ih),
                 _stacked(K.hessian_eig_plain(ic, SPACING, x_halo=ih)))
    assert _same(K.fused_hessian_eig(img, SPACING, pre_padded=True),
                 K.fused_hessian_eig(img, SPACING)[:, 1:-1, 1:-1])
    # x_halo on one plane (rows -1 and 1 both from the halo), pre_padded on a
    # 1 x 1 core (every neighbour row from the layer)
    one = img[1:2].contiguous()
    assert _same(K.fused_hessian_eig_stream(one, SPACING, x_halo=ih),
                 _stacked(K.hessian_eig_plain(one, SPACING, x_halo=ih)))
    block = img[:3, :3].contiguous()
    assert _same(K.fused_hessian_eig(block, SPACING, pre_padded=True),
                 _stacked(K.hessian_eig_plain(block, SPACING, pre_padded=True)))
    for name in ("features8_sweep_clamps", "features8_sweep_multi_clamps",
                 "features8_post_x_halo", "features8_post_pre_padded",
                 "features8_post_windowed_pre_padded", "hessian_eig_x_halo",
                 "hessian_eig_pre_padded"):
        assert K.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("axes", [("x",), ("x", "y")])
def test_sharded_path_equals_the_single_device_kernels(cuda, axes):
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.ops.features import (
        features8_dispatch_branch, fused_features8,
    )

    img, mask = _inputs((48, 40, 33), cuda)
    mesh = P.make_mesh(4, axes, device=cuda)
    xi, mi = P.shard_volume(img, mesh), P.shard_volume(mask, mesh)
    post = "features8_post_x_halo" if axes == ("x",) else "features8_post_pre_padded"
    for sigma in (0.6, 1.2, 4.8):
        K.reset_launches()
        got = P.gather_volume(P.sharded_features8(xi, mi, sigma, mesh)).movedim(-1, 0)
        counts = {k: v for k, v in K.LAUNCHES.items() if v}
        if features8_dispatch_branch(sigma, (1, 1, 1), None) == "sweep":
            assert counts == {"features8_sweep_clamps": 4}
            branch = "sweep"
        else:
            assert counts == {"normalized_conv": 4, post: 4}
            branch = "nc_conv+post"
        # the sharded route takes the staged pair wherever the sweep does not
        # serve the scale; the single-device dispatcher may take xs_stream
        # there (sigma 4.8 at 1 mm: rx 22), so it is held to that branch
        assert _same(got, fused_features8(img, mask, sigma, branch=branch))
    K.reset_launches()
    got = P.gather_volume(P.sharded_hessian_eig(xi, mesh, SPACING)).movedim(-1, 0)
    assert K.LAUNCHES["hessian_eig_x_halo" if axes == ("x",)
                      else "hessian_eig_pre_padded"] == 4
    assert _same(got, K.fused_hessian_eig(img, SPACING))
    edges = torch.linspace(-900, -100, 7, dtype=torch.float64)
    from ife_tpu_torch.stats.histogram import histogram_counts

    assert torch.equal(
        P.sharded_masked_histogram(xi, mi, edges, mesh),
        histogram_counts(img, edges, (mask != 0).to(torch.int32)))


# ---------------------------------------------------------------------------
# ops/transform.py: the entry points that ife_tpu ran on its device, on the
# card against the same functions on the CPU (the CPU tests hold the CPU to
# ife_tpu): bit for bit, order-1 resampling within 1 f32 ulp
# ---------------------------------------------------------------------------

def _f32_ulps(got, want):
    """Largest distance in f32 ulps of two f32 tensors."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(got.cpu()) - ordered(want.cpu())).abs().max())


def _transform_image(dtype=np.float32, shape=(40, 36, 33)):
    rng = np.random.default_rng(9)
    if dtype == np.int16:
        return rng.integers(-1024, 1500, shape).astype(np.int16)
    return (rng.standard_normal(shape) * 400.0 - 500.0).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_mask_image_on_the_card_equals_the_cpu(cuda, dtype):
    from ife_tpu_torch.ops import transform as T

    img = _transform_image(dtype)
    mask = np.random.default_rng(2).integers(0, 3, img.shape).astype(np.uint8)
    got = T.mask_image(img, mask, -1024.7, device=cuda)
    assert got.is_cuda and got.dtype == torch.from_numpy(img).dtype
    assert torch.equal(got.cpu(), T.mask_image(img, mask, -1024.7, device="cpu"))


def test_relabel_mask_on_the_card_equals_the_cpu(cuda):
    from ife_tpu_torch.ops import transform as T

    mask = np.random.default_rng(3).integers(0, 6, (40, 36, 33)).astype(np.uint8)
    for include in ([1, 3], [2, 300]):
        got = T.relabel_mask(mask, include, 5, 2, device=cuda)
        assert got.is_cuda and got.dtype == torch.uint8
        assert torch.equal(got.cpu(),
                           T.relabel_mask(mask, include, 5, 2, device="cpu"))


def test_intensity_window_on_the_card_equals_the_cpu(cuda):
    from ife_tpu_torch.ops import transform as T

    img = _transform_image()
    img.reshape(-1)[:256] = -1250.0 + (np.arange(256) + 0.5) * 1500.0 / 255.0
    got = T.intensity_window(img, -500.0, 1500.0, device=cuda)
    assert got.is_cuda and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), T.intensity_window(img, device="cpu"))


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("spacing,out", [((1.0, 1.0), 0.5), ((0.78, 0.9), 0.25)])
def test_resample_to_spacing_2d_on_the_card_equals_the_cpu(cuda, order,
                                                           spacing, out):
    from ife_tpu_torch.ops import transform as T

    img = _transform_image()[..., 0]
    got = T.resample_to_spacing_2d(img, spacing, out, order=order, device=cuda)
    want = T.resample_to_spacing_2d(img, spacing, out, order=order, device="cpu")
    assert got.is_cuda and got.dtype == want.dtype == torch.float32
    if order == 1:
        assert _f32_ulps(got, want) <= 1
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_resample_to_grid_on_the_card_equals_the_cpu(cuda, order, dtype):
    # the grid reaches -0.5, beyond -1 and past the far face on every axis,
    # with ties at k + 0.5 on x
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.ops import transform as T

    src = Volume.from_numpy(_transform_image(dtype), spacing=(1.0, 0.78, 2.0),
                            origin=(0.0, 10.0, -4.0))
    tgt = Volume.from_numpy(np.zeros((90, 52, 40), np.float32),
                            spacing=(0.5, 0.7, 1.9), origin=(-2.0, 9.5, -7.0))
    got = T.resample_to_grid(src, tgt, order, -1024.25, device=cuda)
    want = T.resample_to_grid(src, tgt, order, -1024.25, device="cpu")
    assert got.data.is_cuda and got.origin == want.origin
    if order == 1:
        assert _f32_ulps(got.data, want.data) <= 1
    else:
        assert torch.equal(got.data.cpu(), want.data)


def test_converted_dicom_series_go_through_the_card(cuda, tmp_path):
    # the core of chip_smoke's dicom phase at a small size: three series
    # (raw, fragmented JPEG Lossless, JPEG-LS) through convert-dicom, every
    # compressed frame decoded natively, then the card's features8 pass on
    # a converted volume, equal to its plain twin and to the pass on the
    # series' own volume
    import chip_smoke as C
    from ife_tpu_torch import native_lib
    from ife_tpu_torch.io import read_volume
    from ife_tpu_torch.io.dicom import convert_dicom_dir
    from ife_tpu_torch.ops.features import (features8_auto_channels,
                                            features8_dispatch_branch)

    shape = (40, 36, 12)
    stored, _, _ = C.write_dicom_dir(str(tmp_path / "dcm"), shape, 3)
    native_lib.reset_counts()
    written = convert_dicom_dir(str(tmp_path / "dcm"), str(tmp_path / "nii"))
    assert native_lib.CALLS["jll_decode"] == native_lib.CALLS["jls_decode"] == 12
    assert native_lib.FALLBACKS == {"jll_decode": 0, "jls_decode": 0}
    want = C.dicom_expected_volume(stored, shape[2])
    assert sorted(written) == sorted(
        str(tmp_path / "nii" / C.dicom_file_name(p)) for p, _ in C.DICOM_SERIES)
    vols = [read_volume(p) for p in written]
    assert all(np.array_equal(v.numpy(), want) for v in vols)
    vol = vols[-1]
    img = vol.data.to(cuda).contiguous()
    mask = sphere_mask(vol.shape, 0.4, dtype=torch.float32, device=cuda).data
    K.reset_launches()
    got = features8_auto_channels(img, mask, 1.2, vol.spacing)
    branch = features8_dispatch_branch(1.2, vol.spacing, vol.shape)
    assert all(K.LAUNCHES[k] >= 1 for k in C.BRANCH_KERNELS[branch])
    twin = C.branch_twin(img, mask, 1.2, vol.spacing)
    mem = features8_auto_channels(torch.from_numpy(want).to(cuda), mask, 1.2,
                                  vol.spacing)
    for g, t, m in zip(got, twin, mem):
        assert _same(g, t) and torch.equal(g, m)


def test_bench_torch_gate_passes_on_the_card(cuda):
    # bench_torch.py's verify gate at its own shape (128^3): every kernel
    # the port dispatches against the composed plain ops in f64, each entry
    # < 1e-4 (eigenvalues also per channel outside ties), over >= 3
    # dispatch branches (the gate raises otherwise)
    import bench_torch

    report = bench_torch.verify_on_card(device=cuda)
    assert bench_torch.GATE_SHAPE == (128, 128, 128)
    assert all(v < bench_torch.TOL for v in report.values()), report
    assert len({k.split("[")[1] for k in report if k.startswith("auto_s")}) >= 3
