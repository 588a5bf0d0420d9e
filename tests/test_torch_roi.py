"""ife_tpu_torch's ROI, bag, bin-edge and text-format code on the CPU
against ife_tpu's: the same seeds give the same ROIs, the writers give
byte-identical files, and the bags agree exactly in f64 (both packages'
features in float64, with every edge kept away from the masked feature
values so that equality is what to expect)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.io import hist_spec as j_spec, roi_text as j_roi_text, text as j_text
from ife_tpu.ops.features import features8 as j_features8
from ife_tpu.roi import bag as JB, generate as JG
from ife_tpu.stats.equalize import (
    determine_edges_for_equalized_histogram as j_equalize,
    edges_from_dense_counts as j_dense_edges,
)
from ife_tpu_torch.io import hist_spec as t_spec, roi_text as t_roi_text, text as t_text
from ife_tpu_torch.roi import bag as TB, generate as TG
from ife_tpu_torch.stats.equalize import (
    determine_edges_for_equalized_histogram as t_equalize,
    edges_from_dense_counts as t_dense_edges,
)

torch.set_num_threads(1)

SHAPE = (24, 24, 24)
SIGMAS = [0.7, 1.3]
SPACING = (0.8, 0.9, 1.1)


def _sphere(shape, frac):
    c = np.ogrid[tuple(slice(0, s) for s in shape)]
    r2 = sum(((x - (s - 1) / 2.0) / (frac * s)) ** 2 for x, s in zip(c, shape))
    return (r2 <= 1.0).astype(np.uint8)


@pytest.fixture(scope="module")
def scan():
    # a noise image: no flat regions, so no feature value sits in a cluster
    # of near-equal values around an edge
    rng = np.random.default_rng(11)
    img = (rng.standard_normal(SHAPE) * 200.0 - 600.0).astype(np.float32)
    mask = _sphere(SHAPE, 0.45)
    mask[:4] *= 2  # labels 2 count as foreground
    return img, mask


def _mixed_rois(mask):
    base = JG.generate_random_rois(mask, n=5, size=(7, 7, 7), seed=0)
    sizes = [(7, 7, 7), (5, 5, 5), (7, 7, 7), (5, 9, 3), (5, 5, 5)]
    return [TG.ROI(r.index, s) for r, s in zip(base, sizes)]


def _gap_edges(values, n_edges):
    """Edges at the midpoints of the widest gaps between sorted values
    near the equal-frequency quantiles: far from every value."""
    s = np.unique(values)
    out = []
    for q in np.linspace(0, 1, n_edges + 2)[1:-1]:
        lo, hi = int(q * (s.size - 1) * 0.9), int(q * (s.size - 1) * 1.1) + 1
        lo, hi = max(lo, 0), min(hi, s.size - 1)
        g = lo + int(np.argmax(np.diff(s[lo : hi + 1])))
        out.append((s[g] + s[g + 1]) / 2.0)
    return np.unique(np.asarray(out))[:n_edges]


@pytest.fixture(scope="module")
def spec(scan):
    """Per (scale, feature) 5 edges; asserts no masked feature value of
    ife_tpu's f64 features lies within 1e-9 of its channel's scale from an
    edge."""
    img, mask = scan
    m = np.clip(mask, 0, 1)
    edges = []
    for s in SIGMAS:
        f = np.asarray(j_features8(jnp.asarray(img, jnp.float64), jnp.asarray(m),
                                   s, SPACING))
        for k in range(8):
            v = f[..., k][m != 0]
            e = _gap_edges(v, 5)
            assert e.size == 5
            scale = max(np.abs(v).max(), 1.0)
            assert np.abs(v[:, None] - e[None, :]).min() > 1e-9 * scale
            edges.append(e)
    return edges


def test_random_and_dense_rois_equal_ife_tpu(scan):
    _, mask = scan
    for seed in (0, 1):
        for size in ((7, 7, 7), (6, 9, 4)):
            t = TG.generate_random_rois(mask, 20, size, seed=seed)
            j = JG.generate_random_rois(mask, 20, size, seed=seed)
            assert [(r.index, r.size) for r in t] == [(r.index, r.size) for r in j]
            assert [str(r) for r in t] == [str(r) for r in j]
    small = mask[6:14, 5:15, 7:13]
    t = TG.generate_dense_rois(small, (3, 3, 3))
    j = JG.generate_dense_rois(small, (3, 3, 3))
    assert t and [(r.index, r.size) for r in t] == [(r.index, r.size) for r in j]
    assert TG.generate_dense_rois(np.zeros((4, 4, 4)), (3, 3, 3)) == []
    with pytest.raises(ValueError):
        TG.generate_random_rois(np.zeros((8, 8, 8)), 3, (3, 3, 3), seed=0)


def test_writers_give_byte_identical_files(tmp_path, scan):
    _, mask = scan
    rois = _mixed_rois(mask)
    t_roi_text.write_rois(str(tmp_path / "t.roi"), rois, header="# rois")
    j_roi_text.write_rois(str(tmp_path / "j.roi"), rois, header="# rois")
    assert (tmp_path / "t.roi").read_bytes() == (tmp_path / "j.roi").read_bytes()
    back = t_roi_text.read_rois(str(tmp_path / "j.roi"), header=True)
    assert [(r.index, r.size) for r in back] == [(r.index, r.size) for r in rois]

    rng = np.random.default_rng(2)
    rows = [np.sort(rng.standard_normal(7)) for _ in range(16)]
    rows[3] = rows[3].astype(np.float32)
    kw = dict(scales=[0.6, 2.4], feature_names=["a", "b"])
    t_spec.write_hist_spec(str(tmp_path / "t.spec"), rows, **kw)
    j_spec.write_hist_spec(str(tmp_path / "j.spec"), rows, **kw)
    assert (tmp_path / "t.spec").read_bytes() == (tmp_path / "j.spec").read_bytes()
    got = t_spec.read_hist_spec(str(tmp_path / "j.spec"))
    want = j_spec.read_hist_spec(str(tmp_path / "j.spec"))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))

    bag = rng.standard_normal((4, 9)) * 10.0 ** rng.integers(-8, 8, (4, 9))
    bag[0, :3] = [np.nan, 0.0, 1.0]
    t_text.write_matrix_csv(str(tmp_path / "t.bag"), bag)
    j_text.write_matrix_csv(str(tmp_path / "j.bag"), bag)
    assert (tmp_path / "t.bag").read_bytes() == (tmp_path / "j.bag").read_bytes()
    (tmp_path / "pairs").write_text("a.nii , b.nii\n\nc,d\n")
    assert (t_text.read_pair_list(str(tmp_path / "pairs"))
            == j_text.read_pair_list(str(tmp_path / "pairs")))


@pytest.mark.parametrize("samples,n_bins", [
    (np.arange(1, 10), 3), (np.ones(8), 2), (np.array([1, 1, 1, 1, 1, 2, 2, 3, 3, 3]), 3),
    (np.sort(np.random.default_rng(2).uniform(-10, 10, 1000)), 50),
    (np.sort(np.round(np.random.default_rng(3).normal(0, 3, 5000))), 32),
])
def test_equalized_edges_equal_ife_tpu(samples, n_bins):
    np.testing.assert_array_equal(t_equalize(samples, n_bins),
                                  j_equalize(samples, n_bins))


def test_equalized_edges_errors_and_dense_counts():
    with pytest.raises(ValueError):
        t_equalize(np.arange(1, 10), 10)
    rng = np.random.default_rng(4)
    fine = np.linspace(-3, 3, 257)
    counts = rng.integers(0, 50, 256)
    np.testing.assert_array_equal(t_dense_edges(fine, counts, 16),
                                  j_dense_edges(fine, counts, 16))


@pytest.mark.parametrize("fn", ["make_bag", "make_bag_device"])
def test_bags_equal_ife_tpu_in_f64(scan, spec, fn):
    img, mask = scan
    edges = spec
    rois = _mixed_rois(mask)
    got = getattr(TB, fn)(img, mask, SIGMAS, edges, rois, spacing=SPACING,
                          dtype=torch.float64, device="cpu")
    want = getattr(JB, fn)(img, mask, SIGMAS, edges, rois, spacing=SPACING,
                           dtype=jnp.float64)
    assert got.shape == (5, 6 * 8 * 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    sums = got.reshape(5, 16, 6).sum(-1)
    np.testing.assert_allclose(sums, 1.0, rtol=1e-6)


@pytest.mark.parametrize("fn", ["make_bag", "make_bag_device"])
@pytest.mark.parametrize("case", ["unmasked_roi", "no_rois"])
def test_unmasked_rois_and_no_rois_equal_ife_tpu(scan, spec, fn, case):
    # an ROI in the sphere's corner holds no masked voxel: a NaN row in both
    img, mask = scan
    rois = ([] if case == "no_rois" else
            _mixed_rois(mask)[:3] + [TG.ROI((0, 0, 0), (4, 4, 4))]
            + _mixed_rois(mask)[3:])
    got = getattr(TB, fn)(img, mask, SIGMAS, spec, rois, spacing=SPACING,
                          dtype=torch.float64, device="cpu")
    want = getattr(JB, fn)(img, mask, SIGMAS, spec, rois, spacing=SPACING,
                           dtype=jnp.float64)
    assert got.shape == want.shape == (len(rois), 6 * 8 * 2)
    np.testing.assert_array_equal(got, want)
    assert [bool(np.isnan(r).all()) for r in got] == [
        r.index == (0, 0, 0) for r in rois]
    assert not np.isnan(got[[r.index != (0, 0, 0) for r in rois]]).any()


def test_device_bag_equals_host_bag_within_the_f32_division(scan, spec):
    # the device form divides in f32 (as ife_tpu's does): within 2^-23 of
    # the host form's f64 division, every entry
    img, mask = scan
    edges = spec
    rois = _mixed_rois(mask)
    host = TB.make_bag(img, mask, SIGMAS, edges, rois, SPACING,
                       dtype=torch.float64, device="cpu")
    dev = TB.make_bag_device(img, mask, SIGMAS, edges, rois, SPACING,
                             dtype=torch.float64, device="cpu")
    assert np.abs(host - dev).max() <= 2.0 ** -23


def test_bag_checks_and_host_tools_equal_ife_tpu(scan):
    img, mask = scan
    rois = _mixed_rois(mask)
    with pytest.raises(ValueError, match="Number of histograms"):
        TB.make_bag(img, mask, [1.0], [np.array([0.0])] * 7, rois, device="cpu")
    with pytest.raises(ValueError, match="same bin count"):
        TB.make_bag_device(img, mask, [1.0], [np.array([0.0])] * 7
                           + [np.array([0.0, 1.0])], rois, device="cpu")
    with pytest.raises(ValueError, match="Number of histograms"):
        TB.make_bag_sharded(img, mask, [1.0], [], rois, None)
    assert TB._size_classes(rois) == JB._size_classes(rois)
    e = np.array([-700.0, -600.0, -500.0])
    np.testing.assert_array_equal(TB.make_bag_intensity(img, mask, e, rois),
                                  JB.make_bag_intensity(img, mask, e, rois))
    same = [r for r in rois if r.size == (7, 7, 7)]
    np.testing.assert_array_equal(TB.sample_rois(img, same),
                                  JB.sample_rois(img, same))
    with pytest.raises(ValueError):
        TB.sample_rois(img, rois)
    lab = (mask * 3 + (img > -600)).astype(np.int32)
    for kw in ({}, dict(ignore=[0]), dict(ignore=[0], dominant=4,
                                         dominant_threshold=0.1)):
        assert TB.extract_labels(lab, rois, **kw) == JB.extract_labels(lab, rois, **kw)
    assert TB._roi_frequencies(np.array([0.5, 1.0, 1.5, 2.5]),
                               np.array([1.0, 2.0])).tolist() == [0.5, 0.25, 0.25]
