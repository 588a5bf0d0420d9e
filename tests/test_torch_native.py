"""The port's native host library (ife_tpu_torch/native_lib.py, built from
its own copy of the C++ source) against ife_tpu's native library and numpy
on the CPU: histogram counts equal to the count, make_bag's bag equal to
ife_tpu's to the bit with the native binning counted, HR2 read and write
in both directions between the native and the Python codecs, and a build
that cannot succeed raising instead of falling back."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu import native_lib as JN
from ife_tpu.io.hr2 import read_hr2 as j_read_hr2
from ife_tpu.ops.features import features8_auto as j_features8_auto
from ife_tpu.roi import bag as JB, generate as JG
from ife_tpu.stats.histogram import DenseHistogram as JDense
from ife_tpu_torch import native_lib as N
from ife_tpu_torch.core.volume import Volume, synthetic_ct
from ife_tpu_torch.io.hr2 import read_hr2, write_hr2
from ife_tpu_torch.ops.features import features8_auto_channels
from ife_tpu_torch.roi import bag as TB
from ife_tpu_torch.stats.histogram import DenseHistogram
from tests.test_torch_roi import _gap_edges, _sphere

torch.set_num_threads(1)

SHAPE = (24, 24, 24)
SIGMAS = [0.7, 1.3]
SPACING = (0.8, 0.9, 1.1)


@pytest.fixture(autouse=True)
def _counts():
    N.reset_counts()
    yield


def _numpy_counts(values, edges):
    return np.bincount(np.searchsorted(edges, values, side="left"),
                       minlength=edges.size + 1)


def test_library_builds_into_the_cache_from_the_port_source():
    path = N.build()
    assert path == N.library_path() and path.is_file()
    assert N.BUILD_ROOT in path.parents
    assert N.SOURCE.parent.name == "native"
    assert N.SOURCE.parent.parent.name == "ife_tpu_torch"
    # the port's source is a verbatim copy of native/src/ife_native.cpp
    repo = N.SOURCE.parents[2]
    assert N.SOURCE.read_bytes() == (repo / "native" / "src"
                                     / "ife_native.cpp").read_bytes()
    assert N.build() == path  # cached: a second call builds nothing


@pytest.mark.parametrize("seed,n,n_edges,masked", [
    (0, 300_000, 16, True), (1, 70_000, 1, False), (2, 5_000, 63, True),
    (3, 1, 4, False)])
def test_histogram_equals_ife_tpu_and_numpy(seed, n, n_edges, masked):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n).astype(np.float32)
    edges = np.sort(rng.normal(size=n_edges))
    mask = (rng.random(n) > 0.4).astype(np.uint8) if masked else None
    got = N.histogram_native(v, edges, mask)
    np.testing.assert_array_equal(got, JN.histogram_native(v, edges, mask))
    sel = v if mask is None else v[mask != 0]
    np.testing.assert_array_equal(got, _numpy_counts(sel, edges))
    assert got.dtype == np.uint64 and N.CALLS["histogram"] == 1


@pytest.mark.parametrize("n,h,e", [(100_000, 8, 5), (20_000, 8, 31),
                                   (3, 2, 1), (0, 8, 4)])
def test_histogram_channels_equals_ife_tpu_and_numpy(n, h, e):
    rng = np.random.default_rng(n + h + e)
    V = rng.normal(size=(n, h)).astype(np.float32)
    E = np.sort(rng.normal(size=(h, e)), axis=1)
    mask = (rng.random(n) > 0.3).astype(np.uint8)
    for m in (None, mask):
        got = N.histogram_channels_native(V, E, m)
        np.testing.assert_array_equal(
            got, JN.histogram_channels_native(V, E, m))
        sel = V if m is None else V[m != 0]
        for k in range(h):
            np.testing.assert_array_equal(got[k], _numpy_counts(sel[:, k], E[k]))
    assert N.CALLS["histogram_channels"] == 2


def test_histogram_wrappers_check_shapes():
    with pytest.raises(ValueError, match="mask size"):
        N.histogram_native(np.zeros(4, np.float32), np.zeros(1), np.ones(3))
    with pytest.raises(ValueError, match=r"\(N, H\)"):
        N.histogram_channels_native(np.zeros(4, np.float32), np.zeros((1, 1)))
    with pytest.raises(ValueError, match=r"\(H, E\)"):
        N.histogram_channels_native(np.zeros((4, 2), np.float32),
                                    np.zeros((3, 1)))
    assert N.CALLS["histogram"] == N.CALLS["histogram_channels"] == 0


@pytest.mark.parametrize("n,dtype,weighted", [
    (200_000, np.float32, False),   # > 2^16 f32: the native path
    (200_000, np.float64, False),   # f64: numpy
    (200_000, np.float32, True),    # weights: numpy
    (1000, np.float32, False),      # small: numpy
])
def test_dense_histogram_equals_ife_tpu(n, dtype, weighted):
    rng = np.random.default_rng(2)
    v = rng.normal(size=n).astype(dtype)
    # NaN and +-inf: the native path puts NaN in bin 0, numpy's in the
    # upper tail; the port takes the path ife_tpu takes, so counts agree
    v[:3] = [np.nan, np.inf, -np.inf]
    w = rng.integers(0, 3, n) if weighted else None
    edges = np.linspace(-2, 2, 9)
    t, j = DenseHistogram(edges), JDense(edges)
    for h in (t, j):
        h.insert_many(v, w)
        h.insert_many(v[: n // 2], None if w is None else w[: n // 2])
    np.testing.assert_array_equal(t.get_counts(), j.get_counts())
    native = n > (1 << 16) and dtype == np.float32 and not weighted
    assert N.CALLS["histogram"] == (2 if native else 0)
    if native:  # the trap, pinned: NaN in bin 0, not in the upper tail
        want = sum(_numpy_counts(c[~np.isnan(c)], edges)
                   for c in (v, v[: n // 2]))
        want[0] += 2
        np.testing.assert_array_equal(t.get_counts(), want)


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(11)
    img = (rng.standard_normal(SHAPE) * 200.0 - 600.0).astype(np.float32)
    mask = _sphere(SHAPE, 0.45)
    mask[:4] *= 2  # labels 2 count as foreground
    # per (scale, feature) 5 edges at the widest gaps of ife_tpu's f32
    # features, held away from the port's f32 features too: the two
    # packages' f32 passes may differ in the last bits, and no voxel may
    # sit close enough to an edge to change bins over that
    m = np.clip(mask, 0, 1)
    edges = []
    for s in SIGMAS:
        jf = np.asarray(j_features8_auto(jnp.asarray(img), jnp.asarray(m),
                                         s, SPACING))
        feats = features8_auto_channels(torch.from_numpy(img),
                                        torch.from_numpy(m), s, SPACING)
        for k in range(8):
            jv = jf[..., k][m != 0]
            tv = feats[k].numpy()[m != 0]
            e = _gap_edges(jv, 5)
            assert e.size == 5
            scale = max(np.abs(jv).max(), 1.0)
            for v in (jv, tv):
                assert np.abs(v[:, None] - e[None, :]).min() > 1e-5 * scale
            edges.append(e)
    return img, mask, edges


def test_make_bag_bins_natively_and_equals_ife_tpu(scan):
    img, mask, edges = scan
    base = JG.generate_random_rois(mask, n=6, size=(7, 7, 7), seed=0)
    sizes = [(7, 7, 7), (5, 5, 5), (7, 7, 7), (5, 9, 3), (5, 5, 5), (3, 3, 3)]
    rois = [TB.ROI(r.index, s) for r, s in zip(base, sizes)]
    got = TB.make_bag(img, mask, SIGMAS, edges, rois, spacing=SPACING,
                      device="cpu")
    assert N.CALLS["histogram_channels"] == len(rois) * len(SIGMAS)
    want = JB.make_bag(img, mask, SIGMAS, edges, rois, spacing=SPACING)
    assert got.shape == (6, 6 * 8 * 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the numpy path (f64 features) bins the same voxels into the same bins
    f64 = TB.make_bag(img, mask, SIGMAS, edges, rois, spacing=SPACING,
                      dtype=torch.float64, device="cpu")
    assert N.CALLS["histogram_channels"] == len(rois) * len(SIGMAS)
    np.testing.assert_array_equal(got, f64)


def test_make_bag_empty_roi_is_a_nan_row_on_the_native_path(scan):
    img, mask, edges = scan
    rois = [TB.ROI((0, 0, 0), (3, 3, 3))]  # a corner outside the sphere
    assert not np.clip(mask, 0, 1)[:3, :3, :3].any()
    got = TB.make_bag(img, mask, SIGMAS, edges, rois, spacing=SPACING,
                      device="cpu")
    assert N.CALLS["histogram_channels"] == len(SIGMAS)
    assert np.isnan(got).all()
    np.testing.assert_array_equal(
        got, JB.make_bag(img, mask, SIGMAS, edges, rois, spacing=SPACING))


@pytest.fixture
def vol():
    return Volume(synthetic_ct((24, 20, 16), seed=1).data,
                  spacing=(0.7, 0.8, 1.25), origin=(1.0, 2.0, 3.0))


def test_hr2_native_write_python_read(tmp_path, vol):
    p = str(tmp_path / "n.hr2")
    assert N.hr2_write_native(p, vol.numpy(), vol.spacing, vol.origin)
    assert N.CALLS["hr2_write"] == 1
    back = read_hr2(p, native=False)
    np.testing.assert_array_equal(back.numpy(), vol.numpy())
    assert back.spacing == vol.spacing and back.origin == vol.origin
    j = j_read_hr2(p, native=False)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j.data))
    assert N.CALLS["hr2_read"] == 0


def test_hr2_python_write_native_read(tmp_path, vol):
    p = str(tmp_path / "p.hr2")
    write_hr2(p, vol)
    data, spacing, origin = N.hr2_read_native(p)
    np.testing.assert_array_equal(data, vol.numpy())
    assert spacing == vol.spacing and origin == vol.origin
    # the default read takes the native path, and equals the Python one
    via_default = read_hr2(p)
    assert N.CALLS["hr2_read"] == 2
    np.testing.assert_array_equal(via_default.numpy(), vol.numpy())
    np.testing.assert_array_equal(via_default.numpy(),
                                  read_hr2(p, native=False).numpy())
    assert via_default.data.dtype == torch.float32
    assert via_default.origin == vol.origin


def test_hr2_native_char_pixels(tmp_path):
    data = np.arange(-60, 60, dtype=np.float32).reshape(5, 4, 6)
    p = str(tmp_path / "c.hr2")
    assert N.hr2_write_native(p, data, (1, 1, 1), (0, 0, 0), pixel_type="char")
    back, _, _ = N.hr2_read_native(p)
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(read_hr2(p, native=False).numpy(), data)


def test_hr2_native_errors_keep_the_python_message(tmp_path):
    p = tmp_path / "bad.hr2"
    p.write_bytes(b"HR3garbage")
    with pytest.raises(ValueError, match="not an HR2"):
        N.hr2_read_native(str(p))
    # read_hr2: the native ValueError gives way to the Python path's error
    with pytest.raises(ValueError, match="Not an HR2 file"):
        read_hr2(str(p))
    with pytest.raises(ValueError, match="Not an HR2 file"):
        j_read_hr2(str(p))
    with pytest.raises(ValueError, match="cannot open"):
        N.hr2_read_native(str(tmp_path / "missing.hr2"))
    assert N.CALLS["hr2_read"] == 0


def test_build_without_a_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(N, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(N, "BUILD_ROOT", tmp_path / "cache")
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        N.build()
    with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
        N.histogram_native(np.zeros(4, np.float32), np.zeros(1))
    assert N.CALLS["histogram"] == 0
    assert not (tmp_path / "cache").exists()


def test_build_of_a_broken_source_raises_with_the_compiler_stderr(
        tmp_path, monkeypatch):
    src = tmp_path / "ife_native.cpp"
    src.write_text("int ife_free(void* p) { return undeclared_name; }\n")
    monkeypatch.setattr(N, "SOURCE", src)
    monkeypatch.setattr(N, "BUILD_ROOT", tmp_path / "cache")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        N.build()
    assert not list((tmp_path / "cache").rglob("*.so"))


def test_counts_survive_concurrent_decodes():
    # convert_dicom_dir decodes series in threads: no count may be lost
    import sys
    import threading

    from ife_tpu_torch.io.jpegll import decode_jpeg_lossless_fast, encode_jpeg_lossless

    img = np.arange(48, dtype=np.uint16).reshape(6, 8) * 7
    good = encode_jpeg_lossless(img, precision=12)
    threads, per, errors = 16, 200, []

    def work():
        try:
            for _ in range(per):
                assert np.array_equal(decode_jpeg_lossless_fast(good, 6, 8), img)
                N.count(N.FALLBACKS, "jls_decode")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in ts)
    assert N.CALLS["jll_decode"] == threads * per
    assert N.FALLBACKS["jls_decode"] == threads * per
