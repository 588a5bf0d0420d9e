"""ife_tpu_torch.ops.transform against ife_tpu.ops.transform on the same
seeded numpy inputs, on the CPU (device="cpu"; under the tests' x64, as
ife_tpu runs here), and the seven subcommands over it against ife_tpu's CLI
on the same files.

Tolerances: every function is held equal to the bit (the same dtype, the
same values), except order-1 resampling, held within 1 f32 ulp per voxel:
both interpolate in f64 and round to f32 once, ife_tpu as map_coordinates'
sum over 8 (or 4) corners, the port one axis at a time, so the two f64
values differ only in rounding. The order-1 window's uint8 values are held
equal where the value before rounding lies farther than 1e-5 from a half.
"""
import gzip

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.cli.main import main as j_main
from ife_tpu.core.volume import Volume as JVolume
from ife_tpu.core.volume import sphere_mask, synthetic_ct
from ife_tpu.io import read_volume as j_read, write_volume as j_write
from ife_tpu.ops import transform as JT
from ife_tpu_torch.cli.main import main as t_main
from ife_tpu_torch.core.volume import Volume as TVolume
from ife_tpu_torch.io import read_volume as t_read
from ife_tpu_torch.ops import transform as TT

torch.set_num_threads(1)

SHAPE = (16, 14, 12)
SPACING = (0.78, 0.78, 1.0)


def _ordered(a):
    """f32 values as integers in the order of the floats (adjacent floats
    differ by 1)."""
    i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulp_distance(got, want):
    """Largest distance in f32 ulps (NaN only where both are NaN)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (np.isnan(got) == np.isnan(want)).all()
    ok = ~np.isnan(want)
    return int(np.abs(_ordered(got[ok]) - _ordered(want[ok])).max(initial=0))


def _same(got, want):
    """Same dtype, same values to the bit."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(12)


def _image(rng, dtype=np.float32, shape=SHAPE):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-1024, 1500, shape).astype(dtype)
    return (rng.standard_normal(shape) * 400.0 - 500.0).astype(dtype)


def _labels(rng, shape=SHAPE, dtype=np.uint8):
    return rng.integers(0, 5, shape).astype(dtype)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,outside", [(np.float32, 0.0),
                                           (np.float32, -1024.5),
                                           (np.int16, -1024.7),
                                           (np.int16, 0.5)])
def test_mask_image_matches_ife_tpu(rng, dtype, outside):
    img, mask = _image(rng, dtype), _labels(rng)
    got = TT.mask_image(img, mask, outside, device="cpu")
    _same(got, JT.mask_image(jnp.asarray(img), jnp.asarray(mask), outside))
    assert got.dtype == torch.from_numpy(img).dtype  # an int16 CT stays int16


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_relabel_mask_matches_ife_tpu(rng, dtype):
    mask = _labels(rng, dtype=dtype)
    for include, inside, outside in (([1, 3], 1, 0), ([4, 2, 300], 7, 9),
                                     ([0], 2, 1)):
        got = TT.relabel_mask(mask, include, inside, outside, device="cpu")
        _same(got, JT.relabel_mask(jnp.asarray(mask), include, inside,
                                   outside))


def test_bounding_box_and_crop_match_ife_tpu(rng):
    mask = np.zeros(SHAPE, np.uint8)
    mask[3:9, 2:13, 5:6] = rng.integers(0, 2, (6, 11, 1))
    mask[4, 2, 5] = mask[8, 12, 5] = 1
    assert TT.bounding_box(mask) == JT.bounding_box(mask) == ((3, 2, 5),
                                                              (6, 11, 1))
    img = _image(rng)
    got = TT.crop_to_bounding_box(
        TVolume.from_numpy(img, spacing=SPACING, origin=(1.0, -2.0, 3.5)),
        torch.from_numpy(mask))
    want = JT.crop_to_bounding_box(
        JVolume(jnp.asarray(img), spacing=SPACING, origin=(1.0, -2.0, 3.5)),
        mask)
    _same(got.data, want.data)
    assert got.spacing == want.spacing and got.origin == want.origin
    for fn in (TT.bounding_box, JT.bounding_box):
        with pytest.raises(ValueError, match="no foreground"):
            fn(np.zeros(SHAPE, np.uint8))


@pytest.mark.parametrize("target", [(16, 14), (19, 20), (17, 15)])
def test_pad_to_size_2d_matches_ife_tpu(rng, target):
    img = _image(rng, shape=SHAPE[:2])
    _same(TT.pad_to_size_2d(img, target, -3.5),
          JT.pad_to_size_2d(img, target, -3.5))


def test_pad_to_size_2d_refuses_a_smaller_target(rng):
    img = _image(rng, shape=SHAPE[:2])
    for fn in (TT.pad_to_size_2d, JT.pad_to_size_2d):
        with pytest.raises(ValueError, match="smaller than image"):
            fn(img, (15, 20))


@pytest.mark.parametrize("level,width", [(-500.0, 1500.0), (40.0, 400.0),
                                         (127.5, 255.0)])
def test_intensity_window_matches_ife_tpu(rng, level, width):
    img = _image(rng)
    # values whose window lands on a half, where the two roundings differ
    img.reshape(-1)[:256] = (level - width / 2.0
                             + (np.arange(256) + 0.5) * width / 255.0)
    got = TT.intensity_window(img, level, width, device="cpu")
    _same(got, JT.intensity_window(jnp.asarray(img), level, width))


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("spacing,out_spacing", [((1.0, 1.0), 0.5),
                                                 ((0.78, 0.9), 0.25),
                                                 ((0.5, 0.7), 0.6)])
def test_resample_to_spacing_2d_matches_ife_tpu(rng, order, spacing,
                                                out_spacing):
    img = _image(rng, shape=(9, 7))
    got = TT.resample_to_spacing_2d(img, spacing, out_spacing, order=order,
                                    device="cpu").numpy()
    want = np.asarray(JT.resample_to_spacing_2d(jnp.asarray(img), spacing,
                                                out_spacing, order=order))
    assert got.dtype == want.dtype == np.float32
    if order == 1:
        assert ulp_distance(got, want) <= 1
    else:
        _same(got, want)


def test_resample_to_spacing_2d_order_0_rounds_the_grid_half_to_even(rng):
    # 1 mm onto 0.5 mm puts every odd output at k + 0.5: half to even keeps
    # k for even k, half away from zero would take k + 1
    img = _image(rng, shape=(9, 7))
    got = TT.resample_to_spacing_2d(img, (1.0, 1.0), 0.5, order=0,
                                    device="cpu").numpy()
    want = np.asarray(JT.resample_to_spacing_2d(jnp.asarray(img), (1.0, 1.0),
                                                0.5, order=0))
    _same(got, want)
    even = [np.clip(np.round(np.arange(n) * 0.5), 0, m - 1).astype(int)
            for n, m in ((18, 9), (14, 7))]
    away = [np.clip(np.floor(np.arange(n) * 0.5 + 0.5), 0, m - 1).astype(int)
            for n, m in ((18, 9), (14, 7))]
    np.testing.assert_array_equal(got, img[np.ix_(*even)])
    assert not np.array_equal(got, img[np.ix_(*away)])


def _grid_case(rng, dtype=np.float32):
    """A source and a target whose grid reaches -0.5, beyond -1 and past
    the far face of the source on every axis, with half-voxel and
    non-dyadic coordinates."""
    src = JVolume(jnp.asarray(_image(rng, dtype, (7, 6, 5))),
                  spacing=(1.0, 1.0, 2.0), origin=(0.0, 10.0, -4.0))
    tgt_shape = (24, 17, 11)
    tgt = JVolume(jnp.zeros(tgt_shape, jnp.float32),
                  spacing=(0.5, 0.7, 1.3), origin=(-2.0, 9.5, -7.0))
    return src, tgt


def _t_volume(j):
    return TVolume.from_numpy(np.asarray(j.data), spacing=j.spacing,
                              origin=j.origin)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("default_value", [0.0, -1024.25])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_resample_to_grid_matches_ife_tpu(rng, order, default_value, dtype):
    src, tgt = _grid_case(rng, dtype)
    got = TT.resample_to_grid(_t_volume(src), _t_volume(tgt), order=order,
                              default_value=default_value, device="cpu")
    want = JT.resample_to_grid(src, tgt, order=order,
                               default_value=default_value)
    assert got.spacing == want.spacing and got.origin == want.origin
    g, w = got.data.numpy(), np.asarray(want.data)
    assert g.dtype == w.dtype == np.float32
    if order == 1:
        assert ulp_distance(g, w) <= 1
    else:
        _same(g, w)


def test_resample_to_grid_constant_mode_is_per_corner(rng):
    # x at -0.5: 0.5 cval + 0.5 v[0]; x at -1.5: cval; x past the far face
    # by half a voxel: 0.5 v[n-1] + 0.5 cval; order 0 rounds -0.5 away from
    # zero, to -1 (cval), and 0.5 to 1
    v = _image(rng, shape=(4, 1, 1))
    src = TVolume.from_numpy(v)
    tgt = TVolume.from_numpy(np.zeros((6, 1, 1), np.float32),
                             origin=(-1.5, 0.0, 0.0), spacing=(1.0, 1.0, 1.0))
    cval = 100.0
    lin = TT.resample_to_grid(src, tgt, 1, cval, device="cpu").data[:, 0, 0]
    x = v[:, 0, 0].astype(np.float64)
    want = np.float32([cval, 0.5 * cval + 0.5 * x[0], 0.5 * (x[0] + x[1]),
                       0.5 * (x[1] + x[2]), 0.5 * (x[2] + x[3]),
                       0.5 * x[3] + 0.5 * cval])
    np.testing.assert_array_equal(lin.numpy(), want)
    tgt2 = TVolume.from_numpy(np.zeros((7, 1, 1), np.float32),
                              origin=(-1.5, 0.0, 0.0), spacing=(0.5, 1, 1))
    near = TT.resample_to_grid(src, tgt2, 0, cval, device="cpu").data[:, 0, 0]
    # coordinates -1.5, -1, -0.5, 0, 0.5, 1, 1.5 -> -2, -1, -1, 0, 1, 1, 2
    np.testing.assert_array_equal(
        near.numpy(), np.float32([cval, cval, cval, x[0], x[1], x[1], x[2]]))
    j = JT.resample_to_grid(JVolume(jnp.asarray(v)),
                            JVolume(jnp.zeros((7, 1, 1)), origin=(-1.5, 0, 0),
                                    spacing=(0.5, 1, 1)), 0, cval)
    _same(near.numpy(), np.asarray(j.data)[:, 0, 0])


def test_round_half_away_from_zero_is_exact():
    c = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49999999999999994,
                  -0.49999999999999994, 2.4999999999999996, 0.0, -0.0, 3.0])
    np.testing.assert_array_equal(TT._round_half_away_from_zero(c),
                                  [1, 2, 3, -1, -2, 0, 0, 2, 0, 0, 3])


@pytest.mark.parametrize("n,indices,fractions,window,stride", [
    (20, [3, 7], [], 0, 1), (20, [], [0.0, 0.5, 1.0], 2, 3),
    (5, [0, 4, 9], [0.25], 3, 1), (12, [6, 6], [0.5], 1, 2)])
def test_slice_indices_match_ife_tpu(n, indices, fractions, window, stride):
    assert (TT.slice_indices(n, indices, fractions, window, stride)
            == JT.slice_indices(n, indices, fractions, window, stride))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("flip", [False, True])
def test_extract_slice_matches_ife_tpu(rng, axis, flip):
    vol = _image(rng)
    got = TT.extract_slice(vol, axis, 3, flip=flip)
    _same(got, JT.extract_slice(vol, axis, 3, flip=flip))
    # a flipped slice is a negative-stride view; contiguous, it is a tensor
    t = torch.from_numpy(np.ascontiguousarray(got))
    assert t.numpy().tobytes() == np.asarray(got).tobytes()


# ---------------------------------------------------------------------------
# the subcommands over it
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def ask_for_the_cpu():
    """The port runs on the card unless asked: these tests ask for the
    CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IFE_PLATFORM", "cpu")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An f32 CT, an int16 CT and a label mask (0/1/2) at 16x14x12, a 2D
    slice of each, and a target grid for resample whose extent reaches past
    the source's on every side."""
    d = tmp_path_factory.mktemp("torch_transform_cli")
    img = np.asarray(synthetic_ct(SHAPE, seed=7).data)
    mask = np.asarray(sphere_mask(SHAPE, 0.42).data).astype(np.uint8)
    mask[: SHAPE[0] // 2] *= 2
    ct16 = np.round(img).astype(np.int16)
    vols = {"img": img, "ct16": ct16, "mask": mask}
    for name, arr in vols.items():
        j_write(str(d / f"{name}.nii.gz"),
                JVolume(jnp.asarray(arr), spacing=SPACING, origin=(2.0, -3.0, 1.5)))
        j_write(str(d / f"{name}2d.nii.gz"),
                JVolume(jnp.asarray(arr[:, :, 5:6]), spacing=(0.78, 0.9, 1.0)))
    j_write(str(d / "img2d_1mm.nii.gz"),
            JVolume(jnp.asarray(img[:, :, 5:6]), spacing=(1.0, 1.0, 1.0)))
    # a 1 mm source onto a 0.5 mm grid: ties at k + 0.5 on every axis
    j_write(str(d / "img1mm.nii.gz"),
            JVolume(jnp.asarray(img), origin=(2.0, -3.0, 1.5)))
    grids = {"target": ((20, 17, 11), (0.7, 0.7, 1.1), (0.5, -4.0, 0.0)),
             "target_half": ((36, 33, 30), (0.5, 0.5, 0.5), (0.5, -4.5, 0.0))}
    for name, (shape, sp, origin) in grids.items():
        j_write(str(d / f"{name}.nii.gz"),
                JVolume(jnp.zeros(shape, jnp.float32), spacing=sp,
                        origin=origin))
    return d


def _both(d, name, *args, out):
    """Run `name` in both CLIs; returns the two output paths."""
    t_out, j_out = d / f"t_{out}", d / f"j_{out}"
    assert t_main([name, *map(str, args), "-o", str(t_out)]) == 0
    assert j_main([name, *map(str, args), "-o", str(j_out)]) == 0
    return t_out, j_out


def _bytes_equal(t_out, j_out):
    """The same file, byte for byte (a .gz file's content: its header holds
    the file's name and time)."""
    read = gzip.open if str(t_out).endswith(".gz") else open
    with read(t_out, "rb") as a, read(j_out, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("image,outside", [("img", "-1000.5"),
                                           ("ct16", "-1024.7")])
def test_masked_image_filter_cli_matches_ife_tpu(files, image, outside):
    t, j = _both(files, "masked-image-filter", "-i", files / f"{image}.nii.gz",
                 "-m", files / "mask.nii.gz", "--outside", outside,
                 out=f"mif_{image}.nii.gz")
    _bytes_equal(t, j)
    assert t_read(str(t)).numpy().dtype == j_read(str(j)).numpy().dtype


def test_extract_masked_region_cli_matches_ife_tpu(files):
    t, j = _both(files, "extract-masked-region", "-m",
                 files / "mask.nii.gz", "--include", "2", "7", "--inside",
                 "5", "--outside", "3", out="emr.nii.gz")
    _bytes_equal(t, j)
    assert set(np.unique(t_read(str(t)).numpy())) == {3, 5}


def test_extract_bounding_box_cli_matches_ife_tpu(files):
    t, j = _both(files, "extract-bounding-box", "-i", files / "img.nii.gz",
                 "-m", files / "mask.nii.gz", out="ebb.nii.gz")
    _bytes_equal(t, j)
    assert t_read(str(t)).shape != SHAPE


@pytest.mark.parametrize("extra", [["--axis", "0", "--indices", "2", "9",
                                    "--window", "1"],
                                   ["--axis", "1", "--fractions", "0.5",
                                    "--no-flip"],
                                   ["--axis", "2", "--indices", "4",
                                    "--mask", "MASK"]])
def test_extract_slices_cli_matches_ife_tpu(files, extra):
    extra = [str(files / "mask.nii.gz") if a == "MASK" else a for a in extra]
    tag = "_".join(extra[:2]).replace("-", "")
    t, j = _both(files, "extract-slices", "-i", files / "img.nii.gz", *extra,
                 out=f"es_{tag}")
    t_files = sorted(p.name[len("t_"):] for p in files.glob(f"t_es_{tag}_*"))
    j_files = sorted(p.name[len("j_"):] for p in files.glob(f"j_es_{tag}_*"))
    assert t_files and t_files == j_files
    for name in t_files:
        _bytes_equal(files / f"t_{name}", files / f"j_{name}")


@pytest.mark.parametrize("order", ["0", "3"])
@pytest.mark.parametrize("image,with_mask", [("img2d", False),
                                             ("img2d_1mm", False),
                                             ("ct162d", True)])
def test_extract_window_cli_matches_ife_tpu(files, order, image, with_mask):
    mask = ["--mask", files / "mask2d.nii.gz"] if with_mask else []
    t, j = _both(files, "extract-window", "-i", files / f"{image}.nii.gz",
                 "-b", order, "--out-spacing", "0.5", "--level", "-400",
                 "--width", "900", *mask, out=f"ew{order}_{image}.nii.gz")
    _bytes_equal(t, j)


@pytest.mark.parametrize("image", ["img2d", "img2d_1mm"])
def test_extract_window_order_1_cli_matches_ife_tpu(files, image):
    # uint8 values equal; where one differs, the value before rounding lies
    # within 1e-5 of a half (its f32 order-1 resample differs by 1 ulp)
    t, j = _both(files, "extract-window", "-i", files / f"{image}.nii.gz",
                 "-b", "1", "--out-spacing", "0.5", "--level", "-400",
                 "--width", "900", out=f"ew1_{image}.nii.gz")
    g = t_read(str(t)).numpy()
    w = np.asarray(j_read(str(j)).data)
    assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
    vol = j_read(str(files / f"{image}.nii.gz"))
    res = np.asarray(JT.resample_to_spacing_2d(
        jnp.asarray(np.asarray(vol.data)[..., 0]), vol.spacing[:2], 0.5,
        order=1), np.float64)
    y = (res - (-400.0 - 450.0)) / 900.0 * 255.0
    differ = g[..., 0] != w[..., 0]
    assert np.abs(np.abs(y[differ] - np.floor(y[differ])) - 0.5).max(
        initial=0.0) <= 1e-5
    assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


@pytest.mark.parametrize("size", ["20,20", "17,15"])
def test_pad_image_cli_matches_ife_tpu(files, size):
    t, j = _both(files, "pad-image", "-i", files / "img2d.nii.gz", "--size",
                 size, "--value", "-1000", out=f"pad_{size[:2]}.nii.gz")
    _bytes_equal(t, j)


RESAMPLE_CASES = [("img", "target"), ("img1mm", "target_half"),
                  ("ct16", "target")]


@pytest.mark.parametrize("source,target", RESAMPLE_CASES)
def test_resample_nearest_cli_matches_ife_tpu(files, source, target):
    t, j = _both(files, "resample", "-s", files / f"{source}.nii.gz", "-t",
                 files / f"{target}.nii.gz", "--nearest", "--default-value",
                 "-1024", out=f"rsn_{source}.nii.gz")
    _bytes_equal(t, j)


@pytest.mark.parametrize("source,target", RESAMPLE_CASES)
def test_resample_linear_cli_matches_ife_tpu(files, source, target):
    t, j = _both(files, "resample", "-s", files / f"{source}.nii.gz", "-t",
                 files / f"{target}.nii.gz", "--default-value", "-1024",
                 out=f"rsl_{source}.nii.gz")
    tv, jv = t_read(str(t)), j_read(str(j))
    assert tv.spacing == jv.spacing and tv.origin == jv.origin
    g, w = tv.numpy(), np.asarray(jv.data)
    assert g.dtype == w.dtype == np.float32
    # the grid reaches outside the source: some voxels are all cval, some
    # none of it
    assert (w == -1024).any() and (w != -1024).any()
    assert ulp_distance(g, w) <= 1


def _ulp_survey(seeds=20):
    """The largest ulp distance from ife_tpu of order-1 resampling, over
    `seeds` seeded inputs of each case above and a 64^3 synthetic CT onto a
    0.7 x 0.7 x 1.1 mm grid shifted by a few mm: {case: (ulps, voxels that
    differ, voxels)}."""
    out = {}

    def note(case, got, want):
        u = ulp_distance(got, want)
        n = int((np.asarray(got) != np.asarray(want)).sum())
        prev = out.get(case, (0, 0, 0))
        out[case] = (max(prev[0], u), prev[1] + n, prev[2] + np.size(want))

    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        img = _image(rng, shape=(9, 7))
        for sp, osp in (((1.0, 1.0), 0.5), ((0.78, 0.9), 0.25),
                        ((0.5, 0.7), 0.6)):
            note(f"resample_to_spacing_2d {sp} -> {osp}",
                 TT.resample_to_spacing_2d(img, sp, osp, 1, device="cpu"),
                 JT.resample_to_spacing_2d(jnp.asarray(img), sp, osp, 1))
        for dtype in (np.float32, np.int16):
            src, tgt = _grid_case(rng, dtype)
            note(f"resample_to_grid {np.dtype(dtype).name}",
                 TT.resample_to_grid(_t_volume(src), _t_volume(tgt), 1,
                                     -1024.25, device="cpu").data,
                 JT.resample_to_grid(src, tgt, 1, -1024.25).data)
    ct = synthetic_ct((64, 64, 64), seed=2)
    src = JVolume(ct.data, spacing=(0.78, 0.78, 1.0))
    tgt = JVolume(jnp.zeros((72, 72, 58)), spacing=(0.7, 0.7, 1.1),
                  origin=(3.0, -2.5, 4.0))
    note("resample_to_grid 64^3 CT",
         TT.resample_to_grid(_t_volume(src), _t_volume(tgt), 1, -1024.0,
                             device="cpu").data,
         JT.resample_to_grid(src, tgt, 1, -1024.0).data)
    return out


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_transform.py: _ulp_survey's
    # table, on the CPU under x64 as the tests run
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for case, (ulps, n, size) in _ulp_survey().items():
        print(f"{case}: largest {ulps} ulp, {n} of {size} voxels differ")
