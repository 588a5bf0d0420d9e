"""MakeBagDense on the device (roi/bag.py:make_bag_dense_device over
kernels/dense_hist.py): the starts are generate_dense_rois' in its order,
the rows are make_bag_device's bag of those ROIs to the bit and agree with
the benchmark's float64 reference, the box-sum twin is histogram_boxes'
twin, a scan given as tensors on the device bags as its host arrays, and
make-bag-dense --device writes the same files. The kernels run only on the
card (marker gpu), against their twin.

This file imports neither JAX nor ife_tpu; on the card run its card cases
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_dense_bag.py -q
"""
import numpy as np
import pytest
import torch

from ifebench import reference
from ifebench.checks.bag import moved
from ife_tpu_torch.cli.main import main as t_main
from ife_tpu_torch.core.volume import Volume
from ife_tpu_torch.io import (
    read_volume, write_hist_spec, write_matrix_csv, write_volume,
)
from ife_tpu_torch.kernels import LAUNCHES
from ife_tpu_torch.kernels.dense_hist import (
    DENSE_HIST_PLAN, _rows_plan, dense_counts_plain,
    dense_hist_rows, dense_index, dense_starts,
)
from ife_tpu_torch.kernels.histogram import histogram_boxes_plain
from ife_tpu_torch.roi.bag import make_bag_dense_device, make_bag_device
from ife_tpu_torch.roi.generate import ROI, generate_dense_rois

torch.set_num_threads(1)

SHAPE = (40, 36, 32)
SPACING = (0.78, 0.78, 1.0)
SIGMAS = (0.8, 1.6)
SIZE = (7, 7, 7)
BINS = 8


def _ellipsoids(shape, lungs, semi):
    """uint8 mask of ellipsoids centred at each of `lungs`."""
    g = np.meshgrid(*[np.arange(n) + 0.5 for n in shape], indexing="ij")
    m = np.zeros(shape, bool)
    for c in lungs:
        m |= sum(((a - ci) / s) ** 2 for a, ci, s in zip(g, c, semi)) <= 1
    return m.astype(np.uint8)


def _masks():
    lungs = _ellipsoids(SHAPE, [(12, 18, 16), (28, 18, 16)], (5, 7, 8))
    face = np.zeros(SHAPE, np.uint8)
    face[:6, 10:20, 8:20] = 1          # touches the x = 0 face
    face[30:, 30:, 25:] = 2            # a corner block, labels of 2
    single = np.zeros(SHAPE, np.uint8)
    single[17, 20, 11] = 1
    return {"lungs": lungs, "face": face, "single": single,
            "empty": np.zeros(SHAPE, np.uint8)}


MASKS = _masks()


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(22)
    img = (rng.standard_normal(SHAPE) * 120.0 - 850.0).astype(np.float32)
    img[MASKS["lungs"] == 0] += 600.0
    return img


@pytest.fixture(scope="module")
def edges(scan):
    """Equal-frequency edges of each (scale, feature) over the lungs, from
    the reference's features: every bin holds voxels."""
    img, mask = torch.from_numpy(scan), torch.from_numpy(MASKS["lungs"])
    out = []
    for sigma in SIGMAS:
        f = reference.features(img, mask, sigma, SPACING)
        inside = mask != 0
        for k in range(8):
            q = torch.linspace(0, 1, BINS + 1, dtype=torch.float64)[1:-1]
            out.append(torch.quantile(f[k][inside], q).numpy())
    return out


def _dense(img, mask, edges, **kw):
    return make_bag_dense_device(img, mask, SIGMAS, edges, SIZE, SPACING,
                                 device=kw.pop("device", "cpu"), **kw)


@pytest.mark.parametrize("name", list(MASKS))
def test_the_starts_are_generate_dense_rois_in_its_order(scan, edges, name):
    mask = MASKS[name]
    starts, rows = _dense(scan, mask, edges)
    want = [r.index for r in generate_dense_rois(mask, SIZE)]
    assert starts.dtype == torch.int64 and starts.shape == (len(want), 3)
    assert starts.tolist() == [list(w) for w in want]
    assert rows.dtype == torch.float32
    assert rows.shape == (len(want), BINS * 8 * len(SIGMAS))
    if name == "empty":
        assert rows.shape[0] == 0


@pytest.mark.parametrize("name", ["lungs", "face", "single"])
def test_the_rows_are_make_bag_devices_bag_to_the_bit(scan, edges, name):
    mask = MASKS[name]
    starts, rows = _dense(scan, mask, edges)
    rois = generate_dense_rois(mask, SIZE)
    pick = np.sort(np.random.default_rng(5).choice(
        len(rois), size=min(300, len(rois)), replace=False))
    bag = make_bag_device(scan, mask, SIGMAS, edges, [rois[j] for j in pick],
                          SPACING, device="cpu")
    np.testing.assert_array_equal(rows[torch.from_numpy(pick)].double().numpy(),
                                  bag)


def test_the_rows_agree_with_the_float64_reference(scan, edges):
    mask = MASKS["lungs"]
    starts, rows = _dense(scan, mask, edges)
    img, msk = torch.from_numpy(scan), torch.from_numpy(mask)
    ref = []
    for i, sigma in enumerate(SIGMAS):
        f = reference.features(img, msk, sigma, SPACING)
        ref.append(reference.bag_rows(f, msk, (0, 0, 0), starts.numpy(), SIZE,
                                      np.stack(edges[8 * i:8 * i + 8])))
    assert moved(rows.numpy(), np.concatenate(ref, axis=1), BINS) <= 1e-1


@pytest.mark.parametrize("size", [SIZE, (5, 3, 4)])
def test_the_box_sum_twin_is_histogram_boxes_twin(scan, size):
    rng = np.random.default_rng(9)
    chans = [torch.from_numpy(scan + rng.standard_normal(SHAPE).astype(
        np.float32) * 50.0 * k) for k in range(3)]
    chans[1].view(-1)[::97] = float("nan")
    chans[2].view(-1)[::89] = float("inf")
    weights = torch.from_numpy(MASKS["lungs"] | MASKS["face"])
    e = torch.tensor(np.stack([np.sort(rng.uniform(-1200, 0, 5))
                               for _ in range(3)]))
    starts = dense_starts(weights != 0, size)
    pick = torch.from_numpy(np.random.default_rng(1).choice(
        starts.shape[0], 200, replace=False))
    got = dense_counts_plain(chans, weights, starts[pick], size, e)
    # each voxel of a nonzero weight counts once, as make_bag_device's
    # `mask != 0` weights count it
    want = histogram_boxes_plain(chans, weights != 0, starts[pick].numpy(),
                                 size, e)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _tensor_masks():
    lungs = MASKS["lungs"]
    rng = np.random.default_rng(3)
    frac = (lungs * rng.choice([0.5, 1.0, 2.0], SHAPE)).astype(np.float32)
    signed = (lungs.astype(np.int16) * 3 - (rng.random(SHAPE) < 0.1))
    return {"uint8": lungs, "bool": lungs.astype(bool), "float32": frac,
            "int16": signed.astype(np.int16)}


@pytest.mark.parametrize("dtype", ["uint8", "bool", "float32", "int16"])
def test_a_scan_given_as_tensors_bags_as_its_host_arrays(scan, edges, dtype):
    mask = _tensor_masks()[dtype]
    rois = [ROI((3, 4, 5), SIZE), ROI((20, 10, 12), SIZE),
            ROI((9, 15, 20), (5, 6, 7))]
    host = make_bag_device(scan, mask, SIGMAS, edges, rois, SPACING,
                           device="cpu")
    dev = make_bag_device(torch.from_numpy(scan), torch.from_numpy(mask),
                          SIGMAS, edges, rois, SPACING, device="cpu")
    np.testing.assert_array_equal(dev, host)
    hs, hr = _dense(scan, mask, edges)
    ds, dr = _dense(torch.from_numpy(scan), torch.from_numpy(mask), edges)
    assert torch.equal(ds, hs) and torch.equal(dr.nan_to_num(7.0),
                                               hr.nan_to_num(7.0))


def test_the_index_counts_each_boxs_masked_voxels(scan):
    mask = torch.from_numpy(MASKS["face"])
    index = dense_index(mask != 0, mask != 0, SIZE)
    want = [int(mask[r.slices()].ne(0).sum())
            for r in generate_dense_rois(MASKS["face"], SIZE)]
    assert index.totals.tolist() == want
    rel = index.starts - torch.tensor(index.lo)
    assert index.row_at[rel[:, 0], rel[:, 1], rel[:, 2]].tolist() == list(
        range(len(want)))
    assert int((index.row_at >= 0).sum()) == len(want)


def test_make_bag_dense_device_writes_the_host_routes_files(
        scan, edges, tmp_path, monkeypatch):
    monkeypatch.setenv("IFE_PLATFORM", "cpu")
    mask = MASKS["single"] | _ellipsoids(SHAPE, [(20, 18, 16)], (3, 4, 4))
    write_volume(str(tmp_path / "img.nii.gz"),
                 Volume.from_numpy(scan, spacing=SPACING))
    write_volume(str(tmp_path / "mask.nii.gz"),
                 Volume.from_numpy(mask, spacing=SPACING))
    write_hist_spec(str(tmp_path / "spec.txt"), edges)
    common = ["make-bag-dense", "-i", tmp_path / "img.nii.gz", "-m",
              tmp_path / "mask.nii.gz", "-b", tmp_path / "spec.txt", "-s",
              *SIGMAS, "--roi-size", "7,7,7"]
    assert t_main([str(a) for a in common + ["-o", tmp_path / "host"]]) == 0
    assert t_main([str(a) for a in common + ["-o", tmp_path / "dev",
                                             "--device"]]) == 0
    assert (tmp_path / "dev.ROIInfo").read_text() == (
        tmp_path / "host.ROIInfo").read_text()
    # the device's f32 frequencies are make_bag_device's, written alike, at
    # the spacing the CLI reads back (the NIfTI header's f32)
    rois = generate_dense_rois(mask, SIZE)
    spacing = read_volume(str(tmp_path / "img.nii.gz")).spacing
    write_matrix_csv(str(tmp_path / "want.bag"), make_bag_device(
        scan, mask, SIGMAS, edges, rois, spacing, device="cpu"))
    assert (tmp_path / "dev.bag").read_bytes() == (
        tmp_path / "want.bag").read_bytes()
    # the host route's f64 frequencies print alike to 6 significant digits
    # but where the f32 quotient rounds across the 6th digit: one unit of it
    got = np.loadtxt(tmp_path / "dev.bag", delimiter=",", ndmin=2)
    want = np.loadtxt(tmp_path / "host.bag", delimiter=",", ndmin=2)
    assert got.shape == want.shape == (len(rois), 8 * BINS * len(SIGMAS))
    assert len(rois) > 50 and np.abs(got - want).max() <= 1e-6 * (1 + 1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("blocks", [None, 1, 3])
def test_the_bag_csv_formats_each_value_to_6_significant_digits(
        tmp_path, dtype, blocks):
    # the writer formats a row in one `%`; each value as a format of its
    # own gives it (C++ ostream's default), from one array or from blocks
    rng = np.random.default_rng(9)
    bag = (rng.standard_normal((7, 11)) * 10.0 ** rng.integers(-9, 9, (7, 11))
           ).astype(dtype)
    bag[0, :8] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 1 / 3, 123456789]
    want = "".join(",".join(f"{float(v):.6g}" for v in row) + "\n"
                   for row in bag)
    src = bag if blocks is None else (
        bag[i:i + blocks] for i in range(0, len(bag), blocks))
    write_matrix_csv(str(tmp_path / "t.bag"), src)
    assert (tmp_path / "t.bag").read_text() == want
    write_matrix_csv(str(tmp_path / "e.bag"), iter([bag[:0], bag[:0]]))
    assert (tmp_path / "e.bag").read_text() == ""


# the extent of the starts (41^3 boxes) of a lung of the dense benchmark
# cell (ifebench's mil-bag-dense-4s.right-lung, seed 3900000001, slot 0)
BENCH_EXTENT = (151, 212, 303)


@pytest.mark.parametrize("size,bins,extent", [
    ((41, 41, 41), 32, BENCH_EXTENT), ((7, 9, 5), 6, (34, 28, 28)),
    ((41, 41, 41), 1, BENCH_EXTENT), ((41, 41, 41), 64, BENCH_EXTENT),
    ((41, 41, 41), 32, (5, 9, 3)), ((255, 3, 5), 32, (20, 90, 70)),
    ((41, 41, 41), 17, BENCH_EXTENT), ((41, 41, 41), 33, (40, 50, 60)),
    ((1, 1, 1), 64, (8, 200, 300)), ((255, 1, 128), 64, (4, 9, 40))])
def test_the_rows_plan_fits_a_block(size, bins, extent):
    plan = _rows_plan(bins, extent, size)
    _, sy, sz = size
    assert 0 < plan.smem <= 232448 and plan.per_sm == 1
    # every block counts all the bins, padded to quads of four
    assert plan.G == -(-bins // 4) * 4
    assert 1 <= plan.TY <= extent[1] and 1 <= plan.TZ <= extent[2]
    # one thread of the block's 1,024 stages each start of the tile
    assert plan.TY * plan.TZ <= 1024
    assert plan.col_updates == (plan.TY + sy - 1) * (plan.TZ + sz - 1) / (
        plan.TY * plan.TZ)


def test_the_rows_plan_at_the_benchmarks_shape():
    # 41^3 boxes and 32 bins: a 32 x 16 tile of starts, 72 x 56 footprint
    # columns of 32 u8 counts, 7.875 column updates a start and x plane
    plan = _rows_plan(32, BENCH_EXTENT, (41, 41, 41))
    assert (plan.G, plan.TY, plan.TZ, plan.smem) == (32, 32, 16, 213760)
    assert plan.col_updates == 72 * 56 / 512


def test_the_rows_plan_refuses_boxes_that_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        _rows_plan(64, (10, 10, 10), (1, 4000, 4000))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `python -m "
                    "pytest --noconftest -m gpu tests/test_torch_dense_bag.py`")
    return torch.device("cuda", 0)


# a volume whose starts of 41^3 boxes leave a ragged last tile of the rows
# kernel in y and in z (tiles of 64 or 32 starts)
RAGGED_SHAPE = (50, 146, 124)


def _card_inputs(mask_kind, bins, seed=4):
    shape = RAGGED_SHAPE if mask_kind == "ragged" else (96, 96, 80)
    rng = np.random.default_rng(seed)
    chans = [rng.standard_normal(shape).astype(np.float32) for _ in range(8)]
    chans[3].reshape(-1)[::101] = np.nan
    chans[5].reshape(-1)[::211] = -np.inf
    if mask_kind == "ellipsoid":
        mask = _ellipsoids(shape, [(48, 50, 38)], (36, 40, 33))
    else:
        mask = np.ones(shape, np.uint8)
    edges = np.stack([np.sort(rng.standard_normal(bins - 1)) for _ in range(8)])
    return chans, torch.from_numpy(mask) != 0, torch.from_numpy(
        edges.astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("size,bins", [((41, 41, 41), 32), ((7, 9, 5), 6),
                                       ((41, 41, 41), 17), ((41, 41, 41), 33)])
@pytest.mark.parametrize("mask_kind", ["ellipsoid", "ones", "ragged"])
def test_the_dense_kernels_equal_their_twin_to_the_bit(cuda, mask_kind, size,
                                                       bins):
    chans, w, e = _card_inputs(mask_kind, bins)
    index = dense_index(w, w, size)
    n = index.starts.shape[0]
    if mask_kind == "ragged":
        plan = _rows_plan(bins, index.row_at.shape, size)
        _, sy, sz = index.row_at.shape
        assert sy % plan.TY and sz % plan.TZ
    want = torch.empty((n, 8 * bins), dtype=torch.float32)
    dense_hist_rows([torch.from_numpy(c) for c in chans], w, index, size, e,
                    want)
    wc = w.to(cuda)
    index_c = dense_index(wc, wc, size)
    assert torch.equal(index_c.starts.cpu(), index.starts)
    assert torch.equal(index_c.totals.cpu(), index.totals)
    # a wider tensor: the rows land at a column offset of a longer row
    out = torch.full((n, 8 * bins + 12), -1.0, device=cuda)
    before = LAUNCHES["dense_hist"]
    dense_hist_rows([torch.from_numpy(c).to(cuda) for c in chans], wc, index_c,
                    size, e, out[:, 4:4 + 8 * bins])
    torch.cuda.synchronize(cuda)
    assert LAUNCHES["dense_hist"] - before == 1
    plan = _rows_plan(bins, index.row_at.shape, size)._asdict()
    assert {k: DENSE_HIST_PLAN[k] for k in plan} == plan
    got = out.cpu()
    assert torch.equal(got[:, :4], torch.full((n, 4), -1.0))
    assert torch.equal(got[:, 4 + 8 * bins:], torch.full((n, 8), -1.0))
    assert got[:, 4:4 + 8 * bins].numpy().tobytes() == want.numpy().tobytes()


def _card_scan(seed, shape=(64, 60, 56)):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal(shape) * 120.0 - 850.0).astype(np.float32)
    mask = _ellipsoids(shape, [(20 + seed % 5, 30, 28), (44, 30, 28)],
                       (12, 18, 16))
    return img, mask


@pytest.mark.gpu
def test_the_resident_bag_is_the_staged_bag_to_the_bit(cuda, edges):
    img, mask = _card_scan(1)
    rois = [ROI((3, 4, 5), (41, 41, 41)), ROI((20, 10, 12), (41, 41, 41)),
            ROI((9, 15, 2), (5, 6, 7))]
    host = make_bag_device(img, mask, SIGMAS, edges, rois, SPACING,
                           device=cuda)
    dev = make_bag_device(torch.from_numpy(img).to(cuda),
                          torch.from_numpy(mask).to(cuda), SIGMAS, edges, rois,
                          SPACING, device=cuda)
    assert dev.tobytes() == host.tobytes()


@pytest.mark.gpu
def test_dense_rows_on_the_card_are_make_bag_devices_bag(cuda, edges):
    img, mask = _card_scan(2)
    starts, rows = make_bag_dense_device(img, mask, SIGMAS, edges, SIZE,
                                         SPACING, device=cuda)
    rois = generate_dense_rois(mask, SIZE)
    assert starts.cpu().tolist() == [list(r.index) for r in rois]
    pick = np.sort(np.random.default_rng(6).choice(len(rois), 400,
                                                    replace=False))
    bag = make_bag_device(img, mask, SIGMAS, edges, [rois[j] for j in pick],
                          SPACING, device=cuda)
    got = rows[torch.from_numpy(pick).to(cuda)].cpu().double().numpy()
    assert got.tobytes() == bag.tobytes()


@pytest.mark.gpu
def test_two_dense_calls_in_a_row_do_not_share_rows(cuda, edges):
    a, b = _card_scan(3), _card_scan(4)
    tb = [torch.from_numpy(x).to(cuda) for x in b]
    sb, rb = make_bag_dense_device(*tb, SIGMAS, edges, SIZE, SPACING,
                                   device=cuda)
    rb = rb.cpu()
    ta = [torch.from_numpy(x).to(cuda) for x in a]
    sa, ra = make_bag_dense_device(*ta, SIGMAS, edges, SIZE, SPACING,
                                   device=cuda)
    sb2, rb2 = make_bag_dense_device(*tb, SIGMAS, edges, SIZE, SPACING,
                                     device=cuda)
    assert torch.equal(sb2.cpu(), sb.cpu())
    assert rb2.cpu().numpy().tobytes() == rb.numpy().tobytes()
    assert not torch.equal(sa.cpu(), sb.cpu())
    del ra

