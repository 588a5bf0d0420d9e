"""ife_tpu_torch's histograms on the CPU against ife_tpu's: the plain twin of
the CUDA histogram kernel (run by every wrapper for a CPU tensor) against
the Pallas kernel it replaces, run in interpret mode as tests/test_stats.py
runs it, and against histogram_counts_xla; the box form against
ife_tpu.roi.bag.roi_feature_histograms_device; the fine-grid and host
helpers against their ife_tpu twins. Counts are integers and frequencies
one f32 division of them, so every comparison is exact.

The CUDA kernel itself is tested on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.kernels import histogram as JH
from ife_tpu.roi.bag import roi_feature_histograms_device as j_roi_hist
from ife_tpu.stats import histogram as JS
from ife_tpu_torch import kernels as K
from ife_tpu_torch.kernels.histogram import _edges_f32_round_down
from ife_tpu_torch.roi.bag import roi_feature_histograms_device as t_roi_hist
from ife_tpu_torch.stats import histogram as TS

torch.set_num_threads(1)


def _values(rng, n, edges):
    """n f32 values: normal noise, with NaN, +-inf and every edge (as f32)
    planted at the front when n allows."""
    v = rng.standard_normal(n).astype(np.float32)
    plant = np.concatenate([[np.nan, np.inf, -np.inf],
                            np.asarray(edges, np.float32).ravel()])[:n]
    v[: plant.size] = plant
    return v


def _edges(rng, E, rows, f64, dup):
    """(rows, E) sorted edges; f64 edges are not f32 values (so they round
    down to f32), dup repeats a value in a run, as equalized specs do."""
    e = np.sort(rng.standard_normal((rows, E)), axis=1)
    if dup and E >= 4:
        e[:, 1:4] = e[:, 1:2]
    if not f64:
        e = e.astype(np.float32)
    return e


CASES = [  # (E, channels, per-channel edges, weighted, f64 edges, dup, n)
    (1, 1, False, False, False, False, 5000),
    (1, 3, True, True, True, False, 4099),
    (31, 1, False, True, True, True, 5000),
    (31, 3, False, False, False, True, 5000),
    (31, 3, True, True, True, True, 3 * 128),
    (31, 2, True, False, True, False, 0),
    (200, 1, False, True, True, True, 5000),
    (200, 2, True, False, False, True, 3001),
]


@pytest.mark.parametrize("E,C,per,weighted,f64,dup,n", CASES)
def test_twin_equals_pallas_kernel_interpret(E, C, per, weighted, f64, dup, n):
    rng = np.random.default_rng(E * 7 + C + n)
    e = _edges(rng, E, C if per else 1, f64, dup)
    e = e if per else e[0]
    chans = [_values(rng, n, e) for _ in range(C)]
    w = (rng.integers(0, 3, n).astype(np.int32) if weighted else None)
    got = K.histogram_counts_multi(
        [torch.from_numpy(c) for c in chans], torch.from_numpy(e),
        None if w is None else torch.from_numpy(w))
    want = JH.histogram_counts_multi(
        [jnp.asarray(c) for c in chans], jnp.asarray(e),
        None if w is None else jnp.asarray(w), interpret=True)
    assert got.dtype == torch.int32 and got.shape == (C, E + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if C == 1:
        one = K.histogram_counts_kernel(
            torch.from_numpy(chans[0]), torch.from_numpy(e),
            None if w is None else torch.from_numpy(w))
        want1 = JH.histogram_counts_pallas(
            jnp.asarray(chans[0]), jnp.asarray(e),
            None if w is None else jnp.asarray(w), interpret=True)
        np.testing.assert_array_equal(one.numpy(), np.asarray(want1))


@pytest.mark.parametrize("E", [0, 1, 31, 200])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("f64", [False, True])
def test_histogram_counts_equals_xla(E, weighted, f64):
    # the plain form compares in the promoted dtype, as the XLA form does:
    # f32 values against f64 edges in f64
    rng = np.random.default_rng(100 + E)
    e = _edges(rng, E, 1, f64, dup=True)[0]
    for n in (0, 4097):
        v = _values(rng, n, e)
        w = rng.integers(0, 4, n).astype(np.int32) if weighted else None
        tw = None if w is None else torch.from_numpy(w)
        jw = None if w is None else jnp.asarray(w)
        want = np.asarray(JS.histogram_counts_xla(jnp.asarray(v), jnp.asarray(e), jw))
        for fn in (TS.histogram_counts, TS.histogram_counts_plain):
            got = fn(torch.from_numpy(v), torch.from_numpy(e), tw)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n}")
        np.testing.assert_array_equal(
            want, np.asarray(JS.histogram_counts(jnp.asarray(v), jnp.asarray(e), jw)))


def test_histogram_counts_integer_values_equal_xla():
    v = np.arange(10007, dtype=np.int32) % 7
    e = np.asarray([0.0, 2.0, 2.0, 3.0, 5.5])
    got = TS.histogram_counts(torch.from_numpy(v), torch.from_numpy(e))
    want = JS.histogram_counts_xla(jnp.asarray(v), jnp.asarray(e))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_histogram_counts_equals_ife_tpu():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((4, 1000))
    e = np.sort(rng.standard_normal((4, 7)), axis=-1)
    w = rng.integers(0, 2, (4, 1000)).astype(np.int32)
    for weights in (None, w):
        got = TS.batched_histogram_counts(
            torch.from_numpy(v), torch.from_numpy(e),
            None if weights is None else torch.from_numpy(weights))
        want = JS.batched_histogram_counts(
            jnp.asarray(v), jnp.asarray(e),
            None if weights is None else jnp.asarray(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edges_round_down_equals_ife_tpu():
    rng = np.random.default_rng(3)
    e = np.concatenate([rng.standard_normal(500) * 1e3, [1e300, -1e300, 0.1,
                                                         np.inf, -np.inf]])
    got = _edges_f32_round_down(torch.from_numpy(e))
    want = JH._edges_f32_round_down(jnp.asarray(e))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.double().numpy() <= e).all()
    f32 = torch.from_numpy(e[:500].astype(np.float32))
    assert _edges_f32_round_down(f32) is f32


@pytest.mark.parametrize("edges", [[1.0, np.nan], [2.0, 1.0], [[0.0, 1.0], [1.0, 0.5]]])
def test_wrappers_refuse_unsorted_or_nan_edges(edges):
    e = torch.tensor(edges, dtype=torch.float64)
    C = e.shape[0] if e.dim() == 2 else 1
    with pytest.raises(ValueError, match="edges"):
        K.histogram_counts_multi([torch.zeros(5)] * C, e)
    if e.dim() == 1:
        with pytest.raises(ValueError, match="edges"):
            TS.histogram_counts(torch.zeros(5), e)


# ---------------------------------------------------------------------------
# the box form against ife_tpu's per-ROI device binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_box_twin_equals_roi_feature_histograms_device(dtype):
    rng = np.random.default_rng(5)
    shape, size = (14, 13, 12), (5, 4, 6)
    chans = [rng.standard_normal(shape).astype(dtype) for _ in range(3)]
    chans[1][0, 0, :3] = [np.nan, np.inf, -np.inf]
    mask = (rng.uniform(size=shape) > 0.3).astype(np.uint8)
    mask[9:, 9:, 6:] = 0  # the last box has no masked voxel: a NaN row
    starts = np.asarray([[0, 0, 0], [3, 5, 2], [9, 9, 6], [9, 9, 6]])
    edges = np.sort(rng.standard_normal((3, 9)), axis=1)
    edges[:, 2:5] = edges[:, 2:3]
    e_dev = (np.asarray(_edges_f32_round_down(torch.from_numpy(edges)))
             if dtype == np.float32 else edges)

    counts = K.histogram_boxes([torch.from_numpy(c) for c in chans],
                               torch.from_numpy(mask), starts, size,
                               torch.from_numpy(edges))
    assert counts.shape == (4, 3, 10) and counts.dtype == torch.int32
    for b, (x, y, z) in enumerate(starts):
        sl = np.s_[x:x + size[0], y:y + size[1], z:z + size[2]]
        for c in range(3):
            want = np.asarray(JS.histogram_counts_xla(
                jnp.asarray(chans[c][sl]), jnp.asarray(e_dev[c]),
                jnp.asarray(mask[sl])))
            np.testing.assert_array_equal(counts[b, c].numpy(), want)

    got = t_roi_hist(tuple(torch.from_numpy(c) for c in chans),
                     torch.from_numpy(mask), starts, torch.from_numpy(e_dev),
                     size)
    want = j_roi_hist(tuple(jnp.asarray(c) for c in chans), jnp.asarray(mask),
                      jnp.asarray(starts), jnp.asarray(e_dev), size)
    assert got.dtype == torch.float32
    assert np.isnan(got[3].numpy()).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # NaN == NaN here
    stacked = t_roi_hist(torch.from_numpy(np.stack(chans, -1)),
                         torch.from_numpy(mask), starts,
                         torch.from_numpy(e_dev), size)
    np.testing.assert_array_equal(stacked.numpy(), got.numpy())


def test_box_starts_clamp_like_dynamic_slice():
    # lax.dynamic_slice clamps a start so the slice fits; so does the port
    rng = np.random.default_rng(6)
    ch = rng.standard_normal((8, 8, 8)).astype(np.float32)
    e = np.asarray([[-0.5, 0.0, 0.5]])
    got = K.histogram_boxes([torch.from_numpy(ch)], None, [[6, -2, 7]],
                            (4, 4, 4), torch.from_numpy(e))
    want = K.histogram_counts_multi([torch.from_numpy(ch[4:8, 0:4, 4:8])],
                                    torch.from_numpy(e[0]))
    np.testing.assert_array_equal(got[0].numpy(), want.numpy())
    with pytest.raises(ValueError, match="exceeds"):
        K.histogram_boxes([torch.from_numpy(ch)], None, [[0, 0, 0]],
                          (9, 1, 1), torch.from_numpy(e))


# ---------------------------------------------------------------------------
# fine grid and host helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(-1000.0, 500.0), (0.0, 1.0), (-3.5e-4, 2.1e-4),
                                   (1e6, 2e6), (-7.25, -7.0), (0.0, 1e-30),
                                   (1e8, 1e8 + 1.0), (2.0, 2.0)])
def test_snap_pow2_grid_equals_ife_tpu(lo, hi):
    got, want = TS.snap_pow2_grid(lo, hi, 4096), JS.snap_pow2_grid(lo, hi, 4096)
    if want is None:
        assert got is None
        return
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("lo,hi,n_fine,n", [
    (-1000.0, 500.0, 4096, 50_000), (1.0e5, 1.3e5, 4096, 30_000),
    (-9.0, -2.0, 256, 20_000), (0.0, 1.0, 64, 10_000), (-2.0e-3, 1.0e-3, 4096, 0),
])
def test_uniform_histogram_counts_equals_ife_tpu(lo, hi, n_fine, n):
    rng = np.random.default_rng(21)
    m, k, bounds = TS.snap_pow2_grid(lo, hi, n_fine)
    v = rng.uniform(lo, hi, size=n).astype(np.float32)
    v[: n_fine + 1] = bounds.astype(np.float32)[: min(n, n_fine + 1)]
    if n:
        v[-2:] = [np.float32(lo), np.float32(hi)]
    w01 = (rng.uniform(size=n) > 0.3).astype(np.int32)
    got = TS.uniform_histogram_counts(torch.from_numpy(v), torch.from_numpy(w01),
                                      m, np.ldexp(1.0, k), n_fine)
    want = JS.uniform_histogram_counts(jnp.asarray(v), jnp.asarray(w01),
                                       jnp.float32(m), jnp.float32(np.ldexp(1.0, k)),
                                       n_fine)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_histogram_equals_ife_tpu():
    rng = np.random.default_rng(4)
    edges = [1, 2.5, 3.0, 3.0, 4.7, 6.2, 8.3]
    v = rng.uniform(-1, 10, 3000)
    w = rng.integers(0, 3, 3000)
    t, j = TS.DenseHistogram(edges), JS.DenseHistogram(edges)
    for h in (t, j):
        h.insert(2.5)
        h.insert_many(v)
        h.insert_many(v[:100], weights=w[:100])
    np.testing.assert_array_equal(t.get_counts(), j.get_counts())
    np.testing.assert_array_equal(t.get_frequencies(), j.get_frequencies())
    assert str(t) == str(j) and t.num_bins == j.num_bins
    t.reset_counts()
    j.reset_counts()
    np.testing.assert_array_equal(t.get_frequencies(), j.get_frequencies())


# ---------------------------------------------------------------------------
# the kernel's host side: its plan and its edge preparation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,E,form", [
    (8, 31, (True, 8, 256)),      # config 4: edges and 8 bin copies shared
    (1, 4096, (True, 1, 256)),    # one fine channel: one copy beside 8192
    (8, 4096, (False, 1, 1024)),  # the bins alone fit: edges through L1
    (64, 4096, (False, 0, 256)),  # the bins alone exceed a block: global
])
def test_plan_picks_the_form_from_the_table_sizes(C, E, form):
    from ife_tpu_torch.kernels.histogram import _SMEM_MAX, _TILE, _plan

    n = 512 ** 3
    p = _plan(C, E, n)
    assert tuple(p[:3]) == form
    # no more blocks a box than there are tiles for its warps
    assert p.blocks_per_box == -(-(n // _TILE) // (p.threads // 32))
    assert _plan(C, E, 1000).blocks_per_box == 1
    # the table a block keeps never exceeds the shared memory it may take
    for smem in (_SMEM_MAX, 48 * 1024):
        q = _plan(C, E, n, smem=smem)
        assert 4 * C * E * q.edges_shared + 4 * C * (E + 1) * q.copies <= smem


@pytest.mark.parametrize("kind", ["up", "down", "exact"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_host_edges_round_down_like_ife_tpu(kind, per_channel):
    # f64 edges whose nearest f32 lies above them (rounding to nearest would
    # round UP), below them, or that are f32 values: all must come out as
    # the largest f32 <= e, as ife_tpu's _edges_f32_round_down gives them
    from ife_tpu_torch.kernels.histogram import _host_edges

    rng = np.random.default_rng(11)
    f = np.sort(rng.standard_normal(40).astype(np.float32) * 500)
    ulp = np.spacing(f).astype(np.float64)
    e = f.astype(np.float64) + {"up": -0.25, "down": 0.25, "exact": 0.0}[kind] * ulp
    e = np.stack([e, e + 1.0, e * 2.0]) if per_channel else e
    got = _host_edges("t", torch.from_numpy(e), 3)
    want = np.asarray(JH._edges_f32_round_down(jnp.asarray(e)))
    want = np.broadcast_to(want, (3, 40))
    assert got.dtype == np.float32 and got.shape == (3, 40)
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _edges_f32_round_down(
        torch.from_numpy(np.broadcast_to(e, (3, 40)).copy())).numpy())
    assert (got.astype(np.float64) <= np.broadcast_to(e, (3, 40))).all()
    if kind == "exact":
        np.testing.assert_array_equal(got[0], f)


def _record_check_edges(monkeypatch):
    from ife_tpu_torch.kernels import histogram as H

    seen = []
    real = H.check_edges

    def record(name, edges):
        seen.append((name, edges.device.type))
        return real(name, edges)

    monkeypatch.setattr(H, "check_edges", record)
    return seen


@pytest.mark.parametrize("entry", ["histogram_counts_multi", "histogram_boxes",
                                   "masked_fine_histograms_multi"])
def test_edges_are_checked_on_the_host_before_they_move(monkeypatch, entry):
    # every histogram path checks its edges while they lie on the host: the
    # check sees only CPU tensors, and refuses edges on a device rather than
    # copying them back
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.kernels import histogram as H

    seen = _record_check_edges(monkeypatch)
    rng = np.random.default_rng(12)
    vol = [torch.from_numpy(rng.standard_normal((16, 16, 16)).astype(np.float32))
           for _ in range(3)]
    mask = torch.from_numpy((rng.uniform(size=(16, 16, 16)) > 0.4).astype(np.uint8))
    e = np.sort(rng.standard_normal((3, 9)), axis=1)
    if entry == "histogram_counts_multi":
        K.histogram_counts_multi(vol, torch.from_numpy(e), mask)
        K.histogram_counts_multi(vol, e[0], mask)
    elif entry == "histogram_boxes":
        K.histogram_boxes(vol, mask, [[0, 0, 0], [3, 4, 5]], (5, 5, 5),
                          torch.from_numpy(e))
    else:
        mesh = P.make_mesh(4, ("x",), device="cpu")
        P.masked_fine_histograms_multi(
            [P.shard_volume(v.numpy(), mesh) for v in vol],
            P.shard_volume(mask.numpy(), mesh), mesh, n_fine=64)
    assert seen and all(dev == "cpu" for _, dev in seen)
    with pytest.raises(ValueError, match="host"):
        H.check_edges("t", torch.empty(4, device="meta"))
