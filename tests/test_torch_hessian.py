"""The Hessian kernel's two eigen paths on the CPU, against ife_tpu.

ife_tpu.ops.features.hessian_eig_features (what ife_tpu's hessian-features
CLI writes without --fused) is eigenvalue_features(hessian(...)): the trig
eigen path with the reference's exact diagonal branch. The Pallas kernel
(fused_hessian_eig, --fused) and its CUDA port's default output compute the
polynomial path without the diagonal branch, which orders tied eigenvalues
otherwise: where |e1| = |e2| with opposite signs (f = i^2 - j^2, integer
CT) the two swap e1 and e2. The port's hessian_eig_features_channels runs
the kernel's reference output on the card; its twin
hessian_eig_reference_plain is held here against ife_tpu per channel, not
as value-sorted triples, which would hide the swap.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.ops import features as JF
from ife_tpu_torch import kernels as K
from ife_tpu_torch.kernels.hessian_eig import with_shard_halo
from ife_tpu_torch.ops import features as TF

torch.set_num_threads(1)

UNIT = (1.0, 1.0, 1.0)
SPACING = (0.78, 0.78, 1.0)


def _square_difference():
    """f = i^2 - j^2 on 12 x 11 x 10: its Hessian is diag(2, -2, 0) inside,
    a tie of |e1| and |e2| with opposite signs at every interior voxel."""
    i, j, _ = np.meshgrid(np.arange(12), np.arange(11), np.arange(10),
                          indexing="ij")
    return (i * i - j * j).astype(np.float64)


def _integer_ties():
    """A sum of random small integer profiles along x, y and z: integer
    Hessians with no cross terms, whose diagonals tie in |.| at many voxels
    (|Dxx| = |Dyy|, either sign), as integer-valued CT gives. Ties of a
    matrix with cross terms are left out: there the order of two equal
    |eigenvalues| is the rounding of either path, in f64 as in f32."""
    rng = np.random.default_rng(11)
    a, b, c = (rng.integers(-3, 4, n) for n in (19, 17, 24))
    return (a[:, None, None] + b[None, :, None]
            + c[None, None, :]).astype(np.float64)


VOLUMES = {"i^2 - j^2": _square_difference, "integer ties": _integer_ties}


def _channels(feats):
    """(X, Y, Z, 6) ife_tpu features or a tuple of six -> (6, X, Y, Z)."""
    if isinstance(feats, (tuple, list)):
        return np.stack([np.asarray(c) for c in feats])
    return np.moveaxis(np.asarray(feats), -1, 0)


def _per_channel_rel(got, want):
    """Per channel max|got - want| / max(max|want|, 1), channels in order."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return [np.abs(g - w).max() / max(np.abs(w).max(), 1.0)
            for g, w in zip(got, want)]


def test_the_reference_path_gives_ife_tpus_order_at_i2_minus_j2():
    f = _square_difference()
    want = _channels(JF.hessian_eig_features(jnp.asarray(f), UNIT))
    assert list(want[:3, 5, 5, 5]) == [-2.0, 2.0, 0.0]
    x = torch.from_numpy(f)
    ref = _channels(K.hessian_eig_reference_plain(x, UNIT))
    assert list(ref[:3, 5, 5, 5]) == [-2.0, 2.0, 0.0]
    # the kernel's default output swaps the two: (2, -2, 0)
    poly = _channels(K.hessian_eig_plain(x, UNIT))
    assert poly[0, 5, 5, 5] == pytest.approx(2.0)
    assert poly[1, 5, 5, 5] == pytest.approx(-2.0)
    # the route of the hessian-features CLI is the reference's
    got = _channels(TF.hessian_eig_features_channels(x, UNIT))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("volume", sorted(VOLUMES))
@pytest.mark.parametrize("spacing", [UNIT, SPACING])
def test_the_kernels_polynomial_path_is_not_ife_tpus_function(volume, spacing):
    # the fault: held per channel, the polynomial path differs from
    # ife_tpu's hessian_eig_features at the ties (and agrees as sorted
    # triples, which is why a sorted comparison missed it)
    f = VOLUMES[volume]()
    want = _channels(JF.hessian_eig_features(jnp.asarray(f), spacing))
    poly = _channels(K.hessian_eig_plain(torch.from_numpy(f), spacing))
    # e1 and e2 apart by more than rounding: 84 % of the voxels of
    # i^2 - j^2, 2-7 % of the integer profiles
    swapped = (np.abs(poly[:2] - want[:2]) > 1e-3).any(0)
    assert swapped.mean() > 0.01, swapped.mean()
    scale = np.abs(want[:3]).max()
    assert np.abs(np.sort(poly[:3], 0) - np.sort(want[:3], 0)).max() <= (
        1e-6 * scale)


@pytest.mark.parametrize("volume", sorted(VOLUMES))
@pytest.mark.parametrize("spacing", [UNIT, SPACING])
@pytest.mark.parametrize("mode", ["whole", "x_halo", "pre_padded"])
def test_the_reference_twin_is_ife_tpus_function_in_f64(volume, spacing, mode):
    # per channel at <= 1e-12, in the shard modes as with_shard_halo builds
    # them: the core of the volume with its neighbour rows, or the volume as
    # a block that carries its one-voxel layer
    f = VOLUMES[volume]()
    want = _channels(JF.hessian_eig_features(jnp.asarray(f), spacing))
    x = torch.from_numpy(f)
    if mode == "x_halo":
        got = with_shard_halo(lambda v: K.hessian_eig_reference_plain(
            v, spacing), x[1:-1], (x[:1], x[-1:]), False)
        want = want[:, 1:-1]
    elif mode == "pre_padded":
        got = with_shard_halo(lambda v: K.hessian_eig_reference_plain(
            v, spacing), x, None, True)
        want = want[:, 1:-1, 1:-1]
    else:
        got = K.hessian_eig_reference_plain(x, spacing)
    assert max(_per_channel_rel(_channels(got), want)) <= 1e-12


@pytest.mark.parametrize("volume", sorted(VOLUMES))
@pytest.mark.parametrize("spacing", [UNIT, SPACING])
def test_the_reference_twin_in_f32_is_as_close_as_ife_tpus_f32(volume,
                                                               spacing):
    # per channel, no farther from ife_tpu's f64 result than ife_tpu's own
    # f32 path, up to a factor 2 (the criterion of
    # test_torch_features.py's test_hessian_eig_f32_as_accurate_as_ife_tpu)
    f = VOLUMES[volume]()
    want = _channels(JF.hessian_eig_features(jnp.asarray(f), spacing))
    j32 = _per_channel_rel(_channels(JF.hessian_eig_features(
        jnp.asarray(f, jnp.float32), spacing)), want)
    got = _channels(K.hessian_eig_reference_plain(
        torch.from_numpy(f).float(), spacing))
    e32 = _per_channel_rel(got, want)
    assert all(e <= max(2 * j, 1e-6) for e, j in zip(e32, j32)), (e32, j32)


def test_the_reference_entry_runs_its_twin_on_the_cpu():
    x = torch.from_numpy(_integer_ties()).float()
    before = dict(K.LAUNCHES)
    got = K.hessian_eig_reference_features(x, SPACING)
    assert isinstance(got, tuple) and len(got) == 6
    assert all(torch.equal(g, w) for g, w in
               zip(got, K.hessian_eig_reference_plain(x, SPACING)))
    assert dict(K.LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel or plain path"):
        K.hessian_eig_reference_features(x.to("meta"))


# ---------------------------------------------------------------------------
# the launch of csrc/hessian_eig.cu (kernels.hessian_plan), its index math
# transliterated to numpy
# ---------------------------------------------------------------------------

# the shapes of tests/test_torch_features.py (SHAPES) and
# tests/test_torch_gpu.py (THIN: Z = 1, X = 3, Y = 2 among them), one voxel
# over a block on y (9 = 8 + 1) and on z (129 = 128 + 1; 132 with Z % 4 == 0)
PLAN_SHAPES = [(16, 16, 16), (13, 12, 11), (5, 40, 33), (40, 9, 33),
               (23, 17, 1), (3, 2, 70), (140, 15, 35), (9, 9, 129),
               (4, 17, 132), (2, 1, 4), (1, 3, 8)]
MODES = ("whole", "x_halo", "pre_padded")


def _threads(plan, Y):
    """(x, y, zr, lane) of every thread of the launch whose warp runs (a
    warp whose row is past Y returns at once)."""
    gz, gy, gx = plan.grid
    bz, by, bx, w, lane = (a.ravel() for a in np.meshgrid(
        np.arange(gz), np.arange(gy), np.arange(gx),
        np.arange(plan.threads // 32), np.arange(32), indexing="ij"))
    y = by * plan.tile_y + w
    zr = bz * plan.tile_z + plan.run * lane
    keep = y < Y
    return bx[keep], y[keep], zr[keep], lane[keep]


def _source_rows(mode, X, Y, x, y):
    """PlaneSource::base and row_offset: for neighbour row (a, b) of the
    threads' rows, (source, plane, row) arrays; source 0 is s, 1 lo, 2 hi."""
    rows = {}
    for a in range(3):
        xp = x + a - 1
        for b in range(3):
            yy = y + b - 1
            if mode == "pre_padded":
                src, plane, row = np.zeros_like(xp), xp + 1, yy + 1
            else:
                plane = np.clip(xp, 0, X - 1)
                row = np.clip(yy, 0, Y - 1)
                src = np.zeros_like(xp)
                if mode == "x_halo":
                    src = np.where(xp < 0, 1, np.where(xp >= X, 2, 0))
                    plane = np.where(src == 0, plane, 0)
            rows[a, b] = (src, plane, row)
    return rows


def _columns(Z, zr, lane, wide, run):
    """The z columns a thread reads, (threads, run + 2): c = 0 .. run + 1
    holds z - 1 + c. wide (load_rows_wide): the run's 16-byte load at
    zc = min(zr, Z - run), the rims from the neighbouring lanes' loads
    (__shfl), a load at a warp's ends and the clamp at the volume's; else
    (load_rows_clamped) each column clamped."""
    if not wide:
        return np.clip(zr[:, None] - 1 + np.arange(run + 2), 0, Z - 1)
    zc = np.minimum(zr, Z - run)
    cols = np.empty((len(zr), run + 2), dtype=np.int64)
    cols[:, 1:run + 1] = zc[:, None] + np.arange(run)
    # the neighbouring lane of the same warp holds the thread's zr -+ run:
    # its zc is min(zr -+ run, Z - run)
    left = np.minimum(zr - run, Z - run) + run - 1
    right = np.minimum(zr + run, Z - run)
    left = np.where(lane == 0, np.where(zc == 0, zc, zc - 1), left)
    end = (lane == 31) | (zc + run >= Z)
    right = np.where(end, np.where(zc + run < Z, zc + run, zc + run - 1),
                     right)
    cols[:, 0], cols[:, run + 1] = left, right
    return cols


def _emulate(mode, s, lo, hi, wide):
    """The kernel's neighbourhood reads for every voxel it writes, from the
    transliterated index math: (voxel coordinates, r values (3, 3, 3) per
    voxel, write count per core voxel, every (source, plane, row, column)
    read)."""
    X, Y, Z = s.shape
    if mode == "pre_padded":
        X, Y = X - 2, Y - 2
    plan = K.hessian_plan(X, Y, Z)
    x, y, zr, lane = _threads(plan, Y)
    rows = _source_rows(mode, X, Y, x, y)
    cols = _columns(Z, zr, lane, wide, plan.run)
    sources = (s, lo, hi)
    reads, vals = [], {}
    for (a, b), (src, plane, row) in rows.items():
        use = slice(None) if (a == 1 or b == 1) else slice(1, plan.run + 1)
        c = cols[:, use]
        reads.append((np.repeat(src, c.shape[1]), np.repeat(plane, c.shape[1]),
                      np.repeat(row, c.shape[1]), c.ravel()))
        v = np.full(cols.shape, np.nan)
        for k, arr in enumerate(sources):
            if arr is None:
                continue
            on = src == k
            v[on, use] = arr[plane[on, None], row[on, None], c[on]]
        vals[a, b] = v
    writes = np.zeros((X, Y, Z), dtype=np.int64)
    got = []
    coords = []
    for j in range(plan.run):
        z = zr + j
        on = z < Z
        np.add.at(writes, (x[on], y[on], z[on]), 1)
        r = np.stack([np.stack([vals[a, b][on][:, j:j + 3] for b in range(3)],
                               1) for a in range(3)], 1)
        got.append(r)
        coords.append(np.stack([x[on], y[on], z[on]], 1))
    return (np.concatenate(coords), np.concatenate(got), writes,
            tuple(np.concatenate(p) for p in zip(*reads)))


def _extended(mode, s, lo, hi):
    """The (X + 2, Y + 2, Z + 2) neighbourhood every core voxel's stencil
    reads, from the twins' definitions (with_shard_halo): the clamp of the
    whole volume, the halo rows on x, or the layer on x and y; z clamped."""
    if mode == "x_halo":
        s = np.concatenate([lo, s, hi], 0)
    elif mode == "whole":
        s = np.pad(s, ((1, 1), (0, 0), (0, 0)), mode="edge")
    if mode != "pre_padded":
        s = np.pad(s, ((0, 0), (1, 1), (0, 0)), mode="edge")
    return np.pad(s, ((0, 0), (0, 0), (1, 1)), mode="edge")


@pytest.mark.parametrize("shape,wide", [
    (shape, wide) for shape in PLAN_SHAPES
    for wide in ((True, False) if shape[2] % 4 == 0 else (False,))])
@pytest.mark.parametrize("mode", MODES)
def test_the_launch_reads_the_twins_neighbourhood_and_writes_each_voxel_once(
        shape, wide, mode):
    # wide: 16-byte rows (Z % 4 == 0, aligned pointers); else scalar columns
    X, Y, Z = shape
    full = (X + 2, Y + 2, Z) if mode == "pre_padded" else shape
    # distinct values, so that a read from the wrong place shows
    s = np.arange(np.prod(full), dtype=np.float64).reshape(full)
    lo = hi = None
    if mode == "x_halo":
        lo = -1.0 - np.arange(Y * Z, dtype=np.float64).reshape(1, Y, Z)
        hi = lo - Y * Z
    coords, got, writes, (src, plane, row, col) = _emulate(mode, s, lo, hi,
                                                           wide)
    # every core voxel written exactly once
    assert np.all(writes == 1)
    # the reads stay inside their sources: x_halo reads the planes -1 and X
    # from lo / hi alone, pre_padded stays inside (X + 2, Y + 2, Z)
    assert col.min() >= 0 and col.max() <= Z - 1
    if mode == "pre_padded":
        assert np.all(src == 0)
        assert plane.min() >= 0 and plane.max() <= X + 1
        assert row.min() >= 0 and row.max() <= Y + 1
    else:
        assert row.min() >= 0 and row.max() <= Y - 1
        assert plane.min() >= 0 and plane.max() <= X - 1
        assert mode == "x_halo" or np.all(src == 0)
        if mode == "x_halo":
            # every voxel of planes 0 and X - 1 reads its halo row
            assert np.any(src == 1) and np.any(src == 2)
            assert np.all(plane[src > 0] == 0)
    # each voxel's 19 neighbours are those of the twin's definition
    ext = _extended(mode, s, lo, hi)
    x, y, z = coords.T
    a, b, c = np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                          indexing="ij")
    want = ext[x[:, None, None, None] + a, y[:, None, None, None] + b,
               z[:, None, None, None] + c]
    corner = (a != 1) & (b != 1) & (c != 1)
    assert np.array_equal(got[:, ~corner], want[:, ~corner])


@pytest.mark.parametrize("shape", [(512, 512, 512), (514, 514, 512)]
                         + PLAN_SHAPES)
def test_the_plan_covers_the_core_once(shape):
    # the grid's blocks tile the core: ceil(Z / tile_z) x ceil(Y / tile_y)
    # x X blocks of tile_y rows of 32 runs, none of them past the core by
    # a whole block, within CUDA's grid limits and a block's 1024 threads
    X, Y, Z = shape
    p = K.hessian_plan(X, Y, Z)
    gz, gy, gx = p.grid
    assert p.threads == 32 * p.tile_y <= 1024 and p.tile_z == 32 * p.run
    assert gx == X and (gy - 1) * p.tile_y < Y <= gy * p.tile_y
    assert (gz - 1) * p.tile_z < Z <= gz * p.tile_z
    assert gy <= 65535 and gx <= 65535


def test_the_plan_mirrors_the_kernel_source():
    # HESSIAN_TILE against csrc/hessian_eig.cu's constants, which the
    # launcher's grid is computed from; the kernel takes no shared memory
    # (a block's 227 KB bound nothing)
    import re

    from ife_tpu_torch.kernels import _build
    from ife_tpu_torch.kernels.hessian_eig import HESSIAN_TILE

    text = (_build.CSRC / "hessian_eig.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert int(consts["kRun"]) == HESSIAN_TILE["run"]
    assert int(consts["kTileY"]) == HESSIAN_TILE["tile_y"]
    assert consts["kTileZ"] == "32 * kRun"
    assert consts["kThreads"] == "32 * kTileY"
    assert HESSIAN_TILE["tile_z"] == 32 * HESSIAN_TILE["run"]
    assert HESSIAN_TILE["threads"] == 32 * HESSIAN_TILE["tile_y"]
    assert "__shared__" not in text
