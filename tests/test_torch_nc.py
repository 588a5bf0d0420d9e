"""The geometry of csrc/normalized_conv.cu on the CPU: its kernels' staging
and walks transliterated to torch, held to the plain twins and to ife_tpu.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py). What can go wrong in their index math — a clamped halo
staged at the wrong place, a ring slot read before it is loaded, a tap
group that stops one step early, a read past a block's shared memory, a
chunk of the z pass staged after a neighbour's outputs overwrote it — is
transliterated here, step for step, from the source:

  * the x / y pass (fir_axis_kernel): a block stages kAxisTileA + 2r
    positions along the axis for kAxisTileZ columns at clamped positions
    (c*f rounded once for the weighted pair), each thread walks kAxisRun
    outputs taps outer over a ring of kAxisRun registers (ring_walk: the
    first group, full groups, a guarded tail);
  * the z pass (fir_z_kernel): z_plan's rows and chunks, each chunk staged
    with its clamped halo, four outputs a thread from 16-byte reads of four
    inputs and four taps (z_group), the next chunk staged before this one's
    outputs are written (in place, or into out = num with the divide);
  * the entries: nc as the x pair, two single y passes and the z divide;
    smooth_yz / smooth_xz as the y / x pair and the z pass in place.

In f32 each emulation equals its twin (normalized_conv_plain,
smooth_yz_plain, smooth_xz_plain) to the bit, NaN where the twin has NaN;
every staged read is checked to lie inside the block's staged inputs. In
f64 the emulated nc is held to ife_tpu's fused_normalized_conv_sweep in
interpret mode within 1e-9 inside the mask (tests/test_torch_multiscale.py's
tolerance for the tiled entry).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu.kernels import fused as JF
from ife_tpu_torch import kernels as K
from ife_tpu_torch.kernels.normalized_conv import (
    MAX_RADIUS, Z_RUN, Z_SMEM, Z_THREADS, z_plan,
)
from ife_tpu_torch.ops.stencil import smooth_taps

torch.set_num_threads(1)

# csrc/normalized_conv.cu: the x / y tile, and the outputs a thread makes
# of each array, by the number of arrays
AXIS_TILE_A, AXIS_TILE_Z, AXIS_RUN = 128, 32, {1: 16, 2: 8}
SPACING = (0.7, 0.9, 1.2)
TOL = 1e-9


def _spacing(radii, sigma=1.0):
    """Per-axis spacing at which `sigma` has the radii `radii`."""
    sp = tuple(4.5 * sigma / (r - 0.5) for r in radii)
    assert tuple(smooth_taps(sigma, h)[1] for h in sp) == tuple(radii)
    return sp


def _inputs(shape, seed=3, dtype=np.float32):
    img = np.array(j_synthetic_ct(shape, seed=seed, dtype=jnp.float64).data)
    mask = np.array(j_sphere_mask(shape, 0.45).data).astype(np.float64)
    return (torch.from_numpy(img.astype(dtype)),
            torch.from_numpy(mask.astype(dtype)))


def _taps(sigma, h, dtype):
    taps, r = smooth_taps(sigma, h)
    return torch.tensor(taps, dtype=dtype), r


def _same(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


# ---------------------------------------------------------------------------
# the x / y pass
# ---------------------------------------------------------------------------

def _ring_walk(col, t, nt, run, n_arrays):
    """ring_walk: `run` outputs of each array, taps outer, inputs through a
    ring of `run` slots (slot m % run holds input m)."""
    w = [[None] * run for _ in range(n_arrays)]
    acc = [[None] * run for _ in range(n_arrays)]
    for a in range(n_arrays):
        for m in range(run - 1):
            w[a][m] = col(a, m)

    def group(k, first, guard):
        for j in range(run):
            if guard and k + j >= nt:
                break
            for a in range(n_arrays):
                w[a][(j + run - 1) % run] = col(a, k + j + run - 1)
                for u in range(run):
                    p = t[k + j] * w[a][(j + u) % run]
                    acc[a][u] = p if first and j == 0 else acc[a][u] + p

    if nt < run:
        group(0, True, True)
        return acc
    group(0, True, False)
    k = run
    while k + run <= nt:
        group(k, False, False)
        k += run
    if k < nt:
        group(k, False, True)
    return acc


def _axis_pass(arrays, axis, t, r, weighted):
    """fir_axis_kernel on (X, Y, Z) tensors: `arrays` is (f, c) for the
    weighted pair (outputs G*(c*f), G*c), else one or two arrays smoothed
    as they are."""
    TA, TZ, RUN = AXIS_TILE_A, AXIS_TILE_Z, AXIS_RUN[len(arrays)]
    nt, rows = 2 * r + 1, AXIS_TILE_A + 2 * r
    v = [a.movedim(axis, 0) for a in arrays]  # (n, other, Z)
    n, _, Z = v[0].shape
    outs = [torch.full_like(v[0], float("nan")) for _ in v]
    for a0 in range(0, n, TA):
        pos = (a0 - r + torch.arange(rows)).clamp(0, n - 1)
        for z0 in range(0, Z, TZ):
            zs = z0 + torch.arange(TZ)
            live = zs < Z
            staged = [torch.where(live, x[pos][:, :, zs.clamp(max=Z - 1)],
                                  torch.zeros((), dtype=x.dtype))
                      for x in v]  # (rows, other, TZ)
            if weighted:
                staged = [staged[0] * staged[1], staged[1]]
            for i0 in range(0, TA, RUN):
                if a0 + i0 >= n:
                    continue

                def col(a, i, i0=i0):
                    assert 0 <= i0 + i < rows  # inside the block's tile
                    return staged[a][i0 + i]

                acc = _ring_walk(col, t, nt, RUN, len(v))
                for u in range(RUN):
                    if a0 + i0 + u < n:
                        for o, ac in zip(outs, acc):
                            o[a0 + i0 + u, :, z0:z0 + TZ] = ac[u][:, live]
    return [o.movedim(0, axis) for o in outs]


# ---------------------------------------------------------------------------
# the z pass
# ---------------------------------------------------------------------------

def _z_group(pn, pd, t, k, nt, q0, first, guard, an, ad):
    """z_group: steps k .. k + 3 from the quads in[k .. k + 7]."""
    q1 = (pn(k + 4), pd(k + 4))
    tq = t[k:k + 4]
    for s, (v0, v1), acc in ((0, (q0[0], q1[0]), an), (1, (q0[1], q1[1]), ad)):
        vals = list(v0) + list(v1)
        for j in range(4):
            if guard and k + j >= nt:
                break
            for u in range(Z_RUN):
                p = tq[j] * vals[j + u]
                acc[u] = p if first and j == 0 else acc[u] + p
    return q1


def _z_pass(num, den, t, r, divide):
    """fir_z_kernel with z_plan's geometry, out aliasing num as in
    ife_normalized_conv; returns the output (divide) or (num, den)."""
    X, Y, Z = num.shape
    gn, gd = num.reshape(-1, Z).clone(), den.reshape(-1, Z).clone()
    rows, chunk, length = z_plan(Z, r)
    runs = chunk // Z_RUN
    assert rows * runs <= Z_THREADS
    nt = 2 * r + 1
    tpad = torch.zeros((2 * r + 1 + 7) // 8 * 8, dtype=t.dtype)
    tpad[:nt] = t

    def stage(c0):
        idx = (c0 - r + torch.arange(length)).clamp(0, Z - 1)
        return gn[:, idx], gd[:, idx]

    buf = stage(0)
    c0 = 0
    while True:
        base = Z_RUN * torch.arange(runs)

        def quad(b):
            def read(i):
                assert i % 4 == 0 and int(base[-1]) + i + 4 <= length
                return [b[:, base + i + m] for m in range(4)]
            return read

        pn, pd = quad(buf[0]), quad(buf[1])
        an, ad = [None] * Z_RUN, [None] * Z_RUN
        q = (pn(0), pd(0))
        if nt < 4:
            _z_group(pn, pd, tpad, 0, nt, q, True, True, an, ad)
        else:
            q = _z_group(pn, pd, tpad, 0, nt, q, True, False, an, ad)
            k = 4
            while k + 4 <= nt:
                q = _z_group(pn, pd, tpad, k, nt, q, False, False, an, ad)
                k += 4
            if k < nt:
                _z_group(pn, pd, tpad, k, nt, q, False, True, an, ad)
        more = c0 + chunk < Z
        if more:  # the next chunk is staged before this one is written
            buf = stage(c0 + chunk)
        for u in range(Z_RUN):
            zs = c0 + base + u
            keep = zs < Z
            if divide:
                gn[:, zs[keep]] = (an[u] / ad[u])[:, keep]
            else:
                gn[:, zs[keep]] = an[u][:, keep]
                gd[:, zs[keep]] = ad[u][:, keep]
        if not more:
            break
        c0 += chunk
    if divide:
        return gn.reshape(X, Y, Z)
    return gn.reshape(X, Y, Z), gd.reshape(X, Y, Z)


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def _emulated_nc(image, cert, sigma, spacing):
    (tx, rx), (ty, ry), (tz, rz) = (_taps(sigma, h, image.dtype)
                                    for h in spacing)
    s1, s2 = _axis_pass((image, cert), 0, tx, rx, True)
    (out,) = _axis_pass((s1,), 1, ty, ry, False)
    (s1,) = _axis_pass((s2,), 1, ty, ry, False)
    return _z_pass(out, s1, tz, rz, True)


def _emulated_pair(axis, image, cert, sigma, spacing):
    (ta, ra), (tz, rz) = (_taps(sigma, spacing[d], image.dtype)
                          for d in (axis, 2))
    num, den = _axis_pass((image, cert), axis, ta, ra, True)
    return _z_pass(num, den, tz, rz, False)


EMULATED = {
    "normalized_conv": (_emulated_nc, K.normalized_conv_plain),
    "smooth_yz": (lambda *a: _emulated_pair(1, *a), K.smooth_yz_plain),
    "smooth_xz": (lambda *a: _emulated_pair(0, *a), K.smooth_xz_plain),
}


def _check_entries(img, m, sigma, sp):
    for name, (emulated, plain) in EMULATED.items():
        got, want = emulated(img, m, sigma, sp), plain(img, m, sigma, sp)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == img.dtype
            assert _same(g, w), (name, sigma, sp)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Z", [1, 2, 3, 5, 127, 128, 512, 513, 1023, 1024,
                               1025, 29056, 30001])
def test_z_plan_covers_every_row_within_a_block(Z):
    """rows x runs threads at most a block; a chunk a multiple of Z_RUN and
    the whole row for several rows a block; the staged inputs cover every
    16-byte read of the walk (4 run + nt + 6 < len), 16-byte aligned rows,
    <= Z_SMEM of shared memory; several chunks only at least r long, so a
    chunk's halo is never a written output."""
    for r in (0, 1, 2, 22, 28, 64, MAX_RADIUS):
        rows, chunk, length = z_plan(Z, r)
        runs = chunk // Z_RUN
        assert chunk % Z_RUN == 0 and rows >= 1 and rows * runs <= Z_THREADS
        if chunk < Z:
            assert rows == 1 and chunk >= r
        else:
            assert chunk < Z + Z_RUN
        assert length % 4 == 0
        assert Z_RUN * (runs - 1) + (2 * r + 1) + 6 < length
        taps = (2 * r + 1 + 7) // 8 * 8
        assert 4 * (taps + rows * 2 * length) <= Z_SMEM


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("r", [0, 1, 2, 4, 7, 8, 9, 11, 28])
def test_axis_pass_emulation_is_the_twin_one_over_a_tile(axis, r):
    """The paired weighted pass and the single pass on 129 positions along
    the axis (one over kAxisTileA), 33 z (one over kAxisTileZ): each output
    of G_axis (c*f), G_axis c and G_axis s equals the twins' kernel_smooth_axis
    to the bit, every tap group form taken (r < 4: nt < kAxisRun)."""
    from ife_tpu_torch.ops.stencil import kernel_smooth_axis

    shape = [3, 3, 33]
    shape[axis] = 129
    img, m = _inputs(tuple(shape))
    h = 1.0 if r == 0 else 4.5 / (r - 0.5)
    sigma = 0.0 if r == 0 else 1.0
    t, got_r = _taps(sigma, h, img.dtype)
    assert got_r == r
    num, den = _axis_pass((img, m), axis, t, r, True)
    assert _same(num, kernel_smooth_axis(img * m, axis, sigma, h))
    assert _same(den, kernel_smooth_axis(m, axis, sigma, h))
    (s,) = _axis_pass((img,), axis, t, r, False)
    assert _same(s, kernel_smooth_axis(img, axis, sigma, h))


@pytest.mark.parametrize("Z", [1, 2, 5, 127, 513, 1025])
@pytest.mark.parametrize("r", [1, 4, 22, MAX_RADIUS])
def test_z_pass_emulation_is_the_twin(Z, r):
    """Both forms of the z pass, in place and with the divide into num's
    storage, on rows of one z, a partial run, several rows a block and two
    chunks (1025): G_z num, G_z den and their quotient to the bit."""
    from ife_tpu_torch.ops.stencil import kernel_smooth_axis

    img, m = _inputs((2, 3, Z))
    num, den = img * m, m + 0.5
    h = 4.5 / (r - 0.5)
    t, _ = _taps(1.0, h, img.dtype)
    want_n = kernel_smooth_axis(num, 2, 1.0, h)
    want_d = kernel_smooth_axis(den, 2, 1.0, h)
    got_n, got_d = _z_pass(num, den, t, r, False)
    assert _same(got_n, want_n) and _same(got_d, want_d)
    assert _same(_z_pass(num, den, t, r, True), want_n / want_d)


@pytest.mark.parametrize("radii", [(1, 2, 4), (11, 14, 22), (28, 28, 22),
                                   (2, 64, 11), (128, 1, 3), (3, 2, 128)])
def test_entries_emulated_are_their_twins_at_each_radius(radii):
    img, m = _inputs((9, 8, 11))
    _check_entries(img, m, 1.0, _spacing(radii))


@pytest.mark.parametrize("shape", [(7, 9, 1), (9, 7, 2), (6, 5, 5),
                                   (3, 4, 127), (2, 3, 513), (129, 3, 33),
                                   (3, 129, 33), (5, 6, 1025)])
def test_entries_emulated_are_their_twins_on_thin_and_tile_edge_shapes(shape):
    img, m = _inputs(shape)
    _check_entries(img, m, 4.8, (0.78, 0.78, 1.0))


@pytest.mark.parametrize("label", ["empty", "octant", "ones", "nan_inf"])
def test_entries_emulated_are_their_twins_under_each_mask(label):
    """An empty mask (0/0 = NaN everywhere in nc), one octant, a mask of
    ones, and an image with NaN and +-inf where the sphere is 0 (c*f = NaN
    there, as in the twin)."""
    img, m = _inputs((12, 10, 9))
    if label == "empty":
        m = torch.zeros_like(m)
    elif label == "octant":
        m = torch.zeros_like(m)
        m[:6, :5, :5] = 1.0
    elif label == "ones":
        m = torch.ones_like(m)
    else:
        off = m == 0
        vals = torch.tensor([float("nan"), float("inf"), -float("inf")])
        img = img.clone()
        img[off] = vals.repeat(int(off.sum()) // 3 + 1)[:int(off.sum())]
    _check_entries(img, m, 2.4, (0.78, 0.78, 1.0))


@pytest.mark.parametrize("shape,sigma", [((12, 17, 16), 1.3),
                                         ((10, 23, 16), 2.1)])
def test_emulated_nc_matches_ife_tpu_interpret_f64(shape, sigma):
    """The emulation in f64 against ife_tpu's Pallas kernel in interpret
    mode: within TOL of max|reference| inside the mask."""
    img, m = _inputs(shape, seed=10, dtype=np.float64)
    got = _emulated_nc(img, m, sigma, SPACING).numpy()
    want = np.asarray(JF.fused_normalized_conv_sweep(
        jnp.asarray(img.numpy()), jnp.asarray(m.numpy()), sigma, SPACING,
        interpret=True))
    inside = m.numpy() != 0
    err = np.abs(got - want)[inside].max() / np.abs(want[inside]).max()
    assert err <= TOL


@pytest.mark.parametrize("n_tiles", [1, 2, 3])
def test_emulated_nc_in_slabs_is_the_untiled_emulation(n_tiles):
    """fused_normalized_conv_sweep_tiled's slabs (tile_slabs) through the
    emulated kernel equal the emulated whole volume to the bit."""
    from ife_tpu_torch.kernels.normalized_conv import _tiled

    img, m = _inputs((6, 31, 7))
    sp = (0.78, 0.78, 1.0)
    whole = _emulated_nc(img, m, 2.4, sp)
    tiled = _tiled(lambda f, c: _emulated_nc(f, c, 2.4, sp), img, m, 2.4, sp,
                   4.5, n_tiles)
    assert _same(tiled, whole)
