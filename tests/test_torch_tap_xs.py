"""ife_tpu_torch's fused_features8_tap and fused_features8_xs on the CPU:
given CPU tensors each wrapper runs its plain twin, which is held against the
Pallas kernel it replaces, run in interpret mode as tests/test_kernels.py
runs it, on the cases of that file (a whole volume, a smoothing radius larger
than the volume, prime extents, f32 accuracy).

Tolerances: f64 twin against the f64 Pallas kernel <= 1e-9 of the channel's
scale (both take the polynomial eigen path; the twin sums its taps in the CUDA
kernel's order, the Pallas z pass from the centre tap outwards), eigenvalue
channels per channel, as value-sorted triples only where two magnitudes tie
within twice the tolerance; against the composed ops (ife_tpu's
features8, trig eigen path) <= 1e-7, ife_tpu's own bound for these kernels;
in f32 no worse than 2.5x the composed f32 ops' own distance from the f64
truth (floor 1e-6), ife_tpu's bound for the tap kernel.

The CUDA kernels themselves are tested on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.core.volume import sphere_mask as j_sphere_mask
from ife_tpu.core.volume import synthetic_ct as j_synthetic_ct
from ife_tpu.kernels import fused as JF
from ife_tpu.ops.features import features8 as j_features8
from ife_tpu_torch import kernels as K
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues
from ife_tpu_torch.kernels import features8_tap as tap_mod

torch.set_num_threads(1)

SPACING = (0.7, 0.9, 1.2)
KINDS = {"tap": (K.fused_features8_tap, JF.fused_features8_tap),
         "xs": (K.fused_features8_xs, JF.fused_features8_xs)}
# (shape, seed, sigma): a whole volume; a radius (17 voxels on the 0.7 axis)
# larger than the volume; prime extents; radii 8 / 7 / 5 (rx != ry != rz) on
# extents one voxel over the kernels' tiles: 15 x-rows over the tap's 14,
# 17 planes over the xs kernel's 16, 33 z over both kernels' 32
CASES = [((16, 16, 16), 5, 1.1), ((16, 16, 16), 6, 2.5), ((13, 11, 16), 7, 0.9),
         ((15, 17, 33), 8, 1.3)]


def _inputs(shape, seed, dtype=jnp.float64):
    img = np.array(j_synthetic_ct(shape, seed=seed, dtype=dtype).data)
    mask = np.array(j_sphere_mask(shape, 0.45).data)
    return img, mask


def _errs(got, want, tol=1e-9):
    """Per channel max|got - want| / max(max|want|, 1), channels last; the
    eigenvalue channels per channel where want's adjacent |e_k| differ by
    more than 2 * tol of their joint scale, as value-sorted triples where
    they tie (tie_sorted_eigenvalues)."""
    scale = max(np.abs(want[..., 2:5]).max(), 1.0)
    ge, we = tie_sorted_eigenvalues(
        [torch.from_numpy(np.array(got[..., c], np.float64)) for c in (2, 3, 4)],
        [torch.from_numpy(np.array(want[..., c], np.float64)) for c in (2, 3, 4)],
        2 * tol * scale)
    out = []
    for c in range(8):
        s = max(np.abs(want[..., c]).max(), 1.0)
        if c in (2, 3, 4):
            out.append((ge[c - 2] - we[c - 2]).abs().max().item() / s)
        else:
            out.append(np.abs(got[..., c] - want[..., c]).max() / s)
    return np.array(out)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shape,seed,sigma", CASES)
def test_twin_matches_pallas_interpret_f64(kind, shape, seed, sigma):
    t_fn, j_fn = KINDS[kind]
    img, mask = _inputs(shape, seed)
    got = t_fn(torch.from_numpy(img), torch.from_numpy(mask), sigma, SPACING)
    assert got.shape == (8,) + shape
    assert bool(torch.isfinite(got).all())
    got = got.movedim(0, -1).numpy()
    assert np.all(got[mask == 0] == 0)
    want = np.moveaxis(np.asarray(j_fn(jnp.asarray(img), jnp.asarray(mask),
                                       sigma, SPACING, interpret=True)), 0, -1)
    assert _errs(got, want).max() <= 1e-9
    ops = np.asarray(j_features8(jnp.asarray(img), jnp.asarray(mask), sigma,
                                 SPACING))
    assert _errs(got, ops, 1e-7).max() <= 1e-7


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_twin_f32_within_the_documented_budget(kind):
    t_fn, _ = KINDS[kind]
    img, mask = _inputs((16, 16, 16), 5, jnp.float32)
    truth = np.asarray(j_features8(jnp.asarray(img, jnp.float64),
                                   jnp.asarray(mask), 1.1, SPACING))
    xla = np.asarray(j_features8(jnp.asarray(img), jnp.asarray(mask), 1.1,
                                 SPACING)).astype(np.float64)
    got = t_fn(torch.from_numpy(img), torch.from_numpy(mask), 1.1, SPACING)
    assert got.dtype == torch.float32
    got = got.movedim(0, -1).numpy().astype(np.float64)
    # the eigenvalues as value-sorted triples, then per channel outside the
    # ties (margin: twice the largest error the first comparison allows)
    e_got, e_xla = _errs(got, truth, np.inf), _errs(xla, truth, np.inf)
    assert np.all(e_got < np.maximum(2.5 * e_xla, 1e-6)), (e_got, e_xla)
    tol = np.maximum(2.5 * e_xla, 1e-6)[2:5].max()
    e_got, e_xla = _errs(got, truth, tol), _errs(xla, truth, tol)
    assert np.all(e_got < np.maximum(2.5 * e_xla, 1e-6)), (e_got, e_xla)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_labels_are_clamped_and_channels_unstack(kind):
    t_fn, _ = KINDS[kind]
    img, mask = _inputs((9, 8, 7), 3)
    x = torch.from_numpy(img)
    stacked = t_fn(x, torch.from_numpy(mask), 0.8, SPACING)
    parts = t_fn(x, torch.from_numpy(mask * 3), 0.8, SPACING, stack=False)
    assert len(parts) == 8
    assert all(torch.equal(p, s) for p, s in zip(parts, stacked))


def test_tap_smooths_x_y_z_and_xs_is_the_sweeps_twin():
    # the twins differ only in the order of the three passes
    img, mask = _inputs((10, 9, 8), 4)
    x, m = torch.from_numpy(img), torch.from_numpy(mask)
    assert K.features8_xs_plain is K.features8_sweep_plain
    tap = torch.stack(K.features8_tap_plain(x, m, 1.0, SPACING))
    xs = torch.stack(K.features8_xs_plain(x, m, 1.0, SPACING))
    assert not torch.equal(tap, xs)
    assert (tap - xs).abs().max() <= 1e-9 * max(float(xs.abs().max()), 1.0)


def test_windows_fit_shared_memory_up_to_the_stated_radii():
    unit = (1.0, 1.0, 1.0)
    smem = 227 * 1024
    # tap: the whole block (two raw rows, the ring of 2ry + 1 x-pass rows,
    # the y pass and three s rows) in shared memory up to r = 11 at equal
    # radii; beyond, the ring in global scratch and the rest in shared
    # memory up to r = 44. So r <= 8 voxels on every axis is taken.
    assert tap_mod.tap_smem_bytes(8, 8, 8) <= tap_mod.tap_smem_bytes(11, 11, 11) <= smem
    assert smem < tap_mod.tap_smem_bytes(12, 12, 12)
    assert tap_mod._tap_base_bytes(44, 44) <= smem < tap_mod._tap_base_bytes(45, 45)
    assert all(K.tap_fits(r / 4.5, unit) for r in range(1, 45))
    assert not K.tap_fits(45 / 4.5, unit) and not K.tap_fits(1.0, (0.1, 1.0, 0.1))
    assert K.tap_fits(0.6, (0.78, 0.78, 1.0)) and K.tap_fits(1.2, (0.78, 0.78, 1.0))
    assert K.tap_fits(1.1, (4.0, 0.2, 4.0))  # radii 2 / 25 / 2: a global ring
    # xs: the x pass runs from global memory; its 18 s planes take 39 KB at
    # every radius, so every radius the taps of a launch carry is taken:
    # rx <= 29 and far beyond, up to 128
    assert tap_mod.xs_smem_bytes() == 4 * 18 * 16 * 34 <= 48 * 1024
    assert K.xs_fits(29 / 4.5, unit) and K.xs_fits(128 / 4.5, unit)
    assert not K.xs_fits(129 / 4.5, unit)
    assert K.xs_fits(4.8, (0.78, 0.78, 1.0))
    assert not K.xs_fits(1.0, (1.0, 0.004, 1.0))  # ry beyond the taps of a launch


def test_tap_takes_every_radius_the_block_windows_took():
    # the window kernel this one replaced (8 x 8 x 32 cores): a raw window,
    # its x pass and the smoothed fields of one block within 227 KB
    def window_bytes(rx, ry, rz):
        wyz = (10 + 2 * ry) * (34 + 2 * rz)
        return 4 * ((10 + 2 * rx) * wyz + 10 * wyz + 2 * 10 * 10 * 34)

    smem, taken = 227 * 1024, 0
    for rx in range(0, 81, 2):
        for ry in range(0, 33):
            for rz in range(0, 112, 3):
                if window_bytes(rx, ry, rz) <= smem:
                    taken += 1
                    assert tap_mod._tap_base_bytes(rx, rz) <= smem, (rx, ry, rz)
    assert taken > 1000


@pytest.mark.parametrize("shape,r,blocks", [
    ((512, 512, 512), (7, 7, 6), 0),          # the ring in shared memory
    ((512, 512, 512), (1, 25, 1), 16 * 37),   # chunk min(512, 832): one
    ((40, 300, 33), (0, 5, 46), 2 * 3 * 2),   # chunks of 192 rows
    ((13, 12, 11), (12, 12, 12), 1)])
def test_tap_ring_scratch_holds_a_ring_a_block(shape, r, blocks):
    ring = (2 * r[1] + 1) * 2 * 16 * (34 + 2 * r[2])
    assert tap_mod.tap_ring_scratch_floats(shape, *r) == ring * blocks
    assert (blocks == 0) == (tap_mod.tap_smem_bytes(*r) <= 227 * 1024)


@pytest.mark.parametrize("r", [(7, 7, 6), (4, 4, 3), (8, 8, 8), (3, 9, 5),
                               (11, 11, 11), (0, 0, 0), (2, 1, 17)])
def test_tap_block_memory_counts_its_buffers(r):
    # floats of each buffer of csrc tap_smem_floats, counted from the block's
    # geometry: a 14 x 32 core, its s region 16 x 34
    rx, ry, rz = r
    pz = 34 + 2 * rz
    pad = 34 + -(-2 * rz // 32) * 32  # rows of the y pass buffer: 34 mod 32
    assert pad >= pz and pad % 32 == 2
    raw = 2 * 2 * (16 + 2 * rx) * pz   # two rows, c*f and c
    ring = (2 * ry + 1) * 2 * 16 * pz  # 2ry + 1 x-pass rows of both fields
    ybuf = 2 * 16 * pad                # the y pass of both fields
    srows = 3 * 16 * 34
    assert tap_mod.tap_smem_bytes(rx, ry, rz) == 4 * (raw + ring + ybuf + srows)
    # sigma 1.2 at 0.78 mm (radii 7 / 7 / 6): one block an SM; sigma 0.6
    # (4 / 4 / 3): two, under the 56 registers a thread the kernel is held to
    if r == (7, 7, 6):
        assert 113 * 1024 < tap_mod.tap_smem_bytes(*r) == 125376
    if r == (4, 4, 3):
        assert 2 * (tap_mod.tap_smem_bytes(*r) + 1024) <= 228 * 1024


def test_other_devices_never_reach_the_twins(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain twin called for a non-CPU tensor")

    monkeypatch.setattr(tap_mod, "features8_tap_plain", refuse)
    monkeypatch.setattr(tap_mod, "features8_xs_plain", refuse)
    x = torch.empty((4, 4, 4), device="meta")
    for fn in (K.fused_features8_tap, K.fused_features8_xs):
        with pytest.raises(ValueError, match="no kernel or plain path"):
            fn(x, x, 1.0)
