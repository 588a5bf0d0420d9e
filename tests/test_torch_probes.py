"""ife_tpu_torch's roofline probes (kernels/probes.py) and the copy-floor
modes of the Hessian and tap kernels on the CPU: given CPU tensors each entry
runs its plain twin, which is held against the TPU kernel it replaces, the
Pallas probes of benchmarks/ run under pltpu.force_tpu_interpret_mode() and
ife_tpu's kernels with interpret=True, as tests/test_kernels.py runs them.

The probe scripts read sys.argv and set JAX cache variables when imported:
they are loaded from their files once, after jax, with sys.argv and
os.environ restored afterwards; nothing is written into benchmarks/.

Tolerances: every probe but stencil6 computes one f32 rounding of x (a
product with an f32 constant, or a sum with a small integer) or a copy, so
it equals the TPU kernel exactly, bit for bit, save the sign of a zero: XLA
folds `x + 0.0` to `x`, so ife_tpu's copy floors keep a -0 input at k = 0
where the port (kernel and twin, IEEE) gives +0. stencil6 associates its
cross terms in another order than probe_fused's (x then z, against z then
x): <= 1e-6 * max(max|ref|, 1) per channel in f32. The TPU probes tile
(8, 128) blocks of x and y, so the shapes here are multiples of those.

The CUDA kernels themselves are tested on the card (tests/test_torch_gpu.py).
"""
import importlib.util
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ife_tpu.kernels import fused as JF
from ife_tpu_torch import kernels as K
from ife_tpu_torch.kernels import probes as P

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "benchmarks"
SHAPE = (16, 128, 16)
SEEDS = (0, 7)
SPACING = (0.78, 0.78, 1.0)


@pytest.fixture(scope="module")
def jprobes():
    """The three probe scripts as modules, by file name."""
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [sys.argv[0]])
        mp.setattr(os, "environ", os.environ.copy())
        for name in ("probe10", "probe11", "probe_fused"):
            spec = importlib.util.spec_from_file_location(
                f"_tpu_{name}", BENCH / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    return mods


def _volume(seed, shape=SHAPE):
    """f32 normal samples with a few -0.0 among them."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::97] = -0.0
    return x


def _tpu(fn, x):
    with pltpu.force_tpu_interpret_mode():
        out = fn(jnp.asarray(x))
    return [np.asarray(o) for o in out]


def _port(out):
    return [o.numpy() for o in out]


def _exact(got, want, zero_sign=True):
    """Bit for bit; with zero_sign=False a zero of either sign matches a
    zero of either sign."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        same = g.view(np.int32) == w.view(np.int32)
        if not zero_sign:
            same |= (g == 0) & (w == 0)
        assert same.all()


SCALED = {
    "probe10.trivial6": (lambda m: m["probe10"].trivial6, P.trivial6),
    "probe11.trivial6": (lambda m: m["probe11"].trivial6, P.trivial6),
    "probe11.pcopy1": (lambda m: (lambda v: [m["probe11"].pcopy1(v)]),
                       lambda x: [P.pcopy1(x)]),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCALED))
def test_scaled_copies_equal_the_tpu_probes(jprobes, name, seed):
    tpu_fn, port_fn = SCALED[name]
    x = _volume(seed)
    _exact(_port(port_fn(torch.from_numpy(x))), _tpu(tpu_fn(jprobes), x))


COPIES = {
    "probe11.floor_window": (lambda m: m["probe11"].floor_window,
                             P.floor_window),
    "fused_hessian_eig copyfloor": (
        lambda m: (lambda v: JF.fused_hessian_eig(
            v, SPACING, interpret=True, stack=False, variant="copyfloor")),
        lambda x: K.fused_hessian_eig(x, SPACING, stack=False,
                                      variant="copyfloor")),
    "probe_fused.variant copy6": (
        lambda m: (lambda v: m["probe_fused"].variant(v, "copy6")),
        lambda x: P.variant(x, "copy6")),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(COPIES))
def test_hessian_copy_floors_equal_the_tpu_kernels(jprobes, name, seed):
    tpu_fn, port_fn = COPIES[name]
    x = _volume(seed)
    got = _port(port_fn(torch.from_numpy(x)))
    want = _tpu(tpu_fn(jprobes), x)
    _exact(got, want, zero_sign=name.endswith("copy6"))
    # the port turns -0 into +0 at k = 0, as IEEE's x + 0 does
    if not name.endswith("copy6"):
        assert not np.signbit(got[0][x == 0]).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_stencil6_matches_probe_fused(jprobes, seed):
    x = _volume(seed)
    got = _port(P.variant(torch.from_numpy(x), "stencil6"))
    want = _tpu(lambda v: jprobes["probe_fused"].variant(v, "stencil6"), x)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        scale = max(np.abs(w.astype(np.float64)).max(), 1.0)
        assert np.abs(g.astype(np.float64) - w).max() <= 1e-6 * scale


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sigma", [0.6, 1.2])
def test_tap_copyfloor_equals_the_tpu_kernel(seed, sigma):
    x = _volume(seed)
    rng = np.random.default_rng(seed + 100)
    # a mask with values outside [0, 1] and between: the kernel clamps it
    mask = rng.choice(np.float32([-1.0, 0.0, 0.25, 1.0, 3.0]), SHAPE)
    got = K.fused_features8_tap(torch.from_numpy(x), torch.from_numpy(mask),
                                sigma, SPACING, stack=False,
                                variant="copyfloor")
    want = JF.fused_features8_tap(jnp.asarray(x), jnp.asarray(mask), sigma,
                                  SPACING, interpret=True, stack=False,
                                  variant="copyfloor")
    _exact(_port(got), [np.asarray(w) for w in want], zero_sign=False)


def test_probe_constants_are_rounded_once_to_f32():
    assert P.PCOPY1_SCALE == float(np.float32(1.000001))
    assert P.TRIVIAL6_SCALES == tuple(
        float(jnp.asarray(1.0 + 1e-6 * k, jnp.float32)) for k in range(6))


def test_fused_hessian_eig_default_is_the_features_and_variants_raise():
    x = torch.from_numpy(_volume(3, (9, 10, 11)))
    want = K.hessian_eig_plain(x, SPACING)
    for got in (K.fused_hessian_eig(x, SPACING, stack=False),
                K.fused_hessian_eig(x, SPACING, stack=False,
                                    variant="features"),
                K.fused_hessian_eig_stream(x, SPACING, stack=False)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # codegen knobs of the TPU kernel and unknown values have no counterpart
    for bad in ("concat", "roll", "copy6", "nope"):
        with pytest.raises(ValueError, match="variant"):
            K.fused_hessian_eig(x, SPACING, variant=bad)
        with pytest.raises(ValueError, match="variant"):
            K.fused_features8_tap(x, x, 1.2, SPACING, variant=bad)
    with pytest.raises(ValueError, match="whole volume"):
        K.fused_hessian_eig(x, variant="copyfloor", pre_padded=True)
    with pytest.raises(ValueError, match="whole volume"):
        K.fused_hessian_eig(x, variant="copyfloor", x_halo=(x[:1], x[-1:]))
    stacked = K.fused_hessian_eig(x, variant="copyfloor")
    assert stacked.shape == (6, 9, 10, 11)
    assert torch.equal(stacked[5], x + 5.0)


def test_probe_entries_check_their_arguments():
    x = torch.from_numpy(_volume(4, (5, 6, 7)))
    for call in (lambda: P.trivial6(x, width=2), lambda: P.pcopy1(x, width=8)):
        with pytest.raises(ValueError, match="width"):
            call()
    with pytest.raises(ValueError, match="mode"):
        P.variant(x, "copy7")
    with pytest.raises(ValueError, match="mode"):
        P.variant_plain(x, "concat")
    # any shape on the port (the TPU probes need X % 8 == Y % 128 == 0)
    assert all(torch.equal(g, x * c)
               for g, c in zip(P.trivial6(x, width=1), P.TRIVIAL6_SCALES))
    full = P.variant(x, "full")
    assert all(torch.equal(g, w)
               for g, w in zip(full, K.hessian_eig_plain(x, P.PROBE_SPACING)))


def test_probe_entries_never_reach_the_plain_twins_off_the_cpu(monkeypatch):
    # the plain twin runs only for a CPU tensor; any other device must
    # launch the kernel (CUDA) or raise, never fall back
    from ife_tpu_torch.kernels import features8_tap as tap_mod
    from ife_tpu_torch.kernels import hessian_eig as he_mod

    def refuse(*a, **k):
        raise AssertionError("plain twin called for a non-CPU tensor")

    for mod, name in ((P, "trivial6_plain"), (P, "pcopy1_plain"),
                      (P, "variant_plain"),
                      (he_mod, "hessian_eig_copyfloor_plain"),
                      (tap_mod, "features8_tap_copyfloor_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.empty((8, 8, 8), device="meta")
    for call in (lambda: P.trivial6(x), lambda: P.pcopy1(x, width=1),
                 lambda: P.floor_window(x), lambda: P.variant(x, "copy6"),
                 lambda: P.variant(x, "stencil6"),
                 lambda: K.fused_hessian_eig(x, variant="copyfloor"),
                 lambda: K.fused_features8_tap(x, x, 1.2,
                                               variant="copyfloor")):
        with pytest.raises(ValueError, match="no kernel or plain path"):
            call()
