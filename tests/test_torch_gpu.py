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


@pytest.mark.parametrize("shape", SHAPES)
def test_hessian_eig_kernel_matches_plain(cuda, shape):
    img, _ = _inputs(shape, cuda)
    got = K.fused_hessian_eig_stream(img, SPACING, stack=False)
    want = K.hessian_eig_plain(img, SPACING)
    assert _feature_err(got, want, (0, 1, 2)) < TOL
    assert all(_same(g, w) for g, w in zip(got, want))


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
    # the sweep takes every radius its ring fits; the dispatcher sends it
    # rx <= 10 only
    img, mask = _inputs(shape, cuda)
    got = K.fused_features8_sweep(img, mask, sigma, SPACING, stack=False)
    want = K.features8_sweep_plain(img, mask, sigma, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.6, 2.4, 3.4, 4.8])
def test_smooth_yz_and_xs_stream_kernels_match_plain(cuda, shape, sigma):
    img, mask = _inputs(shape, cuda)
    num, den = K.fused_smooth_yz(img, mask, sigma, SPACING)
    pnum, pden = K.smooth_yz_plain(img, mask, sigma, SPACING)
    assert _same(num, pnum) and _same(den, pden)
    if not K.xs_stream_fits(sigma, SPACING):  # rx 31: the x ring > 227 KB
        assert sigma == 4.8
        return
    got = K.fused_features8_xs_stream(num, den, mask, sigma, SPACING,
                                      stack=False)
    want = K.features8_xs_stream_plain(num, den, mask, sigma, SPACING)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(_same(g, w) for g, w in zip(got, want))


def test_cuda_tensors_launch_kernels_never_plain_twins(cuda, monkeypatch):
    from ife_tpu_torch.kernels import (
        features8_post as post_mod, features8_sweep as sweep_mod,
        hessian_eig as he_mod, normalized_conv as nc_mod,
    )
    from ife_tpu_torch.ops.features import (
        features8_auto_channels, features8_dispatch_branch,
    )

    def refuse(*a, **k):
        raise AssertionError("plain twin called for a CUDA tensor")

    for mod, name in ((he_mod, "hessian_eig_plain"),
                      (post_mod, "features8_post_plain"),
                      (nc_mod, "normalized_conv_plain"),
                      (nc_mod, "smooth_yz_plain"),
                      (sweep_mod, "features8_sweep_plain"),
                      (sweep_mod, "features8_xs_stream_plain")):
        monkeypatch.setattr(mod, name, refuse)
    img, mask = _inputs((13, 12, 11), cuda)
    sp = (0.78, 0.78, 1.0)
    assert [features8_dispatch_branch(s, sp, img.shape)
            for s in (1.2, 2.4, 4.8)] == ["sweep", "xs_stream", "nc_conv+post"]
    before = dict(K.LAUNCHES)
    for sigma in (1.2, 2.4, 4.8):
        features8_auto_channels(img, mask, sigma, sp)
    K.fused_hessian_eig(img, SPACING)
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES} == dict.fromkeys(
        K.LAUNCHES, 1)


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
