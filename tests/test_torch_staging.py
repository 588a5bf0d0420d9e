"""make_bag_device's staging of its inputs (roi/bag.py:_device_inputs over
utils/staging.py): the mask crosses as the caller holds it and is clamped on
the device to what ops/features.py:clamp_mask gives the host's tensor, to
the bit; the page-locked ring's
chunk plan covers every byte once; bags do not change. The ring itself runs
only on the card (marker gpu).

This file imports neither JAX nor ife_tpu; on the card run its card cases
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_staging.py -q
"""
import sys
import threading

import numpy as np
import pytest
import torch

from ife_tpu_torch.ops.features import clamp_mask
from ife_tpu_torch.roi.bag import _device_inputs, make_bag, make_bag_device
from ife_tpu_torch.roi.generate import ROI
from ife_tpu_torch.utils import staging

SHAPE = (9, 10, 11)
CPU = torch.device("cpu")


def _mask(dtype, seed=0, shape=SHAPE):
    """A mask of `dtype` with values the clamp changes: labels above 1,
    negatives where the dtype is signed, and for floats fractions, -0.0,
    NaN and infinities."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        return rng.random(shape) > 0.5
    if dtype.kind == "f":
        pool = np.array([0.0, -0.0, 1.0, 0.25, 0.75, 1.5, 3.0, -0.5, -2.0,
                         np.nan, np.inf, -np.inf], np.float64)
        return rng.choice(pool, shape).astype(dtype)
    lo = -3 if dtype.kind == "i" else 0
    return rng.integers(lo, 7, shape).astype(dtype)


def _host_clamp(mask: np.ndarray) -> torch.Tensor:
    """clamp_mask of the caller's mask as a host tensor of its own dtype."""
    return clamp_mask(torch.from_numpy(np.ascontiguousarray(mask)))


def _same_bits(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.cpu().contiguous().numpy(), want.cpu().contiguous().numpy()
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int16, np.float32,
                                   np.uint16, np.int8, np.float64])
def test_the_staged_mask_is_the_host_clamp_to_the_bit(dtype):
    mask = _mask(dtype)
    img = np.zeros(SHAPE, np.float32)
    _, got = _device_inputs(img, mask, torch.float32, CPU)
    _same_bits(got, _host_clamp(mask))
    # the caller's mask is read, never written
    np.testing.assert_array_equal(mask, _mask(dtype))


def test_a_non_contiguous_mask_and_image_stage_as_their_copies():
    mask = _mask(np.int16, shape=(11, 10, 9)).transpose(2, 1, 0)
    img = np.random.default_rng(1).random((11, 10, 9)).transpose(2, 1, 0)
    assert not mask.flags.c_contiguous and not img.flags.c_contiguous
    got_img, got_mask = _device_inputs(img, mask, torch.float32, CPU)
    _same_bits(got_mask, _host_clamp(mask))
    _same_bits(got_img, torch.from_numpy(np.ascontiguousarray(img)).float())


@pytest.mark.parametrize("total", [0, 1, 1000, 4096, 3 * 4096, 3 * 4096 + 7,
                                   9 * 4096 - 1])
def test_the_chunk_plan_covers_every_byte_once(total):
    size = 4096
    plan = staging.chunk_plan(total, size)
    assert len(plan) == -(-total // size)
    assert all(0 < n <= size for _, n in plan)
    covered = np.concatenate([np.arange(off, off + n) for off, n in plan]
                             or [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(covered, np.arange(total))


@pytest.mark.parametrize("shape, src, want, staged, ring", [
    ((4, 5, 6), np.float32, torch.float32, 480, 480),
    ((4, 5, 6), np.float64, torch.float32, 480, 480),   # cast on the host
    ((4, 5, 6), np.float16, torch.float32, 240, 240),   # cast on the card
    ((4, 5, 6), np.uint8, None, 120, 120),
    ((0, 5, 6), np.float32, torch.float32, 0, 0),
])
def test_the_bytes_that_cross_and_those_the_ring_takes(shape, src, want,
                                                       staged, ring):
    arr = np.zeros(shape, src)
    assert staging.staged_nbytes(arr, want) == staged
    assert staging.ring_nbytes(arr, "cuda", want) == ring
    assert staging.ring_nbytes(arr, "cpu", want) == 0
    if arr.ndim and arr.shape[0] > 1:
        # a view that is not C-contiguous takes the pageable copy
        assert staging.ring_nbytes(arr[::2], "cuda", want) == 0


def test_on_the_cpu_an_array_is_taken_as_it_is():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t = staging.to_device(a, CPU)
    assert t.data_ptr() == a.ctypes.data
    d = staging.to_device(a, CPU, torch.float64)
    assert d.dtype == torch.float64
    assert torch.equal(d, torch.from_numpy(a).double())


def test_a_signed_mask_with_negatives_gives_the_bag_of_its_clamp():
    rng = np.random.default_rng(5)
    shape = (20, 18, 16)
    img = (rng.standard_normal(shape) * 100.0 - 600.0).astype(np.float32)
    mask = rng.integers(-2, 4, shape).astype(np.int16)
    rois = [ROI((2, 2, 2), (7, 7, 7)), ROI((9, 6, 5), (7, 7, 7)),
            ROI((4, 8, 3), (5, 6, 7))]
    sigmas = [0.8, 1.4]
    edges = [np.linspace(-300.0, 300.0, 6) for _ in range(8 * len(sigmas))]
    args = (sigmas, edges, rois, (0.9, 1.0, 1.1))
    got = make_bag_device(img, mask, *args, dtype=torch.float64, device=CPU)
    # the clamped mask, as make_bag_device staged it before; and the same
    # mask as 0/1 labels
    clamped = make_bag_device(img, _host_clamp(mask).numpy(), *args,
                              dtype=torch.float64, device=CPU)
    labels = make_bag_device(img, (mask > 0).astype(np.uint8), *args,
                             dtype=torch.float64, device=CPU)
    np.testing.assert_array_equal(got, clamped)
    np.testing.assert_array_equal(got, labels)
    host = make_bag(img, mask, *args, dtype=torch.float64, device=CPU)
    assert np.isfinite(got).all()
    assert np.abs(host - got).max() <= 2.0 ** -23


@pytest.fixture
def cuda(monkeypatch):
    """The card, with a ring of 1 MiB slots in the place of the process's,
    so small arrays take many chunks and wrap the ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `python -m "
                    "pytest --noconftest -m gpu tests/test_torch_staging.py`")
    monkeypatch.setattr(staging, "_ring", staging._Ring(slot_bytes=1 << 20))
    return torch.device("cuda", 0)


def _sizes():
    """Element counts of a 4-byte array: below one slot, a multiple of the
    ring's bytes, a ragged tail."""
    per = (1 << 20) // 4
    return [per // 3, 2 * staging.RING_SLOTS * per,
            staging.RING_SLOTS * per + per // 2 + 3]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["below", "multiple", "ragged", "strided"])
def test_the_ring_stages_image_and_mask_to_the_bit(cuda, case):
    rng = np.random.default_rng(7)
    if case == "strided":
        n = _sizes()[2]
        img = rng.random((2, n), dtype=np.float32)[:, ::2]
        mask = rng.integers(-3, 7, (2, n)).astype(np.int32)[:, ::2]
    else:
        n = _sizes()[["below", "multiple", "ragged"].index(case)]
        img = rng.random(n, dtype=np.float32)
        mask = rng.integers(-3, 7, n).astype(np.int32)
    for arr in (img, mask, mask.astype(np.uint8)):
        _same_bits(staging.to_device(arr, cuda),
                   torch.from_numpy(np.ascontiguousarray(arr)).to(cuda))
    got_img, got_mask = _device_inputs(img, mask, torch.float32, cuda)
    _same_bits(got_img, torch.from_numpy(np.ascontiguousarray(img)).to(cuda))
    _same_bits(got_mask, _host_clamp(mask).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int16, np.float32,
                                   np.uint16, np.float64])
def test_the_card_clamps_the_mask_to_the_host_clamp_to_the_bit(cuda, dtype):
    mask = _mask(dtype, shape=(64, 70, 90))
    img = np.zeros(mask.shape, np.float32)
    _, got = _device_inputs(img, mask, torch.float32, cuda)
    assert got.device.type == "cuda"
    _same_bits(got, _host_clamp(mask))


@pytest.mark.gpu
@pytest.mark.parametrize("src", [np.float64, np.float16, np.int16])
def test_a_cast_on_either_side_of_the_ring_is_the_plain_cast(cuda, src):
    a = (np.random.default_rng(3).standard_normal(_sizes()[2]) * 300.0
         ).astype(src)
    _same_bits(staging.to_device(a, cuda, torch.float32),
               torch.from_numpy(a).to(device=cuda, dtype=torch.float32))


@pytest.mark.gpu
def test_two_calls_in_a_row_do_not_see_each_others_bytes(cuda):
    # the card sleeps first, so each slot's copy waits in the stream; a slot
    # refilled before its copy ran would send the later array's bytes
    n = _sizes()[1]
    a = np.arange(n, dtype=np.float32)
    b = -np.arange(n, dtype=np.float32) - 1.0
    torch.cuda.synchronize(cuda)
    torch.cuda._sleep(100_000_000)
    ga = staging.to_device(a, cuda)
    gb = staging.to_device(b, cuda)
    _same_bits(ga, torch.from_numpy(a))
    _same_bits(gb, torch.from_numpy(b))


@pytest.mark.gpu
def test_threads_staging_at_once_each_get_their_own_bytes(cuda):
    # more threads than the host has cores, each staging arrays of its own
    # through the one ring, switching often
    n = _sizes()[2]
    n_threads = 2 * (torch.get_num_threads() + 2)
    results, errors = {}, []

    def work(t):
        try:
            for i in range(3):
                a = np.full(n, t * 10 + i, np.float32)
                results[(t, i)] = (a, staging.to_device(a, cuda))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(results) == 3 * n_threads
    for a, got in results.values():
        _same_bits(got, torch.from_numpy(a))
