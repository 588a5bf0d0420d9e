"""ife_tpu_torch.io and core.volume against ife_tpu's: files written from the
same array and geometry hold the same bytes, each package reads the other's
files back exactly, and the synthetic inputs are bit-identical."""
import gzip

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.core import volume as JV
from ife_tpu import io as JIO
from ife_tpu_torch.core import volume as TV
from ife_tpu_torch import io as TIO

torch.set_num_threads(1)

SPACING = (0.78, 0.7, 1.25)
ORIGIN = (-12.5, 3.0, 101.0)


def _array(dtype, shape=(7, 6, 5), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.bool_:
        return rng.random(shape) > 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 100, shape).astype(dtype)
    return (rng.standard_normal(shape) * 300.0).astype(dtype)


def _pair(arr):
    return (TV.Volume.from_numpy(arr, SPACING, ORIGIN),
            JV.Volume(jnp.asarray(arr), spacing=SPACING, origin=ORIGIN))


def _read_bytes(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8, np.int16,
                                   np.uint16, np.int32, np.int64, np.bool_])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_bytes_equal_ife_tpu(tmp_path, dtype, suffix):
    arr = _array(dtype)
    tv, jv = _pair(arr)
    TIO.write_volume(str(tmp_path / f"t{suffix}"), tv)
    JIO.write_volume(str(tmp_path / f"j{suffix}"), jv)
    # (gzip headers carry a timestamp; the NIfTI bytes inside must match)
    assert _read_bytes(tmp_path / f"t{suffix}") == _read_bytes(tmp_path / f"j{suffix}")
    back = TIO.read_volume(str(tmp_path / f"j{suffix}"))
    ref = JIO.read_volume(str(tmp_path / f"t{suffix}"))
    assert isinstance(back.data, torch.Tensor)
    assert np.array_equal(back.numpy(), np.asarray(ref.data))
    assert back.numpy().dtype == np.asarray(ref.data).dtype
    assert back.spacing == ref.spacing and back.origin == ref.origin


@pytest.mark.parametrize("pixel_type", ["float", "char"])
def test_hr2_bytes_equal_ife_tpu(tmp_path, pixel_type):
    arr = _array(np.float32) if pixel_type == "float" else _array(np.int16) - 50
    tv, jv = _pair(arr)
    TIO.write_hr2(str(tmp_path / "t.hr2"), tv, pixel_type=pixel_type)
    JIO.write_hr2(str(tmp_path / "j.hr2"), jv, pixel_type=pixel_type)
    assert (tmp_path / "t.hr2").read_bytes() == (tmp_path / "j.hr2").read_bytes()
    back = TIO.read_volume(str(tmp_path / "j.hr2"))
    ref = JIO.read_hr2(str(tmp_path / "j.hr2"), native=False)
    assert np.array_equal(back.numpy(), np.asarray(ref.data))
    assert back.spacing == ref.spacing and back.origin == ref.origin


def test_octave_bytes_equal_ife_tpu(tmp_path):
    tv, jv = _pair(_array(np.float64))
    TIO.write_volume(str(tmp_path / "t.octave"), tv)
    JIO.write_volume(str(tmp_path / "j.octave"), jv)
    assert (tmp_path / "t.octave").read_bytes() == (tmp_path / "j.octave").read_bytes()
    back = TIO.read_volume(str(tmp_path / "j.octave"))
    assert np.array_equal(back.numpy(), np.asarray(JIO.read_octave(str(tmp_path / "j.octave")).data))


def test_npy_and_sniffed_formats(tmp_path):
    arr = _array(np.float32)
    tv, _ = _pair(arr)
    TIO.write_volume(str(tmp_path / "v.npy"), tv)
    assert np.array_equal(TIO.read_volume(str(tmp_path / "v.npy")).numpy(), arr)
    TIO.write_volume(str(tmp_path / "v.hr2"), tv)
    (tmp_path / "v.hr2").rename(tmp_path / "noext")
    assert np.array_equal(TIO.read_volume(str(tmp_path / "noext")).numpy(), arr)
    TIO.write_volume(str(tmp_path / "v.nii.gz"), tv)
    (tmp_path / "v.nii.gz").rename(tmp_path / "noext2")
    # a gzip NIfTI without its suffix is read as plain NIfTI and refused,
    # as in ife_tpu
    with pytest.raises(ValueError, match="sizeof_hdr"):
        JIO.read_volume(str(tmp_path / "noext2"))
    with pytest.raises(ValueError, match="sizeof_hdr"):
        TIO.read_volume(str(tmp_path / "noext2"))


@pytest.mark.parametrize("shape,seed", [((16, 16, 16), 0), ((13, 12, 11), 3),
                                        ((40, 9, 17), 7)])
def test_synthetic_inputs_bit_identical(shape, seed):
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        t = TV.synthetic_ct(shape, seed=seed, dtype=dt_t).numpy()
        j = np.asarray(JV.synthetic_ct(shape, seed=seed, dtype=dt_j).data)
        assert t.dtype == j.dtype and np.array_equal(t, j)
    t = TV.sphere_mask(shape, 0.37).numpy()
    j = np.asarray(JV.sphere_mask(shape, 0.37).data)
    assert t.dtype == j.dtype == np.uint8 and np.array_equal(t, j)


def test_volume_geometry():
    arr = _array(np.float32, (10, 8, 6))
    tv, jv = _pair(arr)
    assert tv.shape == (10, 8, 6) and tv.dtype == torch.float32
    assert tv.physical_point((2, 3.5, 1)) == jv.physical_point((2, 3.5, 1))
    tc, jc = tv.crop((1, 2, 3), (4, 3, 2)), jv.crop((1, 2, 3), (4, 3, 2))
    assert np.array_equal(tc.numpy(), np.asarray(jc.data))
    assert tc.origin == jc.origin and tc.spacing == jc.spacing
    assert tv.astype(torch.float64).dtype == torch.float64
    assert tv.with_data(tv.data * 2).spacing == SPACING
    with pytest.raises(ValueError):
        TV.Volume(tv.data, spacing=(1.0, 1.0))


def test_from_numpy_copies_read_only_arrays():
    arr = np.frombuffer(np.arange(8, dtype=np.float32).tobytes(), np.float32).reshape(2, 2, 2)
    assert not arr.flags.writeable
    v = TV.Volume.from_numpy(arr)
    v.data[0, 0, 0] = 5.0  # writable tensor, the buffer untouched
    assert arr[0, 0, 0] == 0.0
