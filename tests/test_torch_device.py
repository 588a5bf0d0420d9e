"""The port never moves to the CPU by itself: without a card every entry
point that picks its own device raises and names IFE_PLATFORM=cpu; with
IFE_PLATFORM=cpu (or device="cpu") it runs on the CPU. These tests run on a
host without a card (they are skipped, with the reason, where one exists)."""
import socket

import numpy as np
import pytest
import torch

from ife_tpu_torch import parallel as P
from ife_tpu_torch.cli.main import main
from ife_tpu_torch.core.volume import Volume, sphere_mask, synthetic_ct
from ife_tpu_torch.io import write_volume
from ife_tpu_torch.ops import transform as T
from ife_tpu_torch.roi import generate_random_rois
from ife_tpu_torch.roi.bag import make_bag, make_bag_device

torch.set_num_threads(1)

SHAPE = (14, 12, 10)
SPACING = (0.78, 0.78, 1.0)
NAMES_THE_VARIABLE = r"IFE_PLATFORM=cpu"


@pytest.fixture
def no_card(monkeypatch):
    """A host without a card and without the CPU opt-in."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    monkeypatch.delenv("IFE_PLATFORM", raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def bag_inputs():
    img = synthetic_ct(SHAPE, seed=11).data.numpy()
    mask = sphere_mask(SHAPE, 0.45).data.numpy().astype(np.uint8)
    rois = generate_random_rois(mask, 4, (5, 5, 5), seed=0)
    rng = np.random.default_rng(0)
    edges = [np.sort(rng.normal(size=5)) * 50.0 for _ in range(8)]
    return img, mask, (1.0,), edges, rois


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=NAMES_THE_VARIABLE):
        P.default_device()


@pytest.mark.parametrize("how", ["env", "argument"])
def test_default_device_gives_the_cpu_when_asked(no_card, how):
    if how == "env":
        no_card.setenv("IFE_PLATFORM", "cpu")
        assert P.default_device() == torch.device("cpu")
    else:
        assert P.default_device("cpu") == torch.device("cpu")


def test_make_mesh_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=NAMES_THE_VARIABLE):
        P.make_mesh(4, ("x",))


@pytest.mark.parametrize("how", ["env", "argument"])
def test_make_mesh_on_the_cpu_when_asked(no_card, how):
    if how == "env":
        no_card.setenv("IFE_PLATFORM", "cpu")
        mesh = P.make_mesh(4, ("x", "y"))
    else:
        mesh = P.make_mesh(4, ("x", "y"), device="cpu")
    assert mesh.device == torch.device("cpu") and mesh.dims == (2, 2)


@pytest.mark.parametrize("entry", [make_bag, make_bag_device])
def test_bag_entry_raises_without_a_card(no_card, bag_inputs, entry):
    with pytest.raises(RuntimeError, match=NAMES_THE_VARIABLE):
        entry(*bag_inputs, spacing=SPACING)


@pytest.mark.parametrize("entry", [make_bag, make_bag_device])
def test_bag_entry_runs_on_the_cpu_when_asked(no_card, bag_inputs, entry):
    want = entry(*bag_inputs, spacing=SPACING, device="cpu")
    no_card.setenv("IFE_PLATFORM", "cpu")
    got = entry(*bag_inputs, spacing=SPACING)
    assert got.shape == (4, 8 * 6)
    np.testing.assert_array_equal(got, want)


def _transform_calls():
    """Each transform entry point that ife_tpu ran on its device, as
    (name, call(**device_kwargs))."""
    rng = np.random.default_rng(4)
    img = (rng.standard_normal(SHAPE) * 300.0 - 500.0).astype(np.float32)
    mask = rng.integers(0, 3, SHAPE).astype(np.uint8)
    src = Volume.from_numpy(img, spacing=(1.0, 1.0, 2.0))
    tgt = Volume.from_numpy(np.zeros((9, 8, 7), np.float32),
                            spacing=(0.5, 1.5, 1.0), origin=(-1.0, 0, 0))
    calls = [("mask_image", lambda **k: T.mask_image(img, mask, -7.0, **k)),
             ("relabel_mask", lambda **k: T.relabel_mask(mask, [2], **k)),
             ("intensity_window", lambda **k: T.intensity_window(img, **k))]
    for order in (0, 1, 3):
        calls.append((f"resample_to_spacing_2d order {order}",
                      lambda order=order, **k: T.resample_to_spacing_2d(
                          img[..., 0], (0.78, 0.9), 0.5, order=order, **k)))
    for order in (0, 1):
        calls.append((f"resample_to_grid order {order}",
                      lambda order=order, **k: T.resample_to_grid(
                          src, tgt, order=order, default_value=-1.0, **k).data))
    return calls


TRANSFORM_CALLS = [name for name, _ in _transform_calls()]


@pytest.mark.parametrize("name", TRANSFORM_CALLS)
def test_transform_entry_raises_without_a_card(no_card, name):
    call = dict(_transform_calls())[name]
    with pytest.raises(RuntimeError, match=NAMES_THE_VARIABLE):
        call()


@pytest.mark.parametrize("name", TRANSFORM_CALLS)
def test_transform_entry_runs_on_the_cpu_when_asked(no_card, name):
    call = dict(_transform_calls())[name]
    want = call(device="cpu")
    no_card.setenv("IFE_PLATFORM", "cpu")
    got = call()
    assert got.device == want.device == torch.device("cpu")
    assert got.dtype == want.dtype and torch.equal(got, want)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_init_raises_without_a_card(no_card):
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match=NAMES_THE_VARIABLE):
        P.distributed_init(f"127.0.0.1:{_free_port()}", 1, 0)
    assert not dist.is_initialized()  # it never became a gloo group


def test_distributed_init_is_gloo_on_the_cpu_when_asked(no_card):
    import torch.distributed as dist

    no_card.setenv("IFE_PLATFORM", "cpu")
    no_card.setenv("GLOO_SOCKET_IFNAME", "lo")
    try:
        assert P.distributed_init(f"127.0.0.1:{_free_port()}", 1, 0) == (0, 1)
        assert dist.get_backend() == "gloo"
        assert P.make_mesh().device == torch.device("cpu")
    finally:
        P.distributed_shutdown()


def test_distributed_init_without_a_coordinator_starts_no_group(no_card):
    assert P.distributed_init() == (0, 1)


@pytest.fixture
def nifti_pair(tmp_path):
    img = synthetic_ct(SHAPE, seed=5)
    write_volume(str(tmp_path / "img.nii.gz"), Volume(img.data, spacing=SPACING))
    mask = sphere_mask(SHAPE, 0.45).data.to(torch.uint8)
    write_volume(str(tmp_path / "mask.nii.gz"), Volume(mask, spacing=SPACING))
    return tmp_path


def _cli(d, name, out):
    argv = {"extract-features": ["-s", "1.0"], "hessian-features": [],
            "gradient-features": ["-s", "1.0"]}[name]
    return [name, "-i", str(d / "img.nii.gz"), "-m", str(d / "mask.nii.gz"),
            "-o", str(d / out), *argv]


@pytest.mark.parametrize("name", ["extract-features", "hessian-features"])
def test_cli_fails_without_a_card_and_names_the_variable(no_card, nifti_pair,
                                                         capsys, name):
    assert main(_cli(nifti_pair, name, "refused_")) == 1
    assert "IFE_PLATFORM=cpu" in capsys.readouterr().err
    assert not list(nifti_pair.glob("refused_*"))


@pytest.mark.parametrize("name", ["extract-features", "hessian-features"])
def test_cli_runs_on_the_cpu_when_asked(no_card, nifti_pair, name):
    no_card.setenv("IFE_PLATFORM", "cpu")
    assert main(_cli(nifti_pair, name, "out_")) == 0
    assert list(nifti_pair.glob("out_*"))


TRANSFORM_CLI = {
    "masked-image-filter": ["-i", "img.nii.gz", "-m", "mask.nii.gz"],
    "extract-masked-region": ["-m", "mask.nii.gz", "--include", "1"],
    "extract-window": ["-i", "img2d.nii.gz", "-b", "1"],
    "resample": ["-s", "img.nii.gz", "-t", "mask.nii.gz"],
}


def _transform_cli(d, name, out):
    if not (d / "img2d.nii.gz").exists():
        img = synthetic_ct(SHAPE, seed=5).data[:, :, 3:4].contiguous()
        write_volume(str(d / "img2d.nii.gz"), Volume(img, spacing=SPACING))
    return [name, *(str(d / a) if a.endswith(".nii.gz") else a
                    for a in TRANSFORM_CLI[name]), "-o", str(d / out)]


@pytest.mark.parametrize("name", sorted(TRANSFORM_CLI))
def test_transform_cli_fails_without_a_card_and_names_the_variable(
        no_card, nifti_pair, capsys, name):
    assert main(_transform_cli(nifti_pair, name, "refused.nii.gz")) == 1
    assert "IFE_PLATFORM=cpu" in capsys.readouterr().err
    assert not list(nifti_pair.glob("refused*"))


@pytest.mark.parametrize("name", sorted(TRANSFORM_CLI))
def test_transform_cli_runs_on_the_cpu_when_asked(no_card, nifti_pair, name):
    no_card.setenv("IFE_PLATFORM", "cpu")
    assert main(_transform_cli(nifti_pair, name, "out.nii.gz")) == 0
    assert (nifti_pair / "out.nii.gz").exists()


def test_no_module_picks_the_cpu_by_itself():
    """`is_available` appears only where default_device raises and in the
    profiler's synchronise guard."""
    import pathlib

    import ife_tpu_torch

    root = pathlib.Path(ife_tpu_torch.__file__).parent
    hits = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if "is_available" in p.read_text())
    assert hits == ["parallel/mesh.py", "utils/profiling.py"]
