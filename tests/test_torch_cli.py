"""The port's CLI against ife_tpu's on the same tiny NIfTI files: output
files agree in f32 within the per-channel budget of docs/design.md, and the
bag tools' hist specs, bags and ROI files agree with ife_tpu's; the other
ROI tools, the converters, merge-bags, expected-distance and image-browser
write the same files, arrays or text (tests/test_torch_transform.py holds
the image tools), convert-dicom writes the same files from the same DICOM
series; plus the package-level contracts (no JAX import, TF32 off,
`python -m` entry, the registry: ife_tpu's)."""
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ife_tpu.cli.commands import REGISTRY as J_REGISTRY
from ife_tpu.cli.main import main as j_main
from ife_tpu.core.volume import Volume as JVolume
from ife_tpu.core.volume import sphere_mask, synthetic_ct
from ife_tpu.io import read_volume as j_read, write_volume as j_write
from ife_tpu.io import read_hist_spec, write_hist_spec, write_hr2, write_octave
from ife_tpu.io.text import write_matrix_csv
from ife_tpu.ops.features import FEATURE_NAMES, features8_auto
from ife_tpu_torch.cli import commands as TC
from ife_tpu_torch.cli.main import main as t_main
from ife_tpu_torch.io import read_volume as t_read
from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 14, 12)
SPACING = (0.78, 0.78, 1.0)
# docs/design.md:495-504 per-channel f32 bounds, relative to channel scale
F32_BUDGET = dict(zip(FEATURE_NAMES, (1e-6, 2e-6, 1e-5, 1e-5, 2.4e-5, 1.5e-5,
                                      1.5e-5, 1.3e-5)))
HESS_NAMES = ("Eigenvalue1", "Eigenvalue2", "Eigenvalue3",
              "LaplacianOfGaussian", "GaussianCurvature", "FrobeniusNorm")


@pytest.fixture(autouse=True, scope="module")
def ask_for_the_cpu():
    """The port runs on the card unless asked: these tests ask for the CPU
    (the subprocesses inherit the variable)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IFE_PLATFORM", "cpu")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    img = synthetic_ct(SHAPE, seed=7)
    j_write(str(d / "img.nii.gz"), JVolume(img.data, spacing=SPACING))
    # labels 0/1/2: the features8 paths clamp them
    mask = np.asarray(sphere_mask(SHAPE, 0.42).data).astype(np.uint8)
    mask[: SHAPE[0] // 2] *= 2
    j_write(str(d / "mask.nii.gz"), JVolume(jnp.asarray(mask), spacing=SPACING))
    # a noise image (no exactly repeated Hessian eigenvalues) and a
    # continuous, unclamped certainty
    rng = np.random.default_rng(3)
    noise = (rng.standard_normal(SHAPE) * 200.0 - 600.0).astype(np.float32)
    j_write(str(d / "noise.nii.gz"), JVolume(jnp.asarray(noise), spacing=SPACING))
    cert = rng.uniform(0.0, 2.0, SHAPE).astype(np.float32)
    cert[:, :, :3] = 0.0
    j_write(str(d / "cert.nii.gz"), JVolume(jnp.asarray(cert), spacing=SPACING))
    return d


def _run(main, *argv):
    rc = main([str(a) for a in argv])
    assert rc == 0, argv


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _load_pair(d, t_name, j_name):
    t = t_read(str(d / t_name))
    j = j_read(str(d / j_name))
    assert t.spacing == j.spacing and t.origin == j.origin
    return t.numpy().astype(np.float64), np.asarray(j.data, np.float64)


def _eig_err(d, t_fmt, j_fmt, names, tol):
    """max|t - j| / max(max|j|, 1) over the three eigenvalue files, the
    port's against ife_tpu's: per channel where j's adjacent |e_k| differ by
    more than 2 * tol of that scale, as value-sorted triples where they tie
    (tie_sorted_eigenvalues)."""
    t = [torch.from_numpy(t_read(str(d / t_fmt.format(n))).numpy()
                          .astype(np.float64)) for n in names]
    j = [torch.from_numpy(np.asarray(j_read(str(d / j_fmt.format(n))).data,
                                     np.float64)) for n in names]
    scale = max(max(x.abs().max().item() for x in j), 1.0)
    ts, js = tie_sorted_eigenvalues(t, j, 2 * tol * scale)
    return max((a - b).abs().max().item() for a, b in zip(ts, js)) / scale


def test_extract_features_matches_ife_tpu(workdir):
    d = workdir
    args = ["-i", d / "img.nii.gz", "-m", d / "mask.nii.gz", "-s", "0.6", "1.2"]
    _run(t_main, "extract-features", *args, "-o", d / "t_feat")
    _run(j_main, "extract-features", *args, "-o", d / "j_feat")
    for s in ("0.6", "1.2"):
        for name in FEATURE_NAMES:
            t, j = _load_pair(d, f"t_feat_scale_{s}{name}.nii.gz",
                              f"j_feat_scale_{s}{name}.nii.gz")
            assert t.shape == SHAPE
            if name not in ("Eigenvalue1", "Eigenvalue2", "Eigenvalue3"):
                assert _rel(t, j) < F32_BUDGET[name], (s, name)
        err = _eig_err(d, f"t_feat_scale_{s}{{}}.nii.gz",
                       f"j_feat_scale_{s}{{}}.nii.gz", FEATURE_NAMES[2:5],
                       F32_BUDGET["Eigenvalue1"])
        assert err < F32_BUDGET["Eigenvalue1"], (s, err)


@pytest.mark.parametrize("fused", [False, True])
def test_hessian_features_match_ife_tpu(workdir, fused):
    d = workdir
    args = ["-i", d / "noise.nii.gz", "-m", d / "mask.nii.gz"]
    tag = "f" if fused else "p"
    _run(t_main, "hessian-features", *args, "-o", d / f"t_hess{tag}_",
         *(["--fused"] if fused else []))
    if not (d / "j_hess_Eigenvalue1.nii.gz").exists():
        _run(j_main, "hessian-features", *args, "-o", d / "j_hess_")
    for name in HESS_NAMES[3:]:
        t, j = _load_pair(d, f"t_hess{tag}_{name}.nii.gz", f"j_hess_{name}.nii.gz")
        assert _rel(t, j) < 1e-5, name
    err = _eig_err(d, f"t_hess{tag}_{{}}.nii.gz", "j_hess_{}.nii.gz",
                   HESS_NAMES[:3], 1e-5)
    assert err < 1e-5, err


@pytest.mark.parametrize("mask_output", [False, True])
def test_masked_normalized_convolution_matches_ife_tpu(workdir, mask_output):
    d = workdir
    flag = ["--mask-output"] if mask_output else []
    args = ["-i", d / "img.nii.gz", "-c", d / "cert.nii.gz", "-s", "0.9", *flag]
    _run(t_main, "masked-normalized-convolution", *args, "-o", d / f"t_nc{mask_output}")
    _run(j_main, "masked-normalized-convolution", *args, "-o", d / f"j_nc{mask_output}")
    t, j = _load_pair(d, f"t_nc{mask_output}scale_0.9.nii.gz",
                      f"j_nc{mask_output}scale_0.9.nii.gz")
    assert np.isfinite(t).all()
    assert _rel(t, j) < F32_BUDGET["GaussianBlur"]


def test_gradient_features_matches_ife_tpu(workdir):
    d = workdir
    args = ["-i", d / "img.nii.gz", "-m", d / "mask.nii.gz"]
    _run(t_main, "gradient-features", *args, "-o", d / "t_grad.nii.gz")
    _run(j_main, "gradient-features", *args, "-o", d / "j_grad.nii.gz")
    t, j = _load_pair(d, "t_grad.nii.gz", "j_grad.nii.gz")
    assert _rel(t, j) < F32_BUDGET["GradientMagnitude"]


def test_sharded_is_refused_and_only_the_slice_is_registered(workdir, capsys):
    # --sharded is no longer refused: four blocks in this process write the
    # files of the unsharded run (on the CPU both compose the same plain ops;
    # the blocked sums differ from the whole-volume pass within the f32
    # per-channel budget)
    d = workdir
    base = ["extract-features", "-i", d / "img.nii.gz", "-m",
            d / "mask.nii.gz", "-s", "1"]
    _run(t_main, *base, "-o", d / "whole")
    _run(t_main, *base, "-o", d / "blocks", "--sharded", "--blocks", "4")
    assert "sharding over 4 blocks" in capsys.readouterr().out
    for name in FEATURE_NAMES:
        a, b = _load_pair(d, f"whole_scale_1{name}.nii.gz",
                          f"blocks_scale_1{name}.nii.gz")
        assert _rel(b, a) < F32_BUDGET[name], name
    assert set(TC.REGISTRY) == set(J_REGISTRY)


def test_python_m_entry_point_runs(workdir):
    d = workdir
    res = subprocess.run(
        [sys.executable, "-m", "ife_tpu_torch", "extract-features",
         "-i", str(d / "img.nii.gz"), "-m", str(d / "mask.nii.gz"),
         "-o", str(d / "pm"), "-s", "1.5"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert "Processing scale 1.5" in res.stdout
    for name in FEATURE_NAMES:
        assert (d / f"pm_scale_1.5{name}.nii.gz").exists()


def test_the_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ife_tpu_torch, ife_tpu_torch.cli.main\n"
        "for m in pkgutil.walk_packages(ife_tpu_torch.__path__, 'ife_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'ife_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_tf32_is_off_after_import():
    import ife_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# ---------------------------------------------------------------------------
# the bag tools: determine-bin-edges -> make-bag [--device], generate-rois
# ---------------------------------------------------------------------------

BAG_SCALES = ("0.6", "1.2")


def _features_f32(d, name, mask_name="mask.nii.gz"):
    """ife_tpu's f32 features of one image at each bag scale, as its CLI
    computes them: [(X, Y, Z, 8)] per scale."""
    vol, mask = j_read(str(d / name)), j_read(str(d / mask_name))
    m = (np.asarray(mask.data) != 0).astype(np.uint8)
    return [np.asarray(features8_auto(jnp.asarray(vol.data, jnp.float32),
                                      jnp.asarray(m), float(s), vol.spacing))
            for s in BAG_SCALES], m


@pytest.fixture(scope="module")
def bin_edges(workdir):
    d = workdir
    (d / "pairs.txt").write_text(f"{d / 'noise.nii.gz'},{d / 'mask.nii.gz'}\n"
                                 f"{d / 'img.nii.gz'} , {d / 'mask.nii.gz'}\n")
    args = ["-l", d / "pairs.txt", "-s", *BAG_SCALES, "--bins", "6",
            "--foreground", "1", "2", "--samples", "400", "--seed", "5"]
    _run(t_main, "determine-bin-edges", *args, "-o", d / "t_spec.txt")
    _run(j_main, "determine-bin-edges", *args, "-o", d / "j_spec.txt")
    return d / "t_spec.txt", d / "j_spec.txt"


def test_determine_bin_edges_matches_ife_tpu(workdir, bin_edges):
    # Each edge is one sampled feature value (the same sample indices: the
    # same seed and count); an f32 feature differs from ife_tpu's by at most
    # the channel's f32 budget times its scale, and a quantile of perturbed
    # samples moves by no more than the largest perturbation. So each row
    # is held to that budget, relative to the channel's scale over both
    # images.
    t_path, j_path = bin_edges
    t_lines = t_path.read_text().splitlines()
    assert t_lines[:2] == j_path.read_text().splitlines()[:2]
    t_rows, j_rows = read_hist_spec(str(t_path)), read_hist_spec(str(j_path))
    assert len(t_rows) == 16 and all(r.size == 5 for r in t_rows)
    scale = np.zeros((2, 8))
    for name in ("noise.nii.gz", "img.nii.gz"):
        feats, m = _features_f32(workdir, name)
        for i, f in enumerate(feats):
            scale[i] = np.maximum(scale[i], np.abs(f[m != 0]).max(0))
    for h, (t, j) in enumerate(zip(t_rows, j_rows)):
        i, k = divmod(h, 8)
        err = np.abs(t - j).max() / max(scale[i, k], 1.0)
        assert err <= F32_BUDGET[FEATURE_NAMES[k]], (h, err)


@pytest.mark.parametrize("device", [False, True])
def test_make_bag_matches_ife_tpu(workdir, bin_edges, device):
    # Both CLIs bin with the one spec ife_tpu wrote, on the same ROIs (same
    # seed). A voxel whose f32 feature lies within the channel's f32 budget
    # of an edge may bin differently in the two packages; every histogram
    # without such a voxel must be equal to the bit, and the others may
    # differ by at most (such voxels) / (masked voxels) per bin.
    d = workdir
    _, spec = bin_edges
    flag = ["--device"] if device else []
    args = ["-i", d / "noise.nii.gz", "-m", d / "mask.nii.gz", "-b", spec,
            "-s", *BAG_SCALES, "-n", "6", "--roi-size", "5,6,4", "--seed", "0",
            *flag]
    _run(t_main, "make-bag", *args, "-o", d / f"t_bag{device}")
    _run(j_main, "make-bag", *args, "-o", d / f"j_bag{device}")
    _assert_bags_agree(d, f"t_bag{device}", f"j_bag{device}", spec,
                       "noise.nii.gz", "mask.nii.gz", (6, 16 * 6))


def _assert_bags_agree(d, t_prefix, j_prefix, spec, image, mask, shape):
    """The two CLIs' <prefix>.ROIInfo equal byte for byte, and their bags
    within the f32 per-channel budget: a voxel whose f32 feature lies within
    the channel's budget of an edge may bin differently in the two packages;
    every histogram without such a voxel must be equal to the bit, and the
    others may differ by at most (such voxels) / (masked voxels) per bin."""
    assert ((d / f"{t_prefix}.ROIInfo").read_bytes()
            == (d / f"{j_prefix}.ROIInfo").read_bytes())
    t_bag = np.loadtxt(d / f"{t_prefix}.bag", delimiter=",", ndmin=2)
    j_bag = np.loadtxt(d / f"{j_prefix}.bag", delimiter=",", ndmin=2)
    assert t_bag.shape == j_bag.shape == shape
    rois = TC._get_rois(
        type("A", (), dict(roi_file=str(d / f"{j_prefix}.ROIInfo")))(), None)
    feats, m = _features_f32(d, image, mask)
    edges = read_hist_spec(str(spec))
    n_bins = edges[0].size + 1
    n_exact = 0
    for r, roi in enumerate(rois):
        inside = m[roi.slices()] != 0
        for h, e in enumerate(edges):
            i, k = divmod(h, 8)
            v = feats[i][roi.slices()][..., k][inside]
            scale = max(np.abs(feats[i][..., k][m != 0]).max(), 1.0)
            tol = F32_BUDGET[FEATURE_NAMES[k]] * scale
            near = int((np.abs(v[:, None] - e[None, :]) <= tol).any(1).sum())
            cols = slice(h * n_bins, (h + 1) * n_bins)
            got, want = t_bag[r, cols], j_bag[r, cols]
            if near == 0:
                n_exact += 1
                np.testing.assert_array_equal(got, want, err_msg=f"roi {r} hist {h}")
            else:
                assert np.abs(got - want).max() <= near / v.size + 1e-6
    # the edges are sampled feature values, so some ROIs hold a voxel at an
    # edge; most histograms still have none
    assert n_exact >= 0.5 * len(rois) * len(edges)


def test_generate_rois_matches_ife_tpu(workdir):
    d = workdir
    args = ["-m", d / "mask.nii.gz", "-n", "7", "--size", "5,3,4",
            "--mask-value", "2", "--seed", "3"]
    _run(t_main, "generate-rois", *args, "-o", d / "t.roi")
    _run(j_main, "generate-rois", *args, "-o", d / "j.roi")
    assert (d / "t.roi").read_bytes() == (d / "j.roi").read_bytes()
    assert len((d / "t.roi").read_text().splitlines()) == 7


def test_host_modules_import_without_jax():
    code = (
        "import sys\n"
        "import ife_tpu_torch.roi, ife_tpu_torch.stats, ife_tpu_torch.io\n"
        "import ife_tpu_torch.roi.bagged_dataset, ife_tpu_torch.stats.distance\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'ife_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# the other bag / ROI tools, the converters, merge-bags, expected-distance
# and image-browser: the same files, text or arrays as ife_tpu's CLI
# ---------------------------------------------------------------------------

def _both(d, name, *args, out):
    """Run `name` in both CLIs, each with its own -o; returns the paths."""
    _run(t_main, name, *args, "-o", d / f"t_{out}")
    _run(j_main, name, *args, "-o", d / f"j_{out}")
    return d / f"t_{out}", d / f"j_{out}"


def _same_file(a, b):
    """Byte for byte (a .gz file's content: its header holds the file's
    name and time)."""
    read = gzip.open if str(a).endswith(".gz") else open
    with read(a, "rb") as fa, read(b, "rb") as fb:
        got = fa.read()
        assert got and got == fb.read(), (a, b)


@pytest.fixture(scope="module")
def small_mask(workdir):
    """A mask of a few hundred voxels: make-bag-dense makes one ROI per
    foreground voxel."""
    m = np.asarray(sphere_mask(SHAPE, 0.3).data).astype(np.uint8)
    j_write(str(workdir / "small_mask.nii.gz"),
            JVolume(jnp.asarray(m), spacing=SPACING))
    assert 100 <= int(m.sum()) <= 600
    return "small_mask.nii.gz"


def test_make_bag_dense_matches_ife_tpu(workdir, bin_edges, small_mask):
    d = workdir
    _, spec = bin_edges
    t, _ = _both(d, "make-bag-dense", "-i", d / "noise.nii.gz", "-m",
                 d / small_mask, "-b", spec, "-s", *BAG_SCALES,
                 "--roi-size", "3,3,3", out="dense")
    n = len((d / "j_dense.ROIInfo").read_text().splitlines())
    assert n > 50
    _assert_bags_agree(d, "t_dense", "j_dense", spec, "noise.nii.gz",
                       small_mask, (n, 16 * 6))


@pytest.mark.parametrize("rois", ["seed", "file"])
def test_make_bag_only_intensity_matches_ife_tpu(workdir, rois):
    d = workdir
    write_hist_spec(str(d / "int_spec.txt"), [np.array([-900.0, -700.0,
                                                        -500.0, -300.0])])
    if rois == "seed":
        src = ["-n", "9", "--roi-size", "5,4,3", "--seed", "4"]
    else:
        _run(j_main, "generate-rois", "-m", d / "mask.nii.gz", "-o",
             d / "int.roi", "-n", "5", "--size", "3,5,4", "--seed", "1")
        src = ["-r", d / "int.roi"]
    _both(d, "make-bag-only-intensity", "-i", d / "img.nii.gz", "-m",
          d / "mask.nii.gz", "-b", d / "int_spec.txt", *src, out=f"int_{rois}")
    for ext in (".bag", ".ROIInfo"):
        _same_file(d / f"t_int_{rois}{ext}", d / f"j_int_{rois}{ext}")
    bag = np.loadtxt(d / f"t_int_{rois}.bag", delimiter=",", ndmin=2)
    assert bag.shape[1] == 5 and np.allclose(bag.sum(1), 1.0)


def test_make_bag_only_intensity_refuses_a_multi_row_spec(workdir, bin_edges):
    d = workdir
    _, spec = bin_edges
    argv = ["make-bag-only-intensity", "-i", str(d / "img.nii.gz"), "-m",
            str(d / "mask.nii.gz"), "-b", str(spec), "-o", str(d / "no")]
    assert t_main(argv) == j_main(argv) == 1


@pytest.mark.parametrize("labels", [[], ["--labels", "2"]])
def test_generate_rois_many_regions_matches_ife_tpu(workdir, labels):
    d = workdir
    tag = "".join(labels[1:]) or "all"
    _both(d, "generate-rois-many-regions", "-m", d / "mask.nii.gz", "-n",
          "6", "--size", "3,4,5", "--seed", "2", *labels, out=f"many{tag}")
    want = sorted(p.name[2:] for p in d.glob(f"j_many{tag}_*.ROIInfo"))
    assert want == ([f"many{tag}_2.ROIInfo"] if labels else
                    [f"many{tag}_1.ROIInfo", f"many{tag}_2.ROIInfo"])
    assert sorted(p.name[2:] for p in d.glob(f"t_many{tag}_*.ROIInfo")) == want
    for name in want:
        _same_file(d / f"t_{name}", d / f"j_{name}")


@pytest.fixture(scope="module")
def roi_file(workdir):
    _run(j_main, "generate-rois", "-m", workdir / "mask.nii.gz", "-o",
         workdir / "same.roi", "-n", "7", "--size", "5,3,4", "--seed", "8")
    return workdir / "same.roi"


def test_sample_rois_matches_ife_tpu(workdir, roi_file):
    d = workdir
    _both(d, "sample-rois", "-i", d / "img.nii.gz", "-r", roi_file,
          out="samples.csv")
    _same_file(d / "t_samples.csv", d / "j_samples.csv")
    assert len((d / "t_samples.csv").read_text().splitlines()) == 7


@pytest.mark.parametrize("flags", [[], ["--ignore", "0"],
                                   ["--ignore", "1", "--dominant", "2",
                                    "--dominant-threshold", "0.3"]])
def test_extract_labels_matches_ife_tpu(workdir, roi_file, flags):
    d = workdir
    tag = "_".join(flags).replace("-", "").replace(".", "")
    _both(d, "extract-labels", "-l", d / "mask.nii.gz", "-r", roi_file, *flags,
          out=f"labels{tag}.txt")
    _same_file(d / f"t_labels{tag}.txt", d / f"j_labels{tag}.txt")


@pytest.mark.parametrize("fmt", ["hr2", "octave"])
def test_converters_match_ife_tpu(workdir, fmt):
    d = workdir
    vol = j_read(str(d / "noise.nii.gz"))
    if fmt == "hr2":
        src, name = d / "noise.hr2", "convert-hr2"
        write_hr2(str(src), vol)
    else:
        src, name = d / "noise.mat", "convert-from-octave"
        write_octave(str(src), JVolume(jnp.asarray(vol.data)[:7, :6, :5]))
    _run(t_main, name, src, d / f"t_conv_{fmt}.nii.gz")
    _run(j_main, name, src, d / f"j_conv_{fmt}.nii.gz")
    _same_file(d / f"t_conv_{fmt}.nii.gz", d / f"j_conv_{fmt}.nii.gz")


def test_convert_dicom_matches_ife_tpu(workdir, capsys):
    from ife_tpu_torch import native_lib
    from tests.test_torch_dicom import (EXPLICIT, JPEG_LL, JPEG_LS, ct_slice,
                                        dicom_file)

    d = workdir / "dicom_in"
    d.mkdir()
    rng = np.random.default_rng(9)
    for k, ts in enumerate((EXPLICIT, JPEG_LL, JPEG_LS)):
        for z in range(3):
            (d / f"{k}_{z}.dcm").write_bytes(dicom_file(
                ts, ct_slice(rng, (10, 12), np.int16), 1.25 * z,
                uid=f"1.2.3.{k}".encode(), patient=f"P{k}".encode(),
                fragments=2 if ts == JPEG_LL else 1))
    native_lib.reset_counts()
    capsys.readouterr()
    _run(t_main, "convert-dicom", "-d", d, "-o", workdir / "t_dcm")
    t_out = capsys.readouterr().out
    assert native_lib.CALLS["jll_decode"] == native_lib.CALLS["jls_decode"] == 3
    assert native_lib.FALLBACKS == {"jll_decode": 0, "jls_decode": 0}
    _run(j_main, "convert-dicom", "-d", d, "-o", workdir / "j_dcm")
    j_out = capsys.readouterr().out
    names = sorted(os.listdir(workdir / "t_dcm"))
    assert names == sorted(os.listdir(workdir / "j_dcm")) == [
        f"P{k}_20260817_B30f_1.25.nii.gz" for k in range(3)]
    for n in names:
        _same_file(workdir / "t_dcm" / n, workdir / "j_dcm" / n)
    assert t_out.replace("t_dcm", "j_dcm") == j_out
    assert t_out.count("wrote ") == 3


def test_merge_bags_matches_ife_tpu(workdir):
    from ife_tpu_torch.roi.bagged_dataset import load_bagged_dataset

    d = workdir
    rng = np.random.default_rng(21)
    bags, inst = [], []
    for b, n in enumerate((4, 2, 5)):
        bags.append(d / f"mb{b}.bag")
        write_matrix_csv(str(bags[-1]), rng.uniform(size=(n, 6)))
        inst.append(d / f"mb{b}.lab")
        write_matrix_csv(str(inst[-1]), rng.integers(0, 3, (n, 1)))
    write_matrix_csv(str(d / "mb.lab"), np.array([[1.0], [0.0], [1.0]]))
    _both(d, "merge-bags", "-b", *bags, "--bag-labels", d / "mb.lab",
          "--instance-labels", *inst, out="merged.npz")
    t = load_bagged_dataset(str(d / "t_merged.npz"))
    with np.load(d / "j_merged.npz", allow_pickle=False) as z:
        j = {k: z[k] for k in z.files}
    assert sorted(t) == sorted(j) == ["bag_index", "bag_labels", "bag_names",
                                      "instance_labels", "instances"]
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["instances"].shape == (11, 6)


def test_merge_bags_refuses_mismatched_labels(workdir):
    d = workdir
    write_matrix_csv(str(d / "mb_one.bag"), np.ones((3, 2)))
    argv = ["merge-bags", "-b", str(d / "mb_one.bag"), "-o", str(d / "x.npz"),
            "--instance-labels", str(d / "mb_one.bag"), str(d / "mb_one.bag")]
    assert t_main(argv) == j_main(argv) == 1


def _stdout(main, capsys, *argv):
    capsys.readouterr()
    _run(main, *argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("mask", ["mask.nii.gz", "empty.nii.gz"])
def test_expected_distance_prints_what_ife_tpu_prints(workdir, capsys, mask):
    d = workdir
    if mask == "empty.nii.gz":
        j_write(str(d / mask), JVolume(jnp.zeros(SHAPE, jnp.uint8),
                                       spacing=SPACING))
    argv = ["expected-distance", "-m", d / mask, "-p", d / "cert.nii.gz"]
    got = _stdout(t_main, capsys, *argv)
    assert got == _stdout(j_main, capsys, *argv)
    assert float(got) != 0.0 or mask == "empty.nii.gz"


def test_distance_module_needs_scipy(monkeypatch):
    # scipy is imported at the top, as in ife_tpu: without it the module
    # raises ImportError on import, never a silent other answer
    import importlib

    monkeypatch.setitem(sys.modules, "scipy", None)
    monkeypatch.delitem(sys.modules, "ife_tpu_torch.stats.distance",
                        raising=False)
    with pytest.raises(ImportError):
        importlib.import_module("ife_tpu_torch.stats.distance")


@pytest.mark.parametrize("image,cmd", [("img.nii.gz", "info"),
                                       ("img.nii.gz", "hist"),
                                       ("mask.nii.gz", "hist"),
                                       ("mask.nii.gz", "coverage")])
def test_image_browser_prints_what_ife_tpu_prints(workdir, capsys, image, cmd):
    argv = ["image-browser", "-i", workdir / image, "--cmd", cmd,
            "--roi-size", "5,5,3", "--coverage-samples", "40"]
    got = _stdout(t_main, capsys, *argv)
    assert got == _stdout(j_main, capsys, *argv)
    if cmd == "info":
        assert "dtype: float32\n" in got


def test_image_browser_repl_prints_what_ife_tpu_prints(workdir, capsys,
                                                       monkeypatch):
    argv = ["image-browser", "-i", workdir / "mask.nii.gz", "--roi-size",
            "5,5,3", "--coverage-samples", "40"]
    outs = []
    for main in (t_main, j_main):
        monkeypatch.setattr(sys, "stdin",
                            io.StringIO("info\n\nbogus\nhist\ncoverage\n"
                                        "quit\ninfo\n"))
        outs.append(_stdout(main, capsys, *argv))
    assert outs[0] == outs[1]
    assert outs[0].count("shape:") == 1 and "unknown command 'bogus'" in outs[0]
