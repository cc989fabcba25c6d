"""PyTorch port, planning and preprocessing: ``planning/preprocess.py``,
``fingerprint.py``, ``planner.epochs_multiplier``, ``standalone.py`` and
the ``medimgen_torch_plan_and_preprocess`` CLI (``planning/cli.py``)
against the JAX package's, on seeded NumPy inputs and on a raw MSD-style
task of patients of several sizes and two spacings (some wider than the
median, so preprocessing resamples and writes chunks that split the last
axis).

Every function of preprocess / fingerprint / the planner is held exactly
(the same NumPy / SciPy calls on the same inputs), except the class
locations, which are random unless a generator is passed: with one seeded
generator they are equal; from ``process_patient`` they are compared as
sets inside the label's foreground with min(n, 50) voxels a class a slice.
Preprocessed volumes are compared with the JAX native codec off (its
writer stores wrong voxels for chunks that split the last axis, which the
last test pins). The Laplacian screen equals the JAX package's with OpenCV
installed (and ``scipy.ndimage.laplace`` in ``mirror`` mode), not its
NumPy fallback, which screens the interior only."""

import argparse
import json
import os
import pickle

import numpy as np
import pytest
import yaml
from scipy import ndimage

from medical_image_generation_tpu.io import volstore as jvs
from medical_image_generation_tpu.planning import cli as jcli
from medical_image_generation_tpu.planning import fingerprint as jfp
from medical_image_generation_tpu.planning import planner as jplanner
from medical_image_generation_tpu.planning import preprocess as jpre
from medical_image_generation_tpu.planning import standalone as jstandalone
from medical_image_generation_tpu_torch.io import volstore as tvs
from medical_image_generation_tpu_torch.io.nifti import load_nifti, save_nifti
from medical_image_generation_tpu_torch.planning import cli as tcli
from medical_image_generation_tpu_torch.planning import fingerprint as tfp
from medical_image_generation_tpu_torch.planning import memory as tmemory
from medical_image_generation_tpu_torch.planning import planner as tplanner
from medical_image_generation_tpu_torch.planning import preprocess as tpre
from medical_image_generation_tpu_torch.planning import standalone as tstandalone
from synth import make_synthetic_dataset
from test_torch_io import _no_native

# NIfTI (X, Y, Z) shapes and spacings of the raw task: the cropped median is
# X = 24, and patients 2 and 4 are wider; patient 3 has another spacing
RAW_SHAPES = [(24, 22, 16), (22, 24, 14), (30, 20, 16), (24, 26, 18), (28, 24, 15)]
RAW_SPACINGS = [(1.0, 1.0, 1.5), (1.0, 1.0, 1.5), (1.0, 1.0, 1.5), (1.25, 1.0, 1.5),
                (1.0, 1.0, 1.5)]


def raw_task(root, task="Task097_Plan", n=5, seed=0):
    """A raw TaskXXX_Name dataset (imagesTr/ + labelsTr/ .nii.gz): noisy
    images with a zero border of 2 voxels and two labelled spheres."""
    rng = np.random.default_rng(seed)
    ds = os.path.join(root, task)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub))
    for i in range(n):
        inner = RAW_SHAPES[i]
        shape = tuple(s + 4 for s in inner)
        img = np.zeros(shape, np.float32)
        img[2:-2, 2:-2, 2:-2] = rng.normal(300.0, 40.0, inner).clip(1.0, None)
        lbl = np.zeros(shape, np.uint8)
        xs, ys, zs = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij", sparse=True)
        for cls in (1, 2):
            c = [int(rng.integers(s // 3, 2 * s // 3)) for s in shape]
            r = int(rng.integers(3, 6))
            m = (xs - c[0]) ** 2 + (ys - c[1]) ** 2 + (zs - c[2]) ** 2 <= r * r
            img[m] += 150.0 * cls
            lbl[m] = cls
        affine = np.diag(list(RAW_SPACINGS[i]) + [1.0])
        save_nifti(os.path.join(ds, "imagesTr", f"p{i:03d}.nii.gz"), img, affine)
        save_nifti(os.path.join(ds, "labelsTr", f"p{i:03d}.nii.gz"), lbl, affine)
    return ds


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return raw_task(str(tmp_path_factory.mktemp("raw")))


def _arr(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


# ------------------------------------------------------------- preprocess


@pytest.mark.parametrize("spacing", [(1, 1, 1), (1, 1, 3), (1, 1, 3.5), (0.5, 2.0, 1.0),
                                     (5, 1, 1)])
def test_is_anisotropic_equals_jax(spacing):
    assert tpre.is_anisotropic(spacing) == jpre.is_anisotropic(spacing)


@pytest.mark.parametrize("case", ["box", "label", "empty"])
def test_crop_to_nonzero_equals_jax(case):
    img = np.zeros((9, 10, 11), np.float32)
    if case != "empty":
        img[2:6, 3:9, 1:4] = _arr((4, 6, 3), 1) + 0.1
    lbl = (img > 0.5).astype(np.uint8) if case == "label" else None
    got, ref = tpre.crop_to_nonzero(img, lbl), jpre.crop_to_nonzero(img, lbl)
    np.testing.assert_array_equal(got[0], ref[0])
    assert (got[1] is None) == (ref[1] is None)
    if lbl is not None:
        np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("orig,target", [((1, 1, 1), (1, 1, 1)), ((1.0, 1.25, 1.5), (1, 1, 1)),
                                         ((1, 1, 4), (1, 1, 2)), ((0.8, 0.8, 3.5), (1, 1, 2))])
def test_resample_image_and_label_equal_jax(orig, target):
    """Exact: the same scipy.ndimage.zoom calls in the same order (cubic
    image, nearest on the low-resolution axis of anisotropic spacings;
    labels one-hot + linear + argmax), and a background-only label."""
    img = _arr((12, 10, 7), 2).astype(np.float32)
    np.testing.assert_array_equal(tpre.resample_image(img, orig, target),
                                  jpre.resample_image(img, orig, target))
    lbl = np.zeros((12, 10, 7), np.int32)
    lbl[3:8, 2:7, 1:5] = 1
    lbl[5:7, 4:6, 2:4] = 2
    for label in (lbl, np.zeros_like(lbl)):
        got = tpre.resample_label(label, orig, target)
        ref = jpre.resample_label(label, orig, target)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fn", ["normalize_zscore_then_minmax",
                                "normalize_foreground_percentiles",
                                "normalize_zscore_then_clip_then_minmax"])
def test_normalisations_equal_jax(fn):
    img = _arr((2, 6, 7, 8), 3, -1.0, 4.0).astype(np.float32)
    img[1] = np.maximum(img[1], 0.0)  # a channel with background
    img[0, 0] = 0.0
    got, ref = getattr(tpre, fn)(img), getattr(jpre, fn)(img)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]


@pytest.mark.parametrize("shape", [(5, 6, 7), (5, 6, 7, 2)])
def test_to_canonical_axes_equals_jax(shape):
    v = _arr(shape, 4)
    np.testing.assert_array_equal(tpre.to_canonical_axes(v), jpre.to_canonical_axes(v))


@pytest.mark.parametrize("per_slice", [50, 3])
def test_sampled_class_locations_equal_jax_with_one_generator(per_slice):
    lbl = np.zeros((6, 20, 20), np.uint8)
    lbl[1:5, 2:15, 3:17] = 1
    lbl[2:4, 5:8, 5:9] = 2
    got = tpre.get_sampled_class_locations(lbl, per_slice, np.random.default_rng(5))
    ref = jpre.get_sampled_class_locations(lbl, per_slice, np.random.default_rng(5))
    assert got == ref and sorted(got) == [1, 2]


def test_properties_pickle_equals_jax(tmp_path):
    props = {"class_locations": {1: [(0, 1, 2)]}, "min_max": [(0.0, 2.5)]}
    tpre.save_properties(str(tmp_path), "a", props)
    jpre.save_properties(str(tmp_path), "b", props)
    assert (tmp_path / "a.pkl").read_bytes() == (tmp_path / "b.pkl").read_bytes()
    assert tpre.load_properties(str(tmp_path), "b") == jpre.load_properties(str(tmp_path), "a")


def _check_class_locations(locs, label_zyx):
    """Every sampled voxel lies in its class, and each class has min(n, 50)
    voxels on every z-slice, n its voxels there."""
    assert sorted(locs) == [int(c) for c in np.unique(label_zyx) if c != 0]
    for cls, coords in locs.items():
        coords = np.asarray(coords).reshape(-1, 3)
        assert (label_zyx[tuple(coords.T)] == cls).all()
        assert len({tuple(c) for c in coords}) == len(coords)
        for z in range(label_zyx.shape[0]):
            n = int((label_zyx[z] == cls).sum())
            assert int((coords[:, 0] == z).sum()) == min(n, 50), (cls, z)


def _process(pkg, raw, out, pid, median_spacing, median_shape):
    img, lbl = os.path.join(out, "imagesTr"), os.path.join(out, "labelsTr")
    os.makedirs(img)
    os.makedirs(lbl)
    res = pkg.process_patient(pid, os.path.join(raw, "imagesTr"), os.path.join(raw, "labelsTr"),
                              img, lbl, median_spacing, median_shape)
    return res, img, lbl


@pytest.mark.parametrize("pid", ["p001", "p002", "p003"])
def test_process_patient_equals_jax(tmp_path, monkeypatch, raw, pid):
    """One patient through both packages (JAX native codec off): the same
    result, volumes and min_max; class locations as the sampling rule
    allows. p002 is wider than the median (its chunks split the last axis);
    p003 is resampled."""
    _no_native(monkeypatch, jvs)
    spacing, shape = (1.0, 1.0, 1.5), (1, 16, 22, 24)
    got, t_img, t_lbl = _process(tpre, raw, str(tmp_path / "t"), pid, spacing, shape)
    ref, j_img, j_lbl = _process(jpre, raw, str(tmp_path / "j"), pid, spacing, shape)
    assert got["log"].replace(str(tmp_path / "t"), "") == ref["log"].replace(str(tmp_path / "j"),
                                                                            "")
    assert (got["shape"], got["labels"]) == (ref["shape"], ref["labels"]) != (None, [])
    for a, b in ((t_img, j_img), (t_lbl, j_lbl)):
        t, j = tvs.VolStore(os.path.join(a, pid + ".vs")), tvs.VolStore(os.path.join(b, pid + ".vs"))
        assert t.chunk_shape == j.chunk_shape
        np.testing.assert_array_equal(t.read_full(), j.read_full())
    label = tvs.VolStore(os.path.join(t_lbl, pid + ".vs")).read_full()
    tp, jp = tpre.load_properties(t_img, pid), jpre.load_properties(j_img, pid)
    assert tp["min_max"] == jp["min_max"]
    _check_class_locations(tp["class_locations"], label)
    _check_class_locations(jp["class_locations"], label)


def test_jax_native_writer_corrupts_patients_wider_than_the_median(tmp_path, raw):
    """The JAX planning CLI's process_patient chunks volumes as (1, 1,
    median_Y, median_X); for a patient wider than the median those chunks
    split the last axis, where the JAX native writer stores wrong voxels
    (io/native/volcodec.cpp:186). The same patient preprocessed by the port
    reads back exactly, through either package's reader."""
    spacing, shape = (1.0, 1.0, 1.5), (1, 16, 22, 24)
    got, t_img, _ = _process(tpre, raw, str(tmp_path / "t"), "p002", spacing, shape)
    _, j_img, _ = _process(jpre, raw, str(tmp_path / "j"), "p002", spacing, shape)
    assert jvs._get_lib() is not None and got["shape"][-1] > shape[-1]
    nii = load_nifti(os.path.join(raw, "imagesTr", "p002.nii.gz")).get_fdata()
    cropped, _, _ = tpre.crop_to_nonzero(nii)
    want, _ = tpre.normalize_zscore_then_minmax(
        tpre.to_canonical_axes(cropped).astype(np.float32))
    assert not np.array_equal(jvs.VolStore(os.path.join(j_img, "p002.vs")).read_full(), want)
    for m in (jvs, tvs):
        np.testing.assert_array_equal(m.VolStore(os.path.join(t_img, "p002.vs")).read_full(),
                                      want)


# ------------------------------------------------------------ fingerprint


@pytest.mark.parametrize("shape", [(64, 64), (17, 40), (2, 7), (1, 5), (5, 1), (1, 1)])
def test_laplacian_variance_equals_jax_with_opencv(monkeypatch, shape):
    """Exact: the port's NumPy Laplacian (3x3 kernel, BORDER_REFLECT_101)
    equals cv2.Laplacian through the JAX module, and
    scipy.ndimage.laplace in mirror mode."""
    monkeypatch.setattr(jfp, "_HAS_CV2", True)
    s = _arr(shape, 6, 0.0, 500.0)
    assert tfp.compute_laplacian_variance(s) == jfp.compute_laplacian_variance(s)
    u8 = np.random.default_rng(7).integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(tfp.laplacian(u8), ndimage.laplace(u8.astype(np.float64),
                                                                       mode="mirror"))


def test_laplacian_variance_differs_from_the_jax_fallback(monkeypatch):
    """Without OpenCV the JAX module takes the stencil over the interior
    only (its border rows are 0), which moves a slice's variance by several
    percent, enough to move a volume across an integer threshold."""
    s = _arr((64, 64), 8, 0.0, 1000.0)
    monkeypatch.setattr(jfp, "_HAS_CV2", False)
    fallback = jfp.compute_laplacian_variance(s)
    port = tfp.compute_laplacian_variance(s)
    assert abs(port - fallback) / port > 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_threshold_equals_jax(seed):
    v = np.concatenate([_arr(200, seed, 0, 1), _arr(100, seed + 10, 3, 5)])
    assert tfp.otsu_threshold(v) == jfp.otsu_threshold(v)


def test_median_spacing_and_fingerprint_one_equal_jax(monkeypatch, raw):
    monkeypatch.setattr(jfp, "_HAS_CV2", True)
    paths = sorted(os.path.join(raw, "imagesTr", f) for f in os.listdir(
        os.path.join(raw, "imagesTr")))
    sp = tfp.calculate_median_spacing(paths)
    assert sp == jfp.calculate_median_spacing(paths, max_workers=0)
    for p in paths[:3]:
        for ch in (None, [0]):
            assert tfp._fingerprint_one(p, sp, ch) == jfp._fingerprint_one(p, sp, ch)


@pytest.mark.parametrize("lq", [None, "otsu", "percentile", 25000, 10**9])
def test_dataset_fingerprint_equals_jax(monkeypatch, raw, lq):
    monkeypatch.setattr(jfp, "_HAS_CV2", True)
    paths = sorted(os.path.join(raw, "imagesTr", f) for f in os.listdir(
        os.path.join(raw, "imagesTr")))
    sp = (1.0, 1.0, 1.5)
    got = tfp.calculate_dataset_fingerprint(paths, sp, None, lq, max_workers=0)
    ref = jfp.calculate_dataset_fingerprint(paths, sp, None, lq, max_workers=0)
    assert got == ref
    if lq == 10**9:
        assert not any(q["pass"] for q in got[-1])


def test_bad_lq_threshold_raises_in_both(raw):
    paths = [os.path.join(raw, "imagesTr", "p000.nii.gz")] * 3
    for m in (tfp, jfp):
        with pytest.raises(ValueError, match="lq_threshold"):
            m.calculate_dataset_fingerprint(paths, (1.0, 1.0, 1.5), None, 2.5, max_workers=0)


@pytest.mark.parametrize("n", [1, 100, 142, 143, 500, 714, 715, 5000])
def test_epochs_multiplier_equals_jax(n):
    assert tplanner.epochs_multiplier(n) == jplanner.epochs_multiplier(n)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("value", ["0 1", "[0,1]", "2", "[3, 4, 5]", "otsu", "percentile",
                                   "40"])
def test_validators_equal_jax(value):
    """Both validators give what the JAX ones give, or both raise
    ArgumentTypeError."""
    for name in ("validate_channels", "validate_lq_threshold"):
        try:
            ref = getattr(jcli, name)(value)
        except argparse.ArgumentTypeError:
            with pytest.raises(argparse.ArgumentTypeError):
                getattr(tcli, name)(value)
        else:
            assert getattr(tcli, name)(value) == ref


def test_flow_list_dumper_equals_jax():
    cfg = {"a": [1, [2, 3]], "b": (4, 5), "c": {"d": [0.5], "e": None, "f": "x"}}
    shared = [1, 2]
    cfg["g"], cfg["h"] = shared, shared  # no anchors
    assert (yaml.dump(cfg, sort_keys=False, Dumper=tcli.FlowListDumper)
            == yaml.dump(cfg, sort_keys=False, Dumper=jcli.FlowListDumper))


def _plan(pkg, raw, root, **kw):
    os.makedirs(root)
    return pkg.plan_and_preprocess(raw, preprocessed_root=root, max_workers=0,
                                   probe_memory=False, **kw)


@pytest.mark.parametrize("lq", [None, "otsu"])
def test_plan_and_preprocess_equals_jax(tmp_path, monkeypatch, raw, lq):
    """The whole CLI on the CPU without the probe: dataset.json and
    medimgen_config.yaml equal as text, every volume equal (JAX native codec
    off), every properties pickle's min_max equal."""
    _no_native(monkeypatch, jvs)
    monkeypatch.setattr(jfp, "_HAS_CV2", True)
    t = _plan(tcli, raw, str(tmp_path / "t"), lq_threshold=lq, device="cpu")
    j = _plan(jcli, raw, str(tmp_path / "j"), lq_threshold=lq)
    assert os.path.basename(t) == os.path.basename(j) == "Task097_Plan"
    for name in ("dataset.json", "medimgen_config.yaml"):
        with open(os.path.join(t, name)) as a, open(os.path.join(j, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(t, "dataset.json")) as f:
        ds = json.load(f)
    assert ds["class_labels"] == [1, 2] and ds["median_spacing"] == [1.0, 1.0, 1.5]
    names = sorted(os.listdir(os.path.join(j, "imagesTr")))
    assert names == sorted(os.listdir(os.path.join(t, "imagesTr")))
    assert len([n for n in names if n.endswith(".vs")]) == ds["n_patients"]
    for sub in ("imagesTr", "labelsTr"):
        for n in sorted(os.listdir(os.path.join(j, sub))):
            if n.endswith(".vs"):
                np.testing.assert_array_equal(
                    tvs.VolStore(os.path.join(t, sub, n)).read_full(),
                    tvs.VolStore(os.path.join(j, sub, n)).read_full(), err_msg=n)
            else:
                with open(os.path.join(t, sub, n), "rb") as a, \
                        open(os.path.join(j, sub, n), "rb") as b:
                    assert pickle.load(a)["min_max"] == pickle.load(b)["min_max"]


def test_plan_and_preprocess_synth_dataset_equals_jax(tmp_path, monkeypatch):
    """tests/synth.py's dataset through both CLIs (max_workers=0)."""
    _no_native(monkeypatch, jvs)
    ds = make_synthetic_dataset(str(tmp_path / "raw"), n_patients=4)
    t = _plan(tcli, ds, str(tmp_path / "t"), device="cpu")
    j = _plan(jcli, ds, str(tmp_path / "j"))
    for name in ("dataset.json", "medimgen_config.yaml"):
        with open(os.path.join(t, name)) as a, open(os.path.join(j, name)) as b:
            assert a.read() == b.read(), name


def test_plan_and_preprocess_in_spawned_workers(tmp_path, raw):
    """The process pools (spawned workers) write what the serial path
    writes."""
    a = _plan(tcli, raw, str(tmp_path / "serial"), device="cpu")
    os.makedirs(tmp_path / "pool")
    b = tcli.plan_and_preprocess(raw, preprocessed_root=str(tmp_path / "pool"), max_workers=2,
                                 probe_memory=False, device="cpu")
    for name in ("dataset.json", "medimgen_config.yaml"):
        with open(os.path.join(a, name)) as f, open(os.path.join(b, name)) as g:
            assert f.read() == g.read()
    for n in sorted(os.listdir(os.path.join(a, "imagesTr"))):
        if n.endswith(".vs"):
            np.testing.assert_array_equal(tvs.VolStore(os.path.join(a, "imagesTr", n)).read_full(),
                                          tvs.VolStore(os.path.join(b, "imagesTr", n)).read_full())


def test_memory_plan_written_into_config(tmp_path, monkeypatch, raw):
    """With the probe on, the chosen batch / accumulation / remat / policy
    land in the YAML as the JAX CLI writes them (its
    tests/test_preprocess.py:158-183): the 2D ddpm batch is the probed AE
    batch, the 3D one twice it."""
    seen = []

    def fake_select(config, model_type, init_batch_size, **kw):
        seen.append((model_type, init_batch_size, kw.get("device")))
        if model_type == "2d":
            return tmemory.MemoryPlan(12, 2, True, "acts")
        return tmemory.MemoryPlan(1, 2, True, "full")

    monkeypatch.setattr(tmemory, "auto_select_hyperparams", fake_select)
    monkeypatch.setattr(tmemory, "require_card", lambda device: device)
    os.makedirs(tmp_path / "pre")
    ds_path = tcli.plan_and_preprocess(raw, preprocessed_root=str(tmp_path / "pre"),
                                       max_workers=0, probe_memory=True, device="cuda")
    assert seen == [("2d", 24, "cuda"), ("3d", 2, "cuda")]
    with open(os.path.join(ds_path, "medimgen_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    c2, c3 = cfg["2D"], cfg["3D"]
    assert (c2["ae_batch_size"], c2["grad_accumulate_step"], c2["ddpm_batch_size"]) == (12, 2, 12)
    assert c2["vae_params"]["use_checkpointing"] is True
    assert c2["vae_params"]["remat_policy"] == "acts"
    assert (c3["ae_batch_size"], c3["grad_accumulate_step"], c3["ddpm_batch_size"]) == (1, 2, 2)
    assert c3["vae_params"]["remat_policy"] == "full"


@pytest.mark.parametrize("device,err", [("cpu", ValueError), ("cuda", RuntimeError)])
def test_probe_without_the_card_raises_before_any_work(tmp_path, monkeypatch, raw, device, err):
    """A probe asked for on the CPU (or on CUDA where there is none)
    raises before a directory is made; the JAX CLI would fall back to the
    planner defaults, the port does not."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    os.makedirs(tmp_path / "pre")
    with pytest.raises(err):
        tcli.plan_and_preprocess(raw, preprocessed_root=str(tmp_path / "pre"), max_workers=0,
                                 probe_memory=True, device=device)
    assert os.listdir(tmp_path / "pre") == []


def test_cli_main_writes_the_plan(tmp_path, monkeypatch, raw):
    """``medimgen_torch_plan_and_preprocess <task> --no-memory-probe``, the
    preprocessed root from ``medimgen_preprocessed``; a second run refuses
    to overwrite."""
    monkeypatch.setenv("medimgen_preprocessed", str(tmp_path))
    tcli.main([raw, "--no-memory-probe", "-lqt", "otsu", "-c", "0"])
    with open(tmp_path / "Task097_Plan" / "medimgen_config.yaml") as f:
        cfg = yaml.safe_load(f)
    assert list(cfg) == ["2D", "3D"] and cfg["3D"]["vae_params"]["use_checkpointing"] is False
    with pytest.raises(FileExistsError):
        tcli.main([raw, "--no-memory-probe"])


# ------------------------------------------------------------- standalone


@pytest.mark.parametrize("cv2_branch", [True, False])
@pytest.mark.parametrize("crop,resample,contrast", [(True, True, True), (False, True, False),
                                                    (True, False, True)])
def test_standalone_preprocess_equals_jax(tmp_path, monkeypatch, cv2_branch, crop, resample,
                                          contrast):
    """The legacy NIfTI -> NIfTI preprocessor, each CLAHE branch (OpenCV,
    or the global-equalisation fallback) against the JAX module's same
    branch: data and affine equal."""
    ds = raw_task(str(tmp_path / "raw"), n=2 if resample else 3)
    monkeypatch.setattr(jstandalone, "_HAS_CV2", cv2_branch)
    monkeypatch.setattr(tstandalone, "_HAS_CV2", cv2_branch)
    kw = dict(crop=crop, resample=resample, contrast=contrast)
    tstandalone.preprocess_dataset(ds, str(tmp_path / "t"), **kw)
    jstandalone.preprocess_dataset(ds, str(tmp_path / "j"), **kw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and names
    for n in names:
        a, b = load_nifti(str(tmp_path / "t" / n)), load_nifti(str(tmp_path / "j" / n))
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.affine, b.affine)


def test_standalone_without_images_raises(tmp_path):
    os.makedirs(tmp_path / "imagesTr")
    with pytest.raises(FileNotFoundError):
        tstandalone.preprocess_dataset(str(tmp_path), str(tmp_path / "out"))
