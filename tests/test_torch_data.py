"""PyTorch port, host data pipeline: split files, patch geometry, the batch
scheduler and whole loader epochs against the JAX package, bit for bit, on
the same seeds (the port imports neither the JAX package nor sklearn)."""

import json
import os

import numpy as np
import pytest

from medical_image_generation_tpu.data import loader as jloader
from medical_image_generation_tpu.data import patches as jpatches
from medical_image_generation_tpu.data import splits as jsplits
from medical_image_generation_tpu.io.volstore import write_volume
from medical_image_generation_tpu_torch.data import loader as tloader
from medical_image_generation_tpu_torch.data import patches as tpatches
from medical_image_generation_tpu_torch.data import splits as tsplits


def _ids_dataset(root, n):
    """A dataset directory whose imagesTr holds n (empty) .vs names: the
    split code only lists them."""
    images = root / "Task042_Ids" / "imagesTr"
    images.mkdir(parents=True)
    for i in range(n):
        (images / f"case_{i:03d}.vs").write_bytes(b"")
    return str(root)


@pytest.mark.parametrize("n", range(5, 41))
def test_split_files_equal_jax(tmp_path, n):
    """train-val-test and all five folds, for n ids: the port's split files
    equal the JAX package's (sklearn's train_test_split / KFold)."""
    for splitting in ("train-val-test", "5-fold"):
        files = []
        for pkg, name in ((jsplits, "jax"), (tsplits, "port")):
            root = _ids_dataset(tmp_path / f"{name}_{splitting}", n)
            with open(pkg.create_split_files("042", splitting, preprocessed_root=root)) as f:
                files.append(json.load(f))
        assert files[0] == files[1], splitting
        if splitting == "5-fold":
            assert len(files[1]) == 5
            assert sorted(sum((f["val"] for f in files[1]), [])) == \
                [f"case_{i:03d}" for i in range(n)]


def test_existing_split_file_is_reused(tmp_path):
    root = _ids_dataset(tmp_path, 8)
    custom = {"train": ["case_007"], "val": ["case_001"], "test": []}
    path = os.path.join(root, "Task042_Ids", "splits_train_val_test.json")
    with open(path, "w") as f:
        json.dump(custom, f)
    assert tsplits.create_split_files("042", "train-val-test", preprocessed_root=root) == path
    assert tsplits.get_data_ids(path) == {"train": ["case_007"], "val": ["case_001"]}
    with open(path) as f:
        assert json.load(f) == custom


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("force_fg", [False, True])
def test_get_bbox_equals_jax(dim, force_fg):
    """The same default_rng seeds give the same boxes: enlarged initial
    patches, volumes smaller than the patch, fixed-center (jitter 0) and
    jittered crops, 2D slices, forced foreground."""
    rng = np.random.default_rng(dim * 10 + force_fg)
    for case in range(60):
        data = [int(v) for v in rng.integers(4, 40, size=3)]
        final = [int(v) for v in rng.integers(2, 36, size=3)]
        if dim == 2:
            final[0] = 1
        initial = [f + int(e) for f, e in zip(final, rng.integers(0, 6, size=3))]
        if dim == 2:
            initial[0] = 1
        locs = {1: [tuple(int(v) for v in rng.integers(0, data)) for _ in range(5)], 2: []}
        kw = dict(is_2d=dim == 2, jitter=int(rng.choice([0, 10])), final_patch_size=final)
        j = jpatches.get_bbox(data, initial, force_fg, locs,
                              np.random.default_rng((case, 1)), **kw)
        t = tpatches.get_bbox(data, initial, force_fg, locs,
                              np.random.default_rng((case, 1)), **kw)
        assert t == j, (case, data, initial, final)


def test_oversampling_and_crop_and_pad_equal_jax():
    for bs in (1, 2, 3, 4, 12):
        for ratio in (0.0, 0.33, 0.5, 1.0):
            assert [tpatches.oversample_last_fraction(p, bs, ratio) for p in range(bs)] == \
                [jpatches.oversample_last_fraction(p, bs, ratio) for p in range(bs)]
    j = [jpatches.oversample_probabilistic(0.33, np.random.default_rng(s)) for s in range(50)]
    t = [tpatches.oversample_probabilistic(0.33, np.random.default_rng(s)) for s in range(50)]
    assert t == j and any(t) and not all(t)
    arr = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    for lbs, ubs in (([0, 0, 0], [4, 5, 6]), ([-2, 1, 3], [3, 7, 9]), ([5, 0, 0], [7, 2, 2])):
        np.testing.assert_array_equal(tpatches.crop_and_pad(arr, lbs, ubs),
                                      jpatches.crop_and_pad(arr, lbs, ubs))


@pytest.mark.parametrize("n,bs,shuffle", [(6, 2, True), (5, 3, True), (2, 4, True), (7, 2, False)])
def test_batch_scheduler_epochs_equal_jax(n, bs, shuffle):
    j = jloader.BatchScheduler(n, bs, 9, shuffle, seed=1)
    t = tloader.BatchScheduler(n, bs, 9, shuffle, seed=1)
    for _ in range(4):
        assert t.epoch_batches() == j.epoch_batches()


def _add_labels_and_classes(root):
    """labelsTr volumes (uint8, a foreground cube) and a class map file for
    the preprocessed_dataset fixture."""
    ds = os.path.join(root, "Task099_Synth")
    for i in range(6):
        lbl = np.zeros((12, 24, 24), np.uint8)
        lbl[3:9, 8:16, 8:16] = 1 + i % 2
        write_volume(os.path.join(ds, "labelsTr", f"p{i:03d}.vs"), lbl, chunk_shape=(1, 24, 24))
    with open(os.path.join(ds, "classes.json"), "w") as f:
        json.dump({f"p{i:03d}": i % 3 for i in range(6)}, f)


def _config(variant):
    t = {"patch_size": [8, 16, 16], "rotation": True, "scaling": True,
         "initial_patch_enlargement": True}
    cfg = {"oversample_ratio": 0.33, "num_workers": 3}
    if variant == "class_conditional":
        cfg["class_conditioning"] = {"num_classes": 3, "label_map": "classes.json"}
    elif variant == "labels":
        cfg.update(include_labels=True, n_classes=2)
    elif variant == "probabilistic":
        cfg["probabilistic_oversampling"] = True
    elif variant == "2d":
        t["patch_size"] = [16, 16]
    return cfg, t


@pytest.mark.parametrize("variant", ["plain", "class_conditional", "labels", "probabilistic",
                                     "2d"])
def test_loader_epochs_equal_jax(preprocessed_dataset, variant):
    """The first full train and val epoch of fresh loaders from both
    packages' get_data_loaders: equal batches, bit for bit (images, and the
    class labels of class-conditional batches)."""
    root, ds_id = preprocessed_dataset
    _add_labels_and_classes(root)
    cfg, t = _config(variant)
    model_type = "2d" if variant == "2d" else "3d"
    loaders = [pkg.get_data_loaders(dict(cfg), ds_id, "train-val-test", 2, model_type, t,
                                    preprocessed_root=root, train_steps=7, val_steps=3)
               for pkg in (jloader, tloader)]
    for (jl, tl), section in zip(zip(*loaders), ("train", "val")):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == (7 if section == "train" else 3)
        for a, b in zip(jb, tb):
            if variant == "class_conditional":
                assert set(a) == set(b) == {"image", "class"}
                assert b["class"].dtype == np.int32
                np.testing.assert_array_equal(b["class"], a["class"])
                a, b = a["image"], b["image"]
            assert b.dtype == np.float32 and b.shape == a.shape
            np.testing.assert_array_equal(b, a)
        if variant == "labels":
            assert jb[0].shape[-1] == 2
        if variant == "2d":
            assert jb[0].ndim == 4
    tl = loaders[1][0]
    assert tl.dataset.initial_patch_size != tl.dataset.patch_size  # enlarged training patch
