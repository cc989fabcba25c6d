"""Split management: persisted train/val/test and 5-fold JSON files.

The port's own copy of ``medical_image_generation_tpu/data/splits.py``
(:1-87), without scikit-learn. Reference behaviour (data_processing.py:
33-112): 70/10/20 train-val-test via two seeded splits, or 5-fold KFold
(seed 12345); split files are written next to the preprocessed dataset and
reused if present, so a dataset the JAX package split keeps its split.

The two scikit-learn calls are reproduced with numpy's legacy
``RandomState``, which is what scikit-learn draws from:

* ``train_test_split(ids, test_size=p, random_state=s)``: ``perm =
  RandomState(s).permutation(n)``, ``n_test = ceil(p * n)``, test
  ``perm[:n_test]``, train ``perm[n_test:]``;
* ``KFold(k, shuffle=True, random_state=s)``: ``np.arange(n)`` shuffled in
  place by ``RandomState(s).shuffle``, cut into folds of ``n // k`` (one
  more for the first ``n % k``); each fold's val and train indices in
  sorted index order.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def train_test_split(ids: Sequence[str], test_size: float,
                     random_state: int) -> Tuple[List[str], List[str]]:
    """(train, test) as ``sklearn.model_selection.train_test_split``
    gives them for a list, a float ``test_size`` and an int seed."""
    n = len(ids)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    return [ids[i] for i in perm[n_test:]], [ids[i] for i in perm[:n_test]]


def kfold_indices(n: int, n_splits: int, seed: int):
    """[(train indices, val indices)] as ``KFold(n_splits, shuffle=True,
    random_state=seed).split`` yields them."""
    if n < n_splits:
        raise ValueError(f"cannot split {n} ids into {n_splits} folds")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    out, start = [], 0
    for size in sizes:
        val = np.sort(order[start:start + size])
        mask = np.ones(n, bool)
        mask[val] = False
        out.append((np.flatnonzero(mask), val))
        start += size
    return out


def generate_crossval_split(ids: List[str], seed: int = 12345, n_splits: int = 5):
    splits = []
    for train_idx, val_idx in kfold_indices(len(ids), n_splits, seed):
        splits.append(
            {
                "train": [ids[i] for i in train_idx],
                "val": [ids[i] for i in val_idx],
            }
        )
    return splits


def resolve_preprocessed_path(dataset_id: str, preprocessed_root: Optional[str] = None) -> str:
    root = preprocessed_root or os.getenv("medimgen_preprocessed")
    if not root:
        raise EnvironmentError("set the 'medimgen_preprocessed' environment variable")
    matches = glob.glob(os.path.join(root, f"Task{dataset_id}*/"))
    if not matches:
        raise FileNotFoundError(f"no preprocessed dataset Task{dataset_id}* under {root}")
    return matches[0].rstrip("/")


def create_split_files(
    dataset_id: str,
    splitting: str,
    seed: int = 12345,
    preprocessed_root: Optional[str] = None,
) -> str:
    """Create (or reuse) the split JSON for a preprocessed dataset."""
    ds_path = resolve_preprocessed_path(dataset_id, preprocessed_root)
    images_path = os.path.join(ds_path, "imagesTr")

    name = "splits_train_val_test.json" if splitting == "train-val-test" else "splits_final.json"
    split_path = os.path.join(ds_path, name)
    if os.path.exists(split_path):
        print(f"Split file already exists at {split_path}. Using this for training.")
        return split_path

    files = sorted(glob.glob(os.path.join(images_path, "*.vs")))
    ids = [os.path.basename(f)[: -len(".vs")] for f in files]
    if not ids:
        raise FileNotFoundError(f"no .vs volumes in {images_path}")

    if splitting == "train-val-test":
        train_val, test = train_test_split(ids, test_size=0.2, random_state=seed)
        train, val = train_test_split(train_val, test_size=0.125, random_state=seed)
        split_data: Dict = {"train": train, "val": val, "test": test}
    elif splitting == "5-fold":
        split_data = generate_crossval_split(ids, seed=seed, n_splits=5)
    else:
        raise ValueError("splitting must be 'train-val-test' or '5-fold'")

    with open(split_path, "w") as f:
        json.dump(split_data, f, indent=4)
    print(f"{splitting} splitting file saved at {split_path}")
    return split_path


def get_data_ids(split_file_path: str, fold: Optional[int] = None) -> Dict[str, List[str]]:
    with open(split_file_path) as f:
        split_data = json.load(f)
    if fold is not None:
        entry = split_data[int(fold)]
        train_ids, val_ids = entry["train"], entry["val"]
    else:
        train_ids, val_ids = split_data["train"], split_data["val"]
    print(f"{len(train_ids)} patients for training")
    print(f"{len(val_ids)} patients for validation")
    return {"train": train_ids, "val": val_ids}
