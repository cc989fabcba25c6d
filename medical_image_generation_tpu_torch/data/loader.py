"""Host-side streaming patch pipeline feeding the card.

The port's own copy of ``medical_image_generation_tpu/data/loader.py``
(:1-457), with the same seeds, so both packages give the same batches, bit
for bit, for a fully consumed epoch of a fresh loader:

* fixed steps-per-epoch batch scheduling (250 train / 50 val) with
  without-replacement resampling across epochs (CustomBatchSampler
  semantics, reference data_processing.py:601-643);
* lazy VolStore bbox reads (native zstd chunk decode) so only the patch's
  chunks are touched;
* a thread-pool prefetcher keeping a queue of ready host batches — threads,
  not processes, because the heavy work (pread + zstd decode + scatter)
  happens in the C++ codec with the GIL released;
* each row's sampling RNG is ``np.random.default_rng((base_seed, pos,
  idx))``: the batch's seed, the row's batch position and the sample index;
* spatial/intensity augmentation is NOT done here — it runs in the train
  step on the card (``data/augment.py``).

Batches are channels-last float32 numpy arrays: (B, *patch, C); 2D batches
squeeze the pseudo-3D z axis (reference data_processing.py:297-300, 590).
The trainer copies each to the card once.

Data parallel (JAX :276-300, :376-427): the global batch is ``batch_size``
times the mesh's data axis, and each rank's loader builds only its
``parallel.mesh.data_axis_rows`` slice of every batch (``row_slice``). The
schedule and every row's RNG are keyed on the GLOBAL row position, so the
union of the ranks' rows is, bit for bit, the batch one process builds. As
in the JAX package, the train loader's seed
counter advances once per batch BUILT, so an iterator abandoned early (the
trainer's latent probe reads one batch) moves it by however far the
producer thread got. The port's checkpoints carry ``PrefetchLoader.state``
(the shuffle RNG and that counter) and a resume restores it after the
probe, so a resumed epoch draws what the uninterrupted run would have.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from medical_image_generation_tpu_torch.data.patches import (
    compute_initial_patch_size,
    crop_and_pad,
    get_bbox,
    oversample_last_fraction,
    oversample_probabilistic,
)
from medical_image_generation_tpu_torch.data.splits import (
    create_split_files,
    get_data_ids,
    resolve_preprocessed_path,
)
from medical_image_generation_tpu_torch.io.volstore import VolStore
from medical_image_generation_tpu_torch.planning.preprocess import load_properties

TRAIN_STEPS_PER_EPOCH = 250  # reference data_processing.py:140
VAL_STEPS_PER_EPOCH = 50  # reference data_processing.py:141


def unpack_batch(batch):
    """(images, class_labels_or_None) from a loader batch — class-conditional
    loaders yield ``{"image", "class"}`` dicts, plain loaders bare arrays."""
    if isinstance(batch, dict):
        return batch["image"], batch.get("class")
    return batch, None


class PatchDataset:
    """Random patch extraction from preprocessed VolStore volumes."""

    def __init__(
        self,
        data_path: str,
        data_ids: Sequence[str],
        batch_size: int,
        patch_size: Sequence[int],
        section: str = "training",
        oversample_ratio: float = 0.33,
        channel_ids: Optional[Sequence[int]] = None,
        include_labels: bool = False,
        n_classes: int = 1,
        class_map: Optional[Dict[str, int]] = None,
        initial_patch_size: Optional[Sequence[int]] = None,
        probabilistic_oversampling: bool = False,
    ):
        """initial_patch_size: the (possibly rotation/scale-enlarged) patch
        the TRAINING section extracts; the device augmentation crops back to
        ``patch_size`` after its spatial transform (reference
        get_initial_patch_size, data_processing.py:339-359). Validation
        always extracts the final size, fixed-center (jitter 0), so the val
        loss that drives best-checkpoint selection is crop-noise-free.

        probabilistic_oversampling: foreground-forcing by independent coin
        instead of batch position (reference data_processing.py:431, ctor
        flag :276).

        include_labels: stack the segmentation (scaled to [0,1] by
        n_classes) as an extra trailing channel — enables joint image+label
        synthesis (BASELINE.json config #5).

        class_map: optional patient-id -> class-index mapping; when set,
        batches become ``{"image": ..., "class": int32 (B,)}`` for
        class-conditional training with classifier-free guidance (a
        capability beyond the reference, which carries class embeddings in
        its UNet fork but never feeds them)."""
        assert section in ("training", "validation")
        self.data_path = data_path
        self.ids = list(data_ids)
        self.batch_size = batch_size
        self.section = section
        self.oversample_ratio = oversample_ratio
        self.channel_ids = list(channel_ids) if channel_ids is not None else None
        self.include_labels = include_labels
        self.n_classes = max(1, int(n_classes))
        self.class_map = dict(class_map) if class_map else None
        if self.class_map is not None:
            missing = [i for i in self.ids if i not in self.class_map]
            if missing:
                raise KeyError(
                    f"class_map missing {len(missing)} patient ids "
                    f"(e.g. {missing[:3]})"
                )

        self.probabilistic_oversampling = bool(probabilistic_oversampling)
        # training crops jitter ±10 around center; validation is fixed-center
        # (reference :850-857 val SpatialTransform is a deterministic center
        # crop — jitter would add noise to the model-selection val loss)
        self.jitter = 10 if section == "training" else 0

        # 2D patches ride as pseudo-3D with z=1 (reference :297-300)
        self.is_2d = len(patch_size) == 2
        self.patch_size = (1, *patch_size) if self.is_2d else tuple(patch_size)
        initial = (
            list(initial_patch_size)
            if (initial_patch_size is not None and section == "training")
            else list(patch_size)
        )
        self.initial_patch_size = (1, *initial) if len(initial) == 2 else tuple(initial)

        self._stores: Dict[str, VolStore] = {}
        self._label_stores: Dict[str, VolStore] = {}
        self._props: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.ids)

    def _open_volume(self, directory: str, name: str):
        """VolStore first, then legacy .npy/.npz fallbacks (the reference's
        load_image fallback chain, data_processing.py:535-559)."""
        vs_path = os.path.join(directory, name + ".vs")
        if os.path.exists(vs_path):
            return VolStore(vs_path)
        npy = os.path.join(directory, name + ".npy")
        if os.path.exists(npy):
            return np.load(npy, mmap_mode="r")
        npz = os.path.join(directory, name + ".npz")
        if os.path.exists(npz):
            return np.load(npz)["data"]
        raise FileNotFoundError(f"no volume for {name} under {directory}")

    def _get(self, name: str) -> Tuple[VolStore, dict]:
        with self._lock:
            if name not in self._stores:
                self._stores[name] = self._open_volume(self.data_path, name)
                self._props[name] = load_properties(self.data_path, name)
            return self._stores[name], self._props[name]

    def _get_label(self, name: str) -> VolStore:
        with self._lock:
            if name not in self._label_stores:
                labels_path = os.path.join(
                    os.path.dirname(self.data_path.rstrip("/")), "labelsTr"
                )
                self._label_stores[name] = self._open_volume(labels_path, name)
            return self._label_stores[name]

    def sample_patch(self, batch_pos: int, sample_idx: int, rng: np.random.Generator) -> np.ndarray:
        name = self.ids[sample_idx]
        store, props = self._get(name)

        if self.section != "training":
            force_fg = False
        elif self.probabilistic_oversampling:
            force_fg = oversample_probabilistic(self.oversample_ratio, rng)
        else:
            force_fg = oversample_last_fraction(
                batch_pos, self.batch_size, self.oversample_ratio
            )
        shape = store.shape[1:]  # drop channel axis
        lbs, ubs = get_bbox(
            shape, self.initial_patch_size, force_fg,
            props.get("class_locations"), rng, is_2d=self.is_2d,
            jitter=self.jitter, final_patch_size=self.patch_size,
        )
        full_lbs = [0] + lbs
        full_ubs = [store.shape[0]] + ubs
        patch = crop_and_pad(store, full_lbs, full_ubs)  # (C, z, y, x)

        if self.channel_ids is not None:
            patch = patch[self.channel_ids]

        if self.include_labels:
            label_store = self._get_label(name)
            label_patch = crop_and_pad(label_store, lbs, ubs)  # (z, y, x)
            label_patch = (label_patch.astype(np.float32) / self.n_classes)[None]
            patch = np.concatenate([patch, label_patch], axis=0)

        if self.is_2d:
            patch = patch[:, 0]  # (C, y, x)
        # channels-last, the layout of the public model API
        patch = np.moveaxis(patch, 0, -1).astype(np.float32)
        return np.clip(patch, 0.0, 1.0)


class BatchScheduler:
    """Fixed-steps-per-epoch index scheduler with without-replacement pools
    (reference CustomBatchSampler, data_processing.py:601-643).

    As in the reference, the pool is rebuilt FRESH each epoch
    (define_indices is called from __iter__), and a residue smaller than one
    batch is discarded at refill — so an unshuffled (validation) schedule
    yields IDENTICAL batches every epoch."""

    def __init__(self, n_samples: int, batch_size: int, number_of_steps: int,
                 shuffle: bool = True, seed: int = 0):
        self.n = n_samples
        self.batch_size = batch_size
        self.number_of_steps = number_of_steps
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def _fresh_pool(self) -> List[int]:
        pool = list(range(self.n))
        if self.shuffle:
            self._rng.shuffle(pool)
        return pool

    def epoch_batches(self) -> List[List[int]]:
        # flat sample order exactly as the reference builds it: refill with a
        # fresh (re)shuffled pool whenever fewer than one batch remains
        # (discarding the residue); datasets smaller than a batch therefore
        # still fill every batch, spanning refills
        total = self.number_of_steps * self.batch_size
        order: List[int] = []
        avail = self._fresh_pool()
        while len(order) < total:
            if len(avail) < self.batch_size:
                avail = self._fresh_pool()
            order.extend(avail[: self.batch_size])
            avail = avail[self.batch_size:]
        bs = self.batch_size
        return [order[i * bs:(i + 1) * bs] for i in range(self.number_of_steps)]


class PrefetchLoader:
    """Iterable over epochs of ready host batches with threaded prefetch."""

    def __init__(
        self,
        dataset: PatchDataset,
        number_of_steps: int,
        shuffle: bool = True,
        num_threads: int = 8,
        prefetch_depth: int = 4,
        seed: int = 0,
        deterministic: bool = False,
        row_slice: Optional[Tuple[int, int]] = None,
    ):
        """deterministic: key every batch's sampling RNG on its position
        WITHIN the epoch instead of a run-global counter, so each epoch
        replays identical crops — the validation setting (with fixed-center
        bboxes, the val loss over frozen params has zero epoch-to-epoch
        variance).

        row_slice: (offset, count) of the rows of each global batch this
        rank builds (``parallel.mesh.data_axis_rows``); None builds them
        all."""
        self.dataset = dataset
        self.number_of_steps = number_of_steps
        self.scheduler = BatchScheduler(
            len(dataset), dataset.batch_size, number_of_steps, shuffle, seed
        )
        self.num_threads = max(1, num_threads)
        self.prefetch_depth = prefetch_depth
        self.deterministic = deterministic
        self._seed0 = seed
        self._seed_counter = seed
        self.row_slice = row_slice
        self._pool = ThreadPoolExecutor(max_workers=self.num_threads)

    def __len__(self) -> int:
        return self.number_of_steps

    def state(self) -> Dict[str, object]:
        """What the next epoch's draws depend on: the scheduler's shuffle
        RNG (as JSON: its 128-bit integers stay exact) and the batch seed
        counter. Read it between epochs."""
        return {"scheduler_rng": json.dumps(self.scheduler._rng.bit_generator.state),
                "seed_counter": int(self._seed_counter)}

    def load_state(self, state: Dict[str, object]) -> None:
        self.scheduler._rng.bit_generator.state = json.loads(state["scheduler_rng"])
        self._seed_counter = int(state["seed_counter"])

    def _build_batch(self, sample_indices: List[int], base_seed: int):
        off, cnt = self.row_slice or (0, len(sample_indices))
        rows = sample_indices[off:off + cnt]

        def one(args):
            local_pos, idx = args
            pos = off + local_pos  # the GLOBAL batch position: the oversampling
            # rule and the row's RNG key on it, so every rank's rows agree
            rng = np.random.default_rng((base_seed, pos, idx))
            return self.dataset.sample_patch(pos, idx, rng)

        patches = list(self._pool.map(one, enumerate(rows)))
        images = np.stack(patches, axis=0)
        if self.dataset.class_map is not None:
            labels = np.asarray(
                [self.dataset.class_map[self.dataset.ids[i]] for i in rows],
                np.int32,
            )
            return {"image": images, "class": labels}
        return images

    def __iter__(self) -> Iterator[np.ndarray]:
        batches = self.scheduler.epoch_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer is gone, so an
            # abandoned iterator (e.g. probe_latent's next(iter(loader)))
            # doesn't leak a thread blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            for step, b in enumerate(batches):
                if stop.is_set():
                    return
                if self.deterministic:
                    base_seed = self._seed0 * 1_000_003 + step
                else:
                    self._seed_counter += 1
                    base_seed = self._seed_counter
                if not put(self._build_batch(b, base_seed)):
                    return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            t.join()


def get_data_loaders(
    config: dict,
    dataset_id: str,
    splitting: str,
    batch_size: int,
    model_type: str,
    transformations: dict,
    fold: Optional[int] = None,
    preprocessed_root: Optional[str] = None,
    num_threads: Optional[int] = None,
    train_steps: int = TRAIN_STEPS_PER_EPOCH,
    val_steps: int = VAL_STEPS_PER_EPOCH,
    data_parallel: int = 1,
    mesh=None,
) -> Tuple[PrefetchLoader, PrefetchLoader]:
    """Train/val loaders over a preprocessed dataset (reference
    data_processing.py:115-145).

    ``batch_size`` is per device (the reference's per-GPU semantics,
    configuration.py:927-929); ``data_parallel``, the mesh's data axis,
    scales it to the global batch. In a run of several ranks pass the
    ``mesh`` (the trainers' CLIs do): every rank computes the same global
    schedule and builds only its ``data_axis_rows`` slice of each batch, so
    train and val match the one-process run; without a mesh such a run
    raises."""
    split_path = create_split_files(dataset_id, splitting, preprocessed_root=preprocessed_root)
    ids = get_data_ids(split_path, fold)
    ds_path = resolve_preprocessed_path(dataset_id, preprocessed_root)
    images_path = os.path.join(ds_path, "imagesTr")

    patch_size = list(transformations["patch_size"])
    if model_type == "2d" and len(patch_size) == 3:
        patch_size = patch_size[-2:]

    # class-conditional training (classifier-free guidance): a JSON mapping
    # patient id -> class index, given inline or as a file path (resolved
    # relative to the preprocessed dataset dir)
    class_map = None
    cc = config.get("class_conditioning")
    if cc:
        label_map = cc.get("label_map")
        if isinstance(label_map, str):
            lm_path = label_map if os.path.isabs(label_map) else os.path.join(
                ds_path, label_map
            )
            with open(lm_path) as f:
                label_map = json.load(f)
        class_map = {k: int(v) for k, v in (label_map or {}).items()}

    global_batch = int(batch_size) * max(1, int(data_parallel))
    row_slice = None
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1:
        if mesh is None:
            raise ValueError("multi-rank run: get_data_loaders needs the mesh to compute "
                             "this rank's slice of the global batch")
        from medical_image_generation_tpu_torch.parallel.mesh import data_axis_rows

        row_slice = data_axis_rows(mesh, global_batch)
        print(f"rank {mesh.rank}/{world}: building rows [{row_slice[0]}, "
              f"{row_slice[0] + row_slice[1]}) of each {global_batch}-row global batch")
    common = dict(
        data_path=images_path,
        batch_size=global_batch,
        patch_size=patch_size,
        oversample_ratio=config.get("oversample_ratio", 0.33),
        channel_ids=config.get("input_channels"),
        include_labels=bool(config.get("include_labels", False)),
        n_classes=int(config.get("n_classes", 1)),
        class_map=class_map,
        probabilistic_oversampling=bool(
            config.get("probabilistic_oversampling", False)
        ),
    )
    train_ds = PatchDataset(
        data_ids=ids["train"], section="training",
        initial_patch_size=compute_initial_patch_size(transformations, patch_size),
        **common,
    )
    val_ds = PatchDataset(data_ids=ids["val"], section="validation", **common)

    threads = num_threads if num_threads is not None else config.get("num_workers", 8)
    train_loader = PrefetchLoader(
        train_ds, train_steps, shuffle=True, num_threads=threads, seed=1,
        row_slice=row_slice,
    )
    val_loader = PrefetchLoader(
        val_ds, val_steps, shuffle=False, num_threads=threads, seed=2,
        deterministic=True, row_slice=row_slice,
    )
    return train_loader, val_loader
