"""The (data, model) device mesh on ``torch.distributed``.

Port of ``medical_image_generation_tpu/parallel/mesh.py``. The JAX package
runs one process per host over all of its chips and lets XLA insert the
collectives; the port runs one process per GPU, launched by
``python -m torch.distributed.run`` (torchrun), with NCCL between cards and
gloo between CPU processes (the tests). So:

* ``maybe_initialize_distributed`` reads torchrun's environment (the JAX
  coordinator variables' counterparts) and binds this process's card;
* ``get_mesh`` lays the world's ranks out as JAX lays its devices out,
  ``arange(world).reshape(world // model_parallel, model_parallel)``, and
  gives each rank its (data, model) coordinates, the process group of its
  data column (the ranks that hold the same model shard and see other
  batch rows: gradients are averaged there) and of its model row (the
  ranks that hold one data coordinate's rows and split the model: the
  Megatron collectives and ring attention run there);
* ``_owned_data_coords``, ``data_axis_rows`` and ``pad_batch_to_devices``
  keep the JAX arithmetic: a loader builds only its rank's rows of a global
  batch, keyed on the global row position;
* ``put_batch`` copies this rank's rows of a (padded) global batch to its
  device.

JAX's ``batch_sharding`` / ``replicated_sharding`` / ``shard_batch`` have no
torch object: a rank holds its batch rows as a plain tensor (what
``put_batch`` returns), and a replicated array is one tensor on every rank.

``with mesh:`` makes a mesh active for the thread, as the JAX trainers'
``with self.mesh:`` does; ``active_mesh()`` returns it. The attention
dispatch (``ops/attention.py``) reads it to engage ring attention.

A process with no process group sees a world of one: its mesh is (1, 1)
and every collective of ``parallel/comm.py`` is skipped. Under torchrun
every axis has a process group, one of a single rank included, so a
one-card torchrun run sends its gradients and losses through NCCL.
"""

from __future__ import annotations

import contextvars
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> Optional[torch.device]:
    """Join the process group that torchrun set up; call once from a CLI
    main before any device use.

    A no-op (returns None) unless torchrun's ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK`` and ``MASTER_ADDR`` are all set, so a plain run is
    untouched. They take the place of JAX's coordinator variables
    (``JAX_COORDINATOR_ADDRESS`` / ``MEDIMGEN_COORDINATOR_ADDRESS`` ->
    ``MASTER_ADDR:MASTER_PORT``; the process count and id ->
    ``WORLD_SIZE`` and ``RANK``; a host's local devices -> one card a
    process, ``cuda:LOCAL_RANK``). When they are set, the group is
    initialised even at ``WORLD_SIZE=1``, so a one-card torchrun run goes
    through NCCL: NCCL on ``device="cuda"`` (binding ``cuda:LOCAL_RANK``),
    gloo on ``device="cpu"``. Returns this process's device."""
    if not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torchrun asked for a CUDA run, but CUDA is not available; "
                               "pass device='cpu' to run the ranks on the CPU with gloo")
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", device_id=dev if dev.type == "cuda" else None)
        print(f"torch.distributed initialized: rank {dist.get_rank()}/{dist.get_world_size()} "
              f"({dist.get_backend()}) on {dev}")
    return dev


def mesh_layout(n_devices: int, model_parallel: int = 1) -> np.ndarray:
    """The (data, model) grid of ranks: ``arange(n).reshape(n // model_parallel,
    model_parallel)``, as JAX's ``get_mesh`` reshapes its device list."""
    if model_parallel < 1 or n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    return np.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("medimgen_active_mesh", default=None)


class Mesh:
    """This rank's view of the (data, model) mesh.

    ``shape``: {"data": ..., "model": ...}; ``devices``: the grid of ranks;
    ``rank`` and ``coords`` (its (data, model) coordinates); ``data_group``
    (the ranks of its data column, same model coordinate) and
    ``model_group`` (the ranks of its model row, same data coordinate), both
    None without a process group (an axis of one rank under torchrun gets a
    group of one, so its collectives still run, as identities); ``device``:
    this rank's device."""

    def __init__(self, devices: np.ndarray, rank: int, device: torch.device,
                 data_group=None, model_group=None):
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "model": int(devices.shape[1])}
        self.rank = int(rank)
        d, m = np.argwhere(devices == rank)[0]
        self.coords = (int(d), int(m))
        self.device = device
        self.data_group = data_group
        self.model_group = model_group
        self._tokens = []

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes checkpoints, plots and samples."""
        return self.rank == 0

    def __enter__(self):
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` of this thread, or None."""
    return _ACTIVE.get()


def get_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
             device: str | torch.device | None = None) -> Mesh:
    """The mesh over the world's ranks: ('data', 'model').

    ``model_parallel=1`` keeps everything data-parallel (the default). Every
    rank must call this with the same arguments: the process groups are
    created collectively, one per data column and one per model row, in the
    same order on every rank. ``device`` defaults to the current card
    (``cuda:LOCAL_RANK`` after ``maybe_initialize_distributed``) when CUDA
    is available, and to the CPU without CUDA or in a gloo group (CPU
    ranks). The mesh spans the whole world: ``n_devices``, when given, must
    not exceed it (JAX's message) and must equal it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is not None:
        if world < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {world} devices are visible; "
                f"provision more (e.g. torchrun --nproc_per_node) before building the mesh")
        if n_devices != world:
            raise ValueError(f"a mesh spans every rank of the world: {n_devices} of {world} "
                             f"requested")
    grid = mesh_layout(world, model_parallel)
    if device is None:
        gloo = dist.is_initialized() and dist.get_backend() != "nccl"
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() and not gloo else torch.device("cpu"))
    data_group = model_group = None
    if dist.is_initialized():  # an axis of one rank too: its collectives then run as identities
        for m in range(grid.shape[1]):  # data columns
            g = dist.new_group([int(r) for r in grid[:, m]])
            if rank in grid[:, m]:
                data_group = g
        for d in range(grid.shape[0]):  # model rows
            g = dist.new_group([int(r) for r in grid[d]])
            if rank in grid[d]:
                model_group = g
    return Mesh(grid, rank, torch.device(device), data_group, model_group)


def _owned_data_coords(proc_grid: np.ndarray, proc: int) -> list:
    """Data-axis coordinates whose device row contains ``proc``.

    ``proc_grid`` is the (data, model) array of process indices. When the
    'model' axis spans processes, a data row has several owners; each must
    supply identical batch rows (the loaders key their sampling RNG on the
    GLOBAL row index, so co-owners reproduce the same rows independently).
    With one process per device, a rank owns exactly one coordinate."""
    return [d for d in range(proc_grid.shape[0]) if proc in proc_grid[d]]


def data_axis_rows(mesh: Mesh, global_batch: int):
    """This rank's slice ``(offset, count)`` of a global batch sharded on
    the 'data' axis.

    Rows are coord-major: rows [d*rpc, (d+1)*rpc) belong to data coordinate
    d, rpc = global_batch / data-axis size (exact by construction: the
    loaders build global batches as batch_size x data-axis size)."""
    n_data = mesh.shape["data"]
    if global_batch % n_data:
        raise ValueError(
            f"global batch {global_batch} not a multiple of the data axis "
            f"({n_data}); loaders must build batch_size × mesh.shape['data']"
        )
    rpc = global_batch // n_data
    if mesh.devices.size == 1:
        return 0, global_batch
    owned = _owned_data_coords(mesh.devices, mesh.rank)
    if not owned:
        raise ValueError("this process owns no devices in the mesh")
    lo, hi = min(owned), max(owned)
    return lo * rpc, (hi + 1 - lo) * rpc


def pad_batch_to_devices(batch, mesh: Mesh) -> np.ndarray:
    """Round the batch up to a multiple of the data-axis size by repeating
    the last samples. Dict batches (class-conditional loaders) are padded
    leaf-wise."""
    if isinstance(batch, dict):
        return {k: pad_batch_to_devices(v, mesh) for k, v in batch.items()}
    batch = np.asarray(batch)
    n_data = mesh.shape["data"]
    b = batch.shape[0]
    if b % n_data == 0:
        return batch
    pad = n_data - (b % n_data)
    reps = -(-pad // b)  # tile if the batch is smaller than the pad
    filler = np.concatenate([batch] * reps, axis=0)[:pad]
    return np.concatenate([batch, filler], axis=0)


def put_batch(batch, mesh: Mesh):
    """This rank's rows of a (padded) global batch, as tensors on its
    device. Dict batches are taken leaf-wise."""
    if isinstance(batch, dict):
        return {k: put_batch(v, mesh) for k, v in batch.items()}
    batch = pad_batch_to_devices(batch, mesh)
    off, cnt = data_axis_rows(mesh, batch.shape[0])
    return torch.as_tensor(np.ascontiguousarray(batch[off:off + cnt])).to(mesh.device)
