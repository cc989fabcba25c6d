"""Checkpoints with the reference's last/best semantics, as ``.pt`` files.

The port's counterpart of ``medical_image_generation_tpu/training/
checkpoints.py`` (:1-123): ``checkpoints/last_model.pt`` every
``checkpoint_interval`` epochs and ``checkpoints/best_model.pt`` when the
validation loss improves (``training/common.py:save_last_best``), and the
loss history as ``loss_dict.pkl`` (the same pickle as the JAX package's),
reloaded on ``-c`` resume. A payload is a dict of tensors, numbers, lists
and dicts of those, written with ``torch.save`` to a temporary file and
moved into place with ``os.replace`` (atomic, as the JAX package's
``:28-43``), and read back with ``torch.load(weights_only=True)``. The
GroupNorm migration of old flax trees lives in ``convert.py``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import torch


def checkpoint_path(checkpoints_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(checkpoints_dir), f"{name}.pt")


def save_checkpoint(checkpoints_dir: str, name: str, payload: Dict[str, Any]) -> str:
    """Atomically write ``payload`` as ``checkpoints_dir/<name>.pt``;
    returns the path."""
    path = checkpoint_path(checkpoints_dir, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A payload written by ``save_checkpoint``, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_loss_dict(save_path: str, loss_dict: Dict[str, list]) -> None:
    with open(os.path.join(save_path, "loss_dict.pkl"), "wb") as f:
        pickle.dump(loss_dict, f)


def load_loss_dict(save_path: str) -> Optional[Dict[str, list]]:
    p = os.path.join(save_path, "loss_dict.pkl")
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return pickle.load(f)
