"""Plotting artifacts: loss curves, sample grids, reconstructions, volume GIFs.

The port's copy of ``medical_image_generation_tpu/training/plots.py``
(:1-111), with the same artifact contract as the reference (utils.py:
15-145, train_autoencoder.py:488-531, train_ldm.py:400-464):
``plots/loss.png`` / ``all_losses.png`` curves, ``epoch_N.png`` sample
grids and image / reconstruction pairs in 2D, animated ``epoch_N.gif``
slice fly-throughs in 3D (200 ms/frame). The 2D images are written by
``io/png.py`` (the samples themselves, no figure), so they need neither
matplotlib nor PIL. matplotlib and PIL are imported when a curve or a GIF is
drawn, not at import: without them the curves are skipped (the trainers
always write ``loss_dict.pkl``), the 3D samples and reconstructions are
written as ``epoch_N.npy``, and one line says that the figures were skipped.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from medical_image_generation_tpu_torch.io import png

_warned = False


def _skip(what: str, err: ImportError) -> None:
    global _warned
    if not _warned:
        print(f"[plots] {err.name or err} is not installed: skipping the figures "
              f"(first: {what}); samples are written as .npy")
        _warned = True


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_main_losses(train_losses: List[float], val_losses: List[float], path: str,
                     title: str = "Loss") -> bool:
    """loss.png with train/val curves (reference utils.py:86-113). Returns
    False when matplotlib is missing and nothing was drawn."""
    try:
        plt = _pyplot()
    except ImportError as e:
        _skip(os.path.basename(path), e)
        return False
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(train_losses, label="train")
    ax.plot(val_losses, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def save_all_losses(loss_dict: Dict[str, List[float]], path: str) -> bool:
    """Multi-curve loss plot (reference utils.py:116-145). Returns False when
    matplotlib is missing and nothing was drawn."""
    try:
        plt = _pyplot()
    except ImportError as e:
        _skip(os.path.basename(path), e)
        return False
    fig, ax = plt.subplots(figsize=(10, 6))
    for name, values in loss_dict.items():
        if values:
            ax.plot(values, label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def save_volume_gif(volume: np.ndarray, path: str, recon: Optional[np.ndarray] = None,
                    duration_ms: int = 200) -> None:
    """Animated per-slice GIF of a 3D volume, optionally side-by-side with a
    second one (reference utils.py:59-83, train_autoencoder.py:488-520)."""
    from PIL import Image

    volume = np.squeeze(np.asarray(volume))
    if volume.ndim == 4:  # (Z, Y, X, C) -> first channel
        volume = volume[..., 0]
    frames = []
    if recon is not None:
        recon = np.squeeze(np.asarray(recon))
        if recon.ndim == 4:
            recon = recon[..., 0]
    for z in range(volume.shape[0]):
        frame = volume[z]
        if recon is not None:
            frame = np.concatenate([frame, recon[z]], axis=1)
        frames.append(Image.fromarray(png.to_uint8(frame)))
    if frames:
        frames[0].save(
            path, save_all=True, append_images=frames[1:], duration=duration_ms, loop=0
        )


def save_samples(images: np.ndarray, plots_dir: str, epoch: int, spatial_dims: int) -> str:
    """The LDM loop's interval samples (JAX ``train_ldm.py:502-511``):
    ``epoch_N.png`` (2D grid, ``io/png.py``) or ``epoch_N.gif`` (3D, the
    first two volumes side by side); in 3D ``epoch_N.npy`` of all of them
    when PIL is missing. Returns the path written."""
    stem = os.path.join(plots_dir, f"epoch_{epoch + 1}")
    if spatial_dims == 2:
        png.write_png(stem + ".png", png.image_grid(list(images)))
        return stem + ".png"
    try:
        save_volume_gif(images[0], stem + ".gif",
                        recon=images[1] if len(images) > 1 else None)
        return stem + ".gif"
    except ImportError as e:
        _skip(os.path.basename(stem), e)
        np.save(stem + ".npy", np.asarray(images))
        return stem + ".npy"


def save_reconstruction(image: np.ndarray, recon: np.ndarray, plots_dir: str, epoch: int,
                        spatial_dims: int) -> str:
    """The autoencoder loop's interval reconstruction (JAX
    ``train_autoencoder.py:393-406``): ``epoch_N.png`` (2D, image and
    reconstruction side by side, ``io/png.py``) or ``epoch_N.gif`` (3D, the
    same pair); in 3D ``epoch_N.npy`` of the stacked pair when PIL is
    missing. Returns the path written."""
    stem = os.path.join(plots_dir, f"epoch_{epoch + 1}")
    if spatial_dims == 2:
        png.write_png(stem + ".png", png.image_grid([image, recon], ncols=2))
        return stem + ".png"
    try:
        save_volume_gif(image, stem + ".gif", recon=recon)
        return stem + ".gif"
    except ImportError as e:
        _skip(os.path.basename(stem), e)
        np.save(stem + ".npy", np.stack([np.asarray(image), np.asarray(recon)]))
        return stem + ".npy"
