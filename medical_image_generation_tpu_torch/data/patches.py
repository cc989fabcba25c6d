"""Patch geometry: the port's own copy.

Copied from ``medical_image_generation_tpu/data/patches.py`` (numpy only)
so the port derives the augmentation ranges, the enlarged initial patch and
each patch's bounding box without importing the JAX package:

* ``spatial_aug_params`` (the soft / nnunet presets) and
  ``compute_initial_patch_size`` (the rotation/scale-enlarged training
  patch the loader extracts and the device augmentation crops back from),
  :27-36 and :51-270;
* the foreground oversampling rules ``oversample_last_fraction`` and
  ``oversample_probabilistic`` (:38-48), ``get_bbox`` (:272-336) and
  ``crop_and_pad`` (:339-356), which the host loader (``data/loader.py``)
  calls with the same ``np.random.Generator`` draws in the same order, so
  both packages cut the same patches.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# soft-branch augmentation geometry (reference data_processing.py:400-416)
SOFT_ROT = 0.174533  # +-10 degrees about the plane normal
SOFT_RANGE = (0.9, 1.1)
# heavy nnU-Net branch (reference data_processing.py:371-397)
NNUNET_SCALE = (0.7, 1.4)
NNUNET_BRIGHT = (0.75, 1.25)
NNUNET_CONTRAST = (0.75, 1.25)
NNUNET_GAMMA = (0.7, 1.5)
ANISOTROPY_THRESHOLD = 3  # reference data_processing.py:368


def oversample_last_fraction(batch_pos: int, batch_size: int, oversample_ratio: float) -> bool:
    """True when this batch position must contain foreground
    (reference data_processing.py:426-429)."""
    return batch_pos >= round(batch_size * (1 - oversample_ratio))


def oversample_probabilistic(oversample_ratio: float, rng: np.random.Generator) -> bool:
    """Foreground-forcing by independent coin toss instead of batch position
    (reference _probabilistic_oversampling, data_processing.py:431-433;
    enabled by the ``probabilistic_oversampling`` config flag, ctor :276)."""
    return bool(rng.uniform() < oversample_ratio)


def _rot_mats(angles: np.ndarray, axis: int) -> np.ndarray:
    """(N, 3, 3) single-axis rotation matrices."""
    c, s = np.cos(angles), np.sin(angles)
    n = len(angles)
    R = np.tile(np.eye(3), (n, 1, 1))
    i, j = [d for d in range(3) if d != axis]
    R[:, i, i], R[:, i, j] = c, -s
    R[:, j, i], R[:, j, j] = s, c
    return R


def _max_cos_sin_combo(a: float, b: float, A: float) -> float:
    """Exact max over |t| <= A of a*|cos t| + b*|sin t| (a, b >= 0).

    The combo has period pi/2 in its extremes, so A clamps there; on
    [0, pi/2] the unique interior critical point is t* = atan2(b, a), giving
    max = f(min(A, t*)) — analytic, no angle grid."""
    A = min(math.pi / 2, abs(A))
    t = min(A, math.atan2(b, a))
    return a * math.cos(t) + b * math.sin(t)


def _covering_extent(
    patch_size: Sequence[int], rot_x: float, rot_y: float, rot_z: float
) -> np.ndarray:
    """Max over the rotation ranges of the axis-aligned bounding extent of
    the rotated BOX: ext_i = sum_j |R^-1[i, j]| * size_j, so every sampling
    coordinate of the final output grid lies inside the loaded patch — the
    guarantee the reference's vector formula lacks (it rotates the size
    vector, which under-covers the corner along the shrinking axis).

    2D is exact (analytic maximum). 3D composed rotations sample an angle
    grid; the caller (get_initial_patch_size) adds one voxel of slack there,
    which strictly dominates the sub-voxel grid error: near the maximum the
    extent is stationary, so the error is ~0.5*|f''|*h^2 with
    |f''| <= extent <= sum(size) and grid half-spacing h <= pi/48 per axis —
    well under half a voxel even at 128^3."""
    size = np.asarray(patch_size, np.float64)
    if len(size) == 2:
        ey = _max_cos_sin_combo(size[0], size[1], rot_x)
        ex = _max_cos_sin_combo(size[1], size[0], rot_x)
        return np.maximum(size, [ey, ex])

    def grid(a):
        a = min(math.pi / 2, abs(a))
        return np.linspace(-a, a, 25) if a > 0 else np.zeros(1)

    Rx = _rot_mats(grid(rot_x), 0)
    Ry = _rot_mats(grid(rot_y), 1)
    Rz = _rot_mats(grid(rot_z), 2)
    # all compositions Rx @ Ry @ Rz (the augmentation's composition order)
    R = np.einsum("aij,bjk,ckl->abcil", Rx, Ry, Rz).reshape(-1, 3, 3)
    # inverse = transpose; extent_i = sum_j |R^T[i,j]| size_j = |R|[:, j, i]
    ext = (np.abs(R) * size[:, None]).sum(axis=1).max(axis=0)
    return np.maximum(size, ext)


def get_initial_patch_size(
    patch_size: Sequence[int],
    rot_x: float,
    rot_y: float,
    rot_z: float,
    scale_range: Sequence[float],
) -> List[int]:
    """Rotation/scale-aware enlarged patch size: the bounding extent of the
    rotated BOX over the full rotation ranges, divided by the minimum
    (zoom-out) scale, so the device resample never reads outside the loaded
    patch (the JAX function's ``covering=True`` mode, the one its loaders
    use; its reference-formula mode has no caller here).

    ``rot_x/rot_y/rot_z`` are the maximum rotation magnitudes about patch
    axes 0/1/2 (batchgenerators' convention: axis names follow the array
    order, so for a (z, y, x) patch ``rot_x`` is the in-plane rotation about
    the depth axis; 2D uses ``rot_x`` alone)."""
    ext = _covering_extent(patch_size, rot_x, rot_y, rot_z)
    final = ext / min(scale_range)
    if len(patch_size) == 3:
        # the 3D extent max is grid-sampled; one voxel of slack on every
        # axis the rotation actually enlarged makes the no-outside-reads
        # guarantee strict (see _covering_extent)
        final = final + (ext > np.asarray(patch_size, np.float64) + 1e-9)
    return [int(math.ceil(v)) for v in final]


def spatial_aug_params(
    transformations: Dict, patch_size: Optional[Sequence[int]] = None
) -> Dict:
    """Preset-aware spatial-augmentation geometry, shared by the host loader
    (how large a patch to extract) and the device augmentation (which
    transform to apply and what to crop back to).

    Reproduces the reference's configure_augmentation_params
    (data_processing.py:362-423) for both branches:

    * ``aug_preset: soft`` (default) — ±10° rotation about the plane normal,
      in-plane scale 0.9–1.1, one mirror axis (x), intensity ranges 0.9–1.1.
      The reference soft branch does NOT enlarge the initial patch (rotated
      samples get zero corners); with ``initial_patch_enlargement: true``
      (planner-emitted default for new plans) the training patch is enlarged
      so the resample never leaves the data — strictly better samples at a
      modest host-IO cost. Configs without the key keep reference behavior.
    * ``aug_preset: nnunet`` — the heavy nnU-Net parameterization (reference
      :371-397): anisotropy-aware dummy-2D selection, ±30° 3D (or in-plane
      ±180°) rotation, scale 0.7–1.4, per-axis mirror, wider intensity
      ranges, and the initial-patch enlargement the reference computes there
      (default on; ``initial_patch_enlargement: false`` disables).
    """
    t = transformations
    patch = list(patch_size if patch_size is not None else t["patch_size"])
    dim = len(patch)
    preset = t.get("aug_preset", "soft")
    rotation_on = bool(t.get("rotation", True))
    scaling_on = bool(t.get("scaling", True))

    if preset == "nnunet":
        if dim == 3:
            dummy_2d = max(patch) / patch[0] > ANISOTROPY_THRESHOLD
            rot = math.pi if dummy_2d else math.pi * 30 / 180
            rot_3d = not dummy_2d
            mirror_axes = (0, 1, 2)
        else:
            dummy_2d = False
            rot = (math.pi * 15 / 180
                   if max(patch) / min(patch) > 1.5 else math.pi)
            rot_3d = False
            mirror_axes = (0, 1)
        scale = NNUNET_SCALE
        bright, contrast, gamma = NNUNET_BRIGHT, NNUNET_CONTRAST, NNUNET_GAMMA
        enlarge = bool(t.get("initial_patch_enlargement", True))
    elif preset == "soft":
        dummy_2d = bool(t.get("dummy_2d", False))
        rot = SOFT_ROT
        rot_3d = False
        mirror_axes = (2,) if dim == 3 else (1,)
        scale = SOFT_RANGE
        bright = contrast = gamma = SOFT_RANGE
        enlarge = bool(t.get("initial_patch_enlargement", False))
    else:
        raise ValueError(f"unknown aug_preset {preset!r}; valid: soft, nnunet")

    rot_eff = rot if rotation_on else 0.0
    scale_eff = scale if scaling_on else (1.0, 1.0)
    if enlarge and (rotation_on or scaling_on):
        # bounding-box extents, so the resample provably never reads
        # outside the loaded patch (see get_initial_patch_size)
        if rot_3d:
            initial = get_initial_patch_size(
                patch, rot_eff, rot_eff, rot_eff, scale_eff
            )
        elif dim == 3:
            # in-plane transform only: z needs no margin
            initial = [patch[0]] + get_initial_patch_size(
                patch[1:], rot_eff, 0.0, 0.0, scale_eff
            )
        else:
            initial = get_initial_patch_size(
                patch, rot_eff, 0.0, 0.0, scale_eff
            )
        if dim == 3 and dummy_2d:
            initial[0] = patch[0]  # reference data_processing.py:397
    else:
        initial = list(patch)

    return {
        "initial_patch_size": tuple(initial),
        "patch_size": tuple(patch),
        "dummy_2d": dummy_2d,
        "rot_range": rot if rotation_on else 0.0,
        "rot_3d": rot_3d,
        "scale_range": tuple(scale),
        "mirror_axes": tuple(mirror_axes),
        "bright_range": tuple(bright),
        "contrast_range": tuple(contrast),
        "gamma_range": tuple(gamma),
    }


def compute_initial_patch_size(
    transformations: Dict, patch_size: Optional[Sequence[int]] = None
) -> Tuple[int, ...]:
    """The training-section patch the host loader must extract (possibly
    enlarged for the device spatial transform)."""
    return spatial_aug_params(transformations, patch_size)["initial_patch_size"]


def get_bbox(
    data_shape: Sequence[int],
    patch_size: Sequence[int],
    force_fg: bool,
    class_locations: Optional[Dict[int, List[Tuple[int, int, int]]]],
    rng: np.random.Generator,
    is_2d: bool = False,
    jitter: int = 10,
    final_patch_size: Optional[Sequence[int]] = None,
) -> Tuple[List[int], List[int]]:
    """Lower/upper bbox corners for one patch (reference
    data_processing.py:473-528).

    ``patch_size`` is the INITIAL (possibly rotation/scale-enlarged) patch to
    extract; ``final_patch_size`` the size the device transform crops back
    to. As in the reference, the baseline padding allowance is their
    difference — the enlarged margin may hang off the volume (zero-padded)
    so the FINAL patch can still reach the edges. ``jitter`` bounds the H/W
    center offset (10 for training, 0 = fixed center for validation)."""
    dim = len(data_shape)
    patch_size = list(patch_size)
    final = list(final_patch_size) if final_patch_size is not None else patch_size

    need_to_pad = [patch_size[d] - final[d] for d in range(dim)]
    for d in range(dim):
        if need_to_pad[d] + data_shape[d] < patch_size[d]:
            need_to_pad[d] = patch_size[d] - data_shape[d]

    lbs = [-need_to_pad[d] // 2 for d in range(dim)]
    ubs = [
        data_shape[d] + need_to_pad[d] // 2 + need_to_pad[d] % 2 - patch_size[d]
        for d in range(dim)
    ]

    bbox_lbs = [int(rng.integers(lbs[d], ubs[d] + 1)) for d in range(dim)]

    if force_fg and class_locations:
        eligible = [c for c, locs in class_locations.items() if len(locs) > 0]
        if eligible:
            cls = eligible[int(rng.integers(len(eligible)))]
            voxels = class_locations[cls]
            vz, vy, vx = voxels[int(rng.integers(len(voxels)))]
            voxel = (vz, vy, vx)
            if is_2d:
                bbox_lbs[0] = int(vz)  # take exactly that slice
            else:
                for d in range(dim):
                    bbox_lbs[d] = int(
                        max(lbs[d], min(voxel[d] - patch_size[d] // 2, ubs[d]))
                    )

    # H/W (last two axes): center crop with bounded random jitter (0 = fixed)
    for d in range(dim - 2, dim):
        crop = patch_size[d]
        size = data_shape[d]
        center = size // 2
        if size < crop:
            bbox_lbs[d] = center - crop // 2
        else:
            max_offset = min(jitter, center - crop // 2, size - center - (crop - crop // 2))
            offset = int(rng.integers(-max_offset, max_offset + 1)) if max_offset > 0 else 0
            bbox_lbs[d] = center + offset - crop // 2

    bbox_ubs = [bbox_lbs[d] + patch_size[d] for d in range(dim)]
    return bbox_lbs, bbox_ubs


def crop_and_pad(array_like, lbs: Sequence[int], ubs: Sequence[int]) -> np.ndarray:
    """Zero-padded bbox extraction from either a VolStore (lazy, native
    decode) or an in-memory ndarray (reference crop_and_pad_nd,
    data_processing.py:148-225)."""
    if hasattr(array_like, "read_bbox"):
        return array_like.read_bbox(lbs, ubs)
    arr = np.asarray(array_like)
    out_shape = tuple(u - l for l, u in zip(lbs, ubs))
    out = np.zeros(out_shape, dtype=arr.dtype)
    src, dst = [], []
    for d, (l, u) in enumerate(zip(lbs, ubs)):
        cl, cu = max(l, 0), min(u, arr.shape[d])
        if cl >= cu:
            return out
        src.append(slice(cl, cu))
        dst.append(slice(cl - l, cu - l))
    out[tuple(dst)] = arr[tuple(src)]
    return out
