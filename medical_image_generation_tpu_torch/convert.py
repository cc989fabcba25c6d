"""Flax parameter trees -> the port's ``state_dict``s.

The port's modules carry the flax module names, so the mapping is
mechanical: the path ``A/B/leaf`` becomes ``A.B.<leaf>`` and each leaf is
re-laid-out for PyTorch:

* conv ``kernel`` (*spatial, in, out)  -> ``weight`` (out, in, *spatial)
* Dense ``kernel`` (in, out)            -> ``weight`` (out, in)
* GroupNorm ``scale``                   -> ``weight``
* Embed ``embedding``                   -> ``weight``
* ``bias``                              -> ``bias``

Input trees are nested dicts of numpy arrays (e.g. ``jax.device_get`` of the
flax params, or a restored checkpoint payload); nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def migrate_groupnorm_params(tree):
    """Collapse the pre-round-2 GroupNorm nesting ``.../GroupNorm_k/
    GroupNorm_0/{scale,bias}`` to ``.../GroupNorm_k/{scale,bias}`` (copy of
    ``training/checkpoints.py:_migrate_groupnorm_params``). Returns
    (tree, number of nestings collapsed)."""
    n = 0

    def rec(node):
        nonlocal n
        if not isinstance(node, Mapping):
            return node
        if (set(node.keys()) == {"GroupNorm_0"} and isinstance(node["GroupNorm_0"], Mapping)
                and set(node["GroupNorm_0"].keys()) <= {"scale", "bias"}):
            n += 1
            return dict(node["GroupNorm_0"])
        return {k: rec(v) for k, v in node.items()}

    return rec(tree), n


def _leaf(name: str, value) -> tuple:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        # (*spatial, in, out) -> (out, in, *spatial)
        return "weight", np.transpose(a, (a.ndim - 1, a.ndim - 2, *range(a.ndim - 2)))
    if name in ("scale", "embedding"):
        return "weight", a
    if name == "bias":
        return "bias", a
    raise KeyError(f"unknown flax leaf {name!r}")


def flax_to_state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into a state_dict of fp32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flax_to_state_dict(v, f"{prefix}{k}."))
        else:
            name, a = _leaf(k, v)
            # C-contiguous and writeable (a copy only where the input is not)
            out[f"{prefix}{name}"] = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return out


def unet_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of ``models.diffusion_unet.DiffusionUNet`` from the flax
    ``DiffusionUNet`` params (legacy GroupNorm nesting migrated)."""
    return flax_to_state_dict(migrate_groupnorm_params(dict(params))[0])


def vae_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of the whole ``models.autoencoder_kl.AutoencoderKL``
    (encoder, quant convs, decoder) from the flax ``AutoencoderKL`` params."""
    return flax_to_state_dict(migrate_groupnorm_params(dict(params))[0])


def vae_decoder_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of the decoding half of ``models.autoencoder_kl.
    AutoencoderKL`` (``with_encoder=False``, what sampling builds) from the
    flax ``AutoencoderKL`` params; encoder entries are dropped."""
    tree = migrate_groupnorm_params(dict(params))[0]
    return flax_to_state_dict(
        {k: tree[k] for k in ("post_quant_conv", "decoder")})
