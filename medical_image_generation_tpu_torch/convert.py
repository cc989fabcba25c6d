"""Flax parameter trees -> the port's ``state_dict``s.

The port's modules carry the flax module names, so the mapping is
mechanical: the path ``A/B/leaf`` becomes ``A.B.<leaf>`` and each leaf is
re-laid-out for PyTorch:

* conv ``kernel`` (*spatial, in, out)  -> ``weight`` (out, in, *spatial)
* ``ConvTranspose_k`` ``kernel`` (*spatial, in, out) -> ``weight`` (in, out,
  *spatial) flipped along every spatial axis: flax correlates the
  zero-stuffed input with the kernel as it is, ``ConvTranspose{2,3}d`` with
  the flipped kernel
* Dense ``kernel`` (in, out)            -> ``weight`` (out, in)
* GroupNorm / LayerNorm ``scale``       -> ``weight``
* Embed ``embedding``                   -> ``weight``
* ``bias``                              -> ``bias``
* VQ ``codebook``                       -> ``codebook`` (unchanged)
* frozen-BN ``mean`` / ``var``          -> ``mean`` / ``var`` (unchanged)

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


def _leaf(name: str, value, module: str = "") -> tuple:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel" and module.startswith("ConvTranspose"):
        nd = a.ndim - 2
        return "weight", np.flip(np.transpose(a, (nd, nd + 1, *range(nd))),
                                 axis=tuple(range(2, a.ndim)))
    if name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        # (*spatial, in, out) -> (out, in, *spatial)
        return "weight", np.transpose(a, (a.ndim - 1, a.ndim - 2, *range(a.ndim - 2)))
    if name in ("scale", "embedding"):
        return "weight", a
    if name in ("bias", "codebook", "mean", "var"):
        return name, a
    raise KeyError(f"unknown flax leaf {name!r}")


def flax_to_state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into a state_dict of fp32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flax_to_state_dict(v, f"{prefix}{k}."))
        else:
            name, a = _leaf(k, v, prefix.rstrip(".").rsplit(".", 1)[-1])
            # C-contiguous and writeable (a copy only where the input is not)
            out[f"{prefix}{name}"] = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return out


def unet_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of ``models.diffusion_unet.DiffusionUNet`` from the flax
    ``DiffusionUNet`` params (legacy GroupNorm nesting migrated). Under
    ``with_conditioning`` the tree holds ``SpatialTransformer_k`` in place of
    ``AttentionBlock_k``, each with ``GroupNorm_0``, the ``ConvND_0`` /
    ``ConvND_1`` projections and ``TransformerBlock_j`` (``LayerNorm_0-2``,
    ``CrossAttention_0-1`` with bias-free ``Dense_0-2`` and ``Dense_3``,
    the GEGLU ``Dense_0-1``): the same mechanical mapping. The flax
    ``DiffusionEncoder`` tree maps the same way onto
    ``models.diffusion_unet.DiffusionEncoder``."""
    return flax_to_state_dict(migrate_groupnorm_params(dict(params))[0])


def vae_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of a stage-1 network from its flax params: the whole
    ``models.autoencoder_kl.AutoencoderKL`` (encoder, quant convs,
    decoder), ``models.vqvae.VQVAE`` (encoder, decoder,
    ``quantizer.codebook``) or ``models.discriminator.PatchDiscriminator``,
    which all carry the flax module names. The tensors are fp32:
    ``load_state_dict`` keeps them so in a model built with
    ``param_dtype=torch.float32`` (training) and rounds them into a bf16
    one (sampling)."""
    return flax_to_state_dict(migrate_groupnorm_params(dict(params))[0])


def perceptual_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of ``models.perceptual.VGGFeatures`` from the flax
    ``VGGFeatures`` variables (``PerceptualLoss.params``, with or without
    the outer ``params`` collection)."""
    params = dict(params)
    return flax_to_state_dict(params.get("params", params))


def features_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of ``eval.features.ResNet50Features`` from the flax
    ``ResNet50Features`` variables (with or without the outer ``params``
    collection): the random-feature tree (convs with biases, per-channel
    ``GroupNorm_k``) or the pretrained one (bias-free convs,
    ``FrozenBatchNorm_k`` with ``scale``, ``bias``, ``mean``, ``var``)."""
    params = dict(params)
    return flax_to_state_dict(params.get("params", params))


def vae_decoder_from_flax(params) -> Dict[str, torch.Tensor]:
    """State dict of the decoding half of ``models.autoencoder_kl.
    AutoencoderKL`` (``with_encoder=False``, what sampling builds) from the
    flax ``AutoencoderKL`` params; encoder entries are dropped."""
    tree = migrate_groupnorm_params(dict(params))[0]
    return flax_to_state_dict(
        {k: tree[k] for k in ("post_quant_conv", "decoder")})
