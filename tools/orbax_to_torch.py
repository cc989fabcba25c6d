"""Convert a JAX (orbax) checkpoint of medimgen into the PyTorch port's ``.pt``.

Run with the JAX package installed (it reads the checkpoint through
``medical_image_generation_tpu.training.checkpoints.load_checkpoint``); the
port never imports JAX. The weights go through the port's converter
(``medical_image_generation_tpu_torch.convert``):

  autoencoder (``g_params``, and ``d_params`` when present):
      python tools/orbax_to_torch.py .../autoencoder/checkpoints/best_model best_model.pt
      -> {"epoch", "vae" (or "vq" for a VQ-VAE run), "discriminator"}: the
         file ``medimgen_torch_train_ldm`` reads at
         <results>/<task>/<model_type>/autoencoder/checkpoints/best_model.pt

  latent diffusion model (``params``, optional ``ema_params``):
      python tools/orbax_to_torch.py .../ldm/checkpoints/best_model ldm.pt \
          --vae .../autoencoder/checkpoints/best_model
      -> {"epoch", "unet", "ema_unet" (if the run had EMA), "scale_factor",
          "latent_shape", "vae"}: what ``medimgen_torch_sample_ldm`` reads.
         ``unet`` holds the live params, the weights the JAX sampling CLI
         samples (``training/sample.py:89-95``); the EMA weights go to
         ``ema_unet``. ``--vae`` takes the AE's orbax checkpoint or a
         converted ``.pt``.

The optimizer state is not converted: a converted LDM samples and a
converted autoencoder feeds the LDM; neither resumes training.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host(tree):
    """Nested dicts of numpy arrays from a restored orbax payload."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree)


def _autoencoder(payload) -> dict:
    """{"vae" or "vq": state_dict[, "discriminator": state_dict]} of an AE
    run's payload: a generator with a ``quantizer`` is a VQ-VAE."""
    from medical_image_generation_tpu_torch import convert

    g = _host(payload["g_params"])
    out = ({"vq": convert.vae_from_flax(g)} if "quantizer" in g
           else {"vae": convert.vae_from_flax(g)})
    if payload.get("d_params") is not None:
        out["discriminator"] = convert.vae_from_flax(_host(payload["d_params"]))
    return out


def _read_vae(path: str):
    import torch

    from medical_image_generation_tpu.training.checkpoints import load_checkpoint

    if path.endswith(".pt"):
        ae = torch.load(path, map_location="cpu", weights_only=True)
    else:
        payload = load_checkpoint(path)
        if "g_params" not in payload:
            raise KeyError(f"{path} is not an autoencoder checkpoint (no g_params)")
        ae = _autoencoder(payload)
    if "vae" not in ae:
        raise KeyError(f"{path} holds no KL-VAE (a VQ-VAE run's LDM is not converted)")
    return ae["vae"]


def convert_checkpoint(src: str, dst: str, vae: Optional[str] = None) -> dict:
    """Write the port's ``.pt`` for the orbax checkpoint ``src``; returns
    the payload written."""
    import torch

    from medical_image_generation_tpu.training.checkpoints import load_checkpoint
    from medical_image_generation_tpu_torch import convert

    payload = load_checkpoint(os.path.abspath(src))
    epoch = int(np.asarray(payload.get("epoch", -1)))
    if "g_params" in payload:
        out = {"epoch": epoch, **_autoencoder(payload)}
    elif "params" in payload:
        out = {"epoch": epoch, "unet": convert.unet_from_flax(_host(payload["params"])),
               "scale_factor": float(np.asarray(payload["scale_factor"])),
               "latent_shape": [int(v) for v in np.asarray(payload["latent_shape"])]}
        if payload.get("ema_params") is not None:
            out["ema_unet"] = convert.unet_from_flax(_host(payload["ema_params"]))
        if vae is not None:
            out["vae"] = _read_vae(vae)
    else:
        raise KeyError(f"{src}: neither an autoencoder (g_params) nor an LDM (params) "
                       "checkpoint")
    torch.save(out, dst)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="orbax checkpoint directory (e.g. checkpoints/best_model)")
    p.add_argument("dst", help="output .pt")
    p.add_argument("--vae", default=None,
                   help="LDM only: the autoencoder's orbax checkpoint or converted .pt, "
                        "stored under 'vae' so the sampling CLI reads one file")
    args = p.parse_args(argv)
    out = convert_checkpoint(args.src, args.dst, args.vae)
    print(f"wrote {args.dst}: {sorted(out)}")


if __name__ == "__main__":
    main()
