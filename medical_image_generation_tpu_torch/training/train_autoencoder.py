"""Stage-1 autoencoder training: ``AutoEncoderTrainer`` and the
``medimgen_torch_train_autoencoder`` CLI.

Port of ``medical_image_generation_tpu/training/train_autoencoder.py``
(:1-485): ``parse_kl_weight`` (:66-75), the train step
(``_g_loss_fn`` / ``_make_train_step``, :190-245), the validation step
(:247-253), ``adapt_kl_loss_weight`` (:255-280), the epoch loop (:287-359),
the epoch artifacts (:361-406), resume (:408-434) and the CLI (:441-485),
with the JAX trainer's names. One ``train_step(batch, adv_on)`` runs, in
order:

1. device augmentation of the loader's (possibly enlarged) patch, cropped
   back to the final size (``data/augment.py``);
2. the generator loss: L1 + perceptual + KL * kl_weight (KL-VAE, a posterior
   sample decoded) or vq_loss * q_weight (VQ-VAE), plus the LSGAN generator
   term * adv_weight when ``adv_on``; gradients for the generator's params
   only (``torch.autograd.grad``: the discriminator's params get none);
3. the generator's update: clip + Adam (weight decay 0, fp32 first moment),
   ``MultiSteps`` under ``grad_accumulate_step``;
4. when ``adv_on``: the discriminator's LSGAN loss * adv_weight on the
   detached reconstruction and the batch, with the discriminator's params
   as they were before this step, then its own clip + Adam update.

The generator holds fp32 master params and computes in the compute dtype
(bf16 by default), as do the discriminator and the frozen perceptual
features. The GroupNorms of both networks (the discriminator's instance
norms are GroupNorms of one channel a group) run on the hand-written
GroupNorm kernels, forward and backward. The step updates the params and
both optimizer states in place and returns its losses as fp32 device
scalars (no host synchronisation).

On a (data, model) mesh (``common``'s module notes; JAX
``train_autoencoder.py:87-89``, :184-185): the generator's blocks take the
Megatron layout over the model axis, the discriminator stays replicated,
both networks' gradients are averaged over the data axis, the draws are
the global batch's (this rank takes its rows), the losses and the KL the
weight is set from are the global batch's, and rank 0 writes.

Random draws: the augmentation's from a CPU generator, the posterior noise
``eps`` from a generator on the device; ``draws`` (an ``AEDraws``)
replaces both, so a test can feed the JAX step's own numbers (split as
``aug_rng, samp_rng, d_rng``). A last/best payload holds ``vae`` (or
``vq``: the live generator, the key ``medimgen_torch_train_ldm`` reads),
``discriminator``, both optimizers' states (``mu``, ``nu``, ``count``, and
MultiSteps' ``acc`` / ``mini_step``), ``step`` (microsteps),
``validation_loss``, ``kl_weight``, both generators' states and the train
loader's state, so ``-c`` resumes bit for bit: unlike the JAX loop, which
restarts its step counter (and with it its keys) at 0 and measures an
``auto`` kl_weight again at the resumed params.

The generator is built with the config's ``use_checkpointing`` /
``remat_policy`` (ResBlock rematerialisation, ``models/autoencoder_kl.py``).
Not ported, and refused before the first step: the augmentations
``data/augment.py`` lacks.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import (
    apply_overrides,
    filter_config_by_mode,
    get_config_for_current_task,
    print_configuration,
)
from medical_image_generation_tpu_torch.data.augment import (
    AugmentConfig,
    AugmentDraws,
    augment_batch,
    make_draws,
)
from medical_image_generation_tpu_torch.data.loader import get_data_loaders
from medical_image_generation_tpu_torch.models.discriminator import (
    PatchDiscriminator,
    least_squares_gan_loss,
)
from medical_image_generation_tpu_torch.models.perceptual import PerceptualLoss
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup
from medical_image_generation_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    maybe_initialize_distributed,
)
from medical_image_generation_tpu_torch.parallel.sharding import (
    full_state_dict,
    gather_full,
    local_shards,
    local_state_dict,
    shard_module_,
)
from medical_image_generation_tpu_torch.planning.planner import compute_output_size
from medical_image_generation_tpu_torch.training import checkpoints as ckpt
from medical_image_generation_tpu_torch.training import common, plots
from medical_image_generation_tpu_torch.utils.profiling import profile_trace

METRICS = ("rec", "perc", "reg", "gen_adv", "disc")


def parse_kl_weight(kw) -> Tuple[bool, float]:
    """(auto?, value): 'auto' defers to ``adapt_kl_loss_weight`` at train
    start; a number (or None -> 1e-6) pins the weight."""
    if isinstance(kw, str):
        if kw.lower() == "auto":
            return True, 1e-6
        return False, float(kw)
    return False, float(1e-6 if kw is None else kw)


class AEDraws(NamedTuple):
    """Every random number of one train step. ``eps``: the posterior noise,
    latent-shaped (KL-VAE), or None (VQ-VAE)."""

    augment: AugmentDraws
    eps: Optional[torch.Tensor]


class AutoEncoderTrainer:
    """Stage-1 trainer of a KL-VAE or VQ-VAE against a PatchGAN
    discriminator. Build with ``from_config``."""

    def __init__(self, config: dict, model, discriminator: PatchDiscriminator,
                 perceptual: PerceptualLoss, latent_space_type: str = "vae",
                 device: str | torch.device = "cuda", seed: int = 0,
                 steps_per_epoch: int = 250, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.config = config
        self.mesh = common.resolve_mesh(mesh, config, self.device)
        self.data_axis = AxisGroup.of(self.mesh, "data")
        self.layout = shard_module_(model, self.mesh)  # the generator's; {} unless model > 1
        self.latent_space_type = latent_space_type
        self.model = model.train()
        self.discriminator = discriminator.train()
        self.perceptual = perceptual.eval()
        self.vae_params = common.generator_params(config, latent_space_type)
        self.spatial_dims = self.vae_params["spatial_dims"]
        self.adv_weight = float(config.get("adv_weight", 0.01))
        self.perc_weight = float(config.get("perc_weight", 0.5))
        self.auto_kl_weight, self.kl_weight = parse_kl_weight(config.get("kl_weight", 1e-6))
        self.q_weight = float(config.get("q_weight", 1.0))
        self.warm_up_epochs = int(config.get("autoencoder_warm_up_epochs", 5))
        self.n_epochs = int(config.get("n_epochs", 100))
        self.grad_accum = int(config.get("grad_accumulate_step", 1))
        self.clip = float(config.get("grad_clip_max_norm", 1.0))
        self.aug_cfg = AugmentConfig.from_transformations(
            config.get("ae_transformations", {}), spatial_dims=self.spatial_dims)

        self.g_names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.g_params = [p for p in model.parameters() if p.requires_grad]
        self.g_dims = [self.layout.get(n) for n in self.g_names]
        self.d_names = [n for n, p in discriminator.named_parameters() if p.requires_grad]
        self.d_params = [p for p in discriminator.parameters() if p.requires_grad]
        sched = config.get("lr_scheduler"), config.get("lr_scheduler_params")
        self.g_sched = common.make_lr_schedule(float(config.get("ae_learning_rate", 5e-5)),
                                               *sched, steps_per_epoch)
        self.d_sched = common.make_lr_schedule(float(config.get("d_learning_rate", 5e-5)),
                                               *sched, steps_per_epoch)
        self.g_opt = self._optimizer(self.g_params, self.g_sched, self.g_dims)
        self.d_opt = self._optimizer(self.d_params, self.d_sched)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step = 0  # microsteps taken (the JAX g_state.step)
        self.loss_dict: Dict[str, list] = {k: [] for k in (
            "train_rec", "val_rec", "perc", "reg", "gen_adv", "disc", "lr")}
        self.start_epoch = 0
        self.best_val = float("inf")
        self.resumed = False
        self.save_dict: Optional[Dict[str, str]] = None
        self.save_path: Optional[str] = None
        self.train_loader = None  # set by train(); its state goes into last/best
        self.epoch_stats: list = []  # one dict of host-side seconds an epoch

    def _optimizer(self, params, sched, dims=None):
        """optax ``adam`` (weight decay 0, fp32 first moment) after the
        global-norm clip, in MultiSteps under gradient accumulation (JAX
        ``training/common.py:87-114`` as the AE trainer calls it); ``dims``:
        the params' sharded dims under the Megatron layout, for the norm."""
        opt = common.AdamW(params, sched, clip=self.clip, weight_decay=0.0, mu_dtype=None,
                           sharded=[d is not None for d in dims or ()] or None,
                           norm_axis=AxisGroup.of(self.mesh, "model"))
        return common.MultiSteps(opt, self.grad_accum) if self.grad_accum > 1 else opt

    @staticmethod
    def from_config(config: dict, latent_space_type: str = "vae",
                    device: str | torch.device = "cuda", dtype=torch.bfloat16, seed: int = 0,
                    steps_per_epoch: int = 250,
                    mesh: Optional[Mesh] = None) -> "AutoEncoderTrainer":
        """Generator and discriminator with fp32 master params computing in
        ``dtype``, flax-style initialisation from ``seed``; the perceptual
        loss's frozen features from its own seeded generator (or
        ``MEDIMGEN_VGG_WEIGHTS``)."""
        dev = resolve_device(device)
        torch.manual_seed(seed)
        model = common.build_generator(config, latent_space_type, dtype, torch.float32, dev)
        common.init_like_flax_(model)
        disc = PatchDiscriminator.from_config(config["discriminator_params"], dtype=dtype,
                                              param_dtype=torch.float32, device=dev)
        common.init_like_flax_(disc)
        sd = common.generator_params(config, latent_space_type)["spatial_dims"]
        perceptual = PerceptualLoss.from_config(
            config.get("perceptual_params", {"spatial_dims": sd}), dtype=dtype, device=dev)
        return AutoEncoderTrainer(config, model, disc, perceptual, latent_space_type, dev, seed,
                                  steps_per_epoch, mesh)

    # ------------------------------------------------------------------ steps

    def latent_shape_of(self, batch):
        """(B, *latent spatial, latent channels) of a loader batch after the
        crop."""
        crop = self.aug_cfg.crop_to
        spatial = tuple(crop) if crop is not None else tuple(batch.shape[1:-1])
        lat = compute_output_size(spatial, self.vae_params["downsample_parameters"])
        ch = (self.vae_params["latent_channels"] if self.latent_space_type == "vae"
              else self.vae_params.get("embedding_dim", 8))
        return (batch.shape[0], *lat, ch)

    def make_draws(self, batch, generator: Optional[torch.Generator] = None,
                   host_generator: Optional[torch.Generator] = None) -> AEDraws:
        """The draws of the GLOBAL batch (``batch``: this rank's rows)."""
        host = host_generator or self.host_generator
        gen = generator or self.generator
        B = batch.shape[0] * self.mesh.shape["data"]
        eps = None
        if self.latent_space_type == "vae":
            eps = torch.randn((B, *self.latent_shape_of(batch)[1:]), device=self.device,
                              generator=gen)
        return AEDraws(make_draws(self.aug_cfg, B, batch.shape[-1], batch.dim() - 2, host, gen,
                                  tuple(batch.shape[1:-1])), eps)

    def _g_loss(self, imgs, eps, adv_on: bool):
        if self.latent_space_type == "vae":
            recon, mu, sigma = self.model(imgs, eps)
            reg = common.kl_loss(mu, sigma) * self.kl_weight
        else:
            recon, vq_loss = self.model(imgs)
            reg = vq_loss * self.q_weight
        rec = common.l1_loss(recon, imgs)
        perc = self.perceptual(recon, imgs) * self.perc_weight
        loss = rec + perc + reg
        gen_adv = torch.zeros((), device=self.device)
        if adv_on:
            gen_adv = least_squares_gan_loss(logits_fake=self.discriminator(recon)) \
                * self.adv_weight
            loss = loss + gen_adv
        return loss, {"rec": rec, "perc": perc, "reg": reg, "gen_adv": gen_adv}, recon

    def train_step(self, batch, adv_on: bool,
                   draws: Optional[AEDraws] = None) -> Dict[str, torch.Tensor]:
        """One generator (and, when ``adv_on``, discriminator) update on
        this rank's rows (B, *spatial_in, C) of the global batch, in [0, 1]
        (``draws``: the global batch's); returns the global batch's {rec,
        perc, reg, gen_adv, disc} as fp32 device scalars."""
        with self.mesh:
            return self._train_step(batch, adv_on, draws)

    def _train_step(self, batch, adv_on, draws):
        batch = batch.to(self.device)
        if draws is None:
            draws = self.make_draws(batch)
        draws = common.local_rows(draws, self.mesh)
        imgs = augment_batch(batch, draws.augment, self.aug_cfg)
        eps = None if draws.eps is None else draws.eps.to(self.device)
        loss, metrics, recon = self._g_loss(imgs, eps, adv_on)
        grads = list(torch.autograd.grad(loss, self.g_params, allow_unused=True))
        self.data_axis.all_reduce_mean_([g for g in grads if g is not None])
        self.g_opt.step(grads)
        del grads, loss
        d_loss = torch.zeros((), device=self.device)
        if adv_on:
            recon = recon.detach()
            logits_fake = self.discriminator(recon)
            logits_real = self.discriminator(imgs)
            d_loss = least_squares_gan_loss(logits_real=logits_real,
                                            logits_fake=logits_fake) * self.adv_weight
            d_grads = list(torch.autograd.grad(d_loss, self.d_params))
            self.data_axis.all_reduce_mean_(d_grads)
            self.d_opt.step(d_grads)
        self.step += 1
        out = {k: v.detach().float() for k, v in metrics.items()}
        out["disc"] = d_loss.detach().float()
        return {k: self.data_axis.mean(v) for k, v in out.items()}

    @torch.no_grad()
    def val_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(L1 of the reconstruction, the reconstruction) of a final-size
        batch: decode(mu) for the KL-VAE, the quantized path for the VQ-VAE."""
        batch = batch.to(self.device)
        with self.mesh:
            if self.latent_space_type == "vae":
                recon = self.model.reconstruct(batch)
            else:
                recon = self.model(batch)[0]
        return self.data_axis.mean(common.l1_loss(recon, batch)), recon

    @torch.no_grad()
    def adapt_kl_loss_weight(self, val_loader) -> None:
        """With ``kl_weight: auto`` (KL-VAE): kl_weight = 0.001 /
        10^floor(log10(mean KL)) over the validation batches. The KL depends
        on (mu, sigma) only, so no posterior sample is drawn (the JAX step
        draws one and decodes it, unused)."""
        if not (self.auto_kl_weight and self.latent_space_type == "vae"):
            return
        print("Setting KL loss weight from measured KL...")
        with self.mesh:
            kls = [self.data_axis.mean(common.kl_loss(*self.model.encode(
                common.batch_to_device(b, self.device)[0]))) for b in val_loader]
        mean_kl = float(torch.stack(kls).mean()) if kls else 0.0
        exponent = math.floor(math.log10(abs(mean_kl))) if mean_kl > 0 else 0
        self.kl_weight = 0.001 / (10 ** exponent)
        print(f"KL loss weight set to: {self.kl_weight}")

    # ------------------------------------------------------------ checkpoint

    def checkpoint_payload(self, epoch: int, val_loss: float) -> Dict:
        """The last/best payload (see the module docstring)."""
        def opt_state(opt, names, dims):
            return {k: ({n: t.detach().cpu() for n, t in zip(
                names, gather_full(v, dims, self.mesh))}
                if isinstance(v, list) else v) for k, v in opt.state().items()}

        # the generator under its latent space's name, "vae" or "vq", whole
        out = {"epoch": int(epoch),
               self.latent_space_type: full_state_dict(self.model, self.layout, self.mesh),
               "discriminator": {k: v.detach().cpu()
                                 for k, v in self.discriminator.state_dict().items()},
               "g_opt_state": opt_state(self.g_opt, self.g_names, self.g_dims),
               "d_opt_state": opt_state(self.d_opt, self.d_names, [None] * len(self.d_names)),
               "step": int(self.step), "validation_loss": float(val_loss),
               "kl_weight": float(self.kl_weight),
               "generators": {"host": self.host_generator.get_state(),
                              "device": self.generator.get_state()}}
        if self.train_loader is not None:
            out["train_loader"] = self.train_loader.state()
        return out

    @torch.no_grad()
    def load_payload(self, payload: Dict) -> None:
        """Restore both networks, both optimizer states, the step, the KL
        weight and the generator states from a last/best payload."""
        for key, opt, names, dims in (
                ("g_opt_state", self.g_opt, self.g_names, self.g_dims),
                ("d_opt_state", self.d_opt, self.d_names, [None] * len(self.d_names))):
            state = {k: (local_shards([v[n] for n in names], dims, self.mesh)
                         if isinstance(v, dict) else v) for k, v in payload[key].items()}
            if ("acc" in state) != (self.grad_accum > 1):
                raise ValueError("the checkpoint was written with gradient accumulation "
                                 f"{'on' if 'acc' in state else 'off'}; this run has "
                                 f"grad_accumulate_step={self.grad_accum}")
            opt.load_state(state)
        if self.latent_space_type not in payload:
            raise KeyError(f"the checkpoint holds no {self.latent_space_type!r} generator: "
                           "written by a run of another latent space?")
        self.model.load_state_dict(local_state_dict(payload[self.latent_space_type], self.layout,
                                                    self.mesh))
        self.discriminator.load_state_dict(payload["discriminator"])
        self.step = int(payload["step"])
        self.kl_weight = float(payload["kl_weight"])
        self.host_generator.set_state(payload["generators"]["host"])
        self.generator.set_state(payload["generators"]["device"])

    def _restore(self) -> None:
        """Resume from ``load_model_path``: the state, the train loader's
        draws, ``start_epoch = epoch + 1``, ``best_val`` (the saved epoch's
        validation loss, as the JAX loop sets it) and the loss history."""
        path = self.config["load_model_path"]
        if not os.path.exists(path):
            print(f"No checkpoint at {path}; training from scratch")
            return
        payload = ckpt.load_checkpoint(path)
        self.load_payload(payload)
        if "train_loader" in payload and self.train_loader is not None:
            self.train_loader.load_state(payload["train_loader"])
        self.start_epoch = int(payload["epoch"]) + 1
        self.best_val = float(payload["validation_loss"])
        self.resumed = True
        prior = ckpt.load_loss_dict(self.save_path)
        if prior:
            self.loss_dict = prior
        print(f"Resumed from {path} at epoch {self.start_epoch}")

    # -------------------------------------------------------------- main loop

    def train(self, train_loader, val_loader) -> None:
        if self.save_dict is None:
            self.save_dict, self.save_path = common.save_dirs(self.config, self.mesh)
        with profile_trace(self.config.get("profile_dir")), self.mesh:
            self._train_impl(train_loader, val_loader)

    def _train_impl(self, train_loader, val_loader) -> None:
        self.train_loader = train_loader
        print(f"Autoencoder parameters: {sum(p.numel() for p in self.g_params):,} | "
              f"Discriminator parameters: {sum(p.numel() for p in self.d_params):,}")
        if self.config.get("load_model_path"):
            self._restore()
        if not self.resumed:  # a resumed run keeps its saved kl_weight
            self.adapt_kl_loss_weight(val_loader)

        show_bar = bool(self.config.get("progress_bar"))
        for epoch in range(self.start_epoch, self.n_epochs):
            t0 = time.perf_counter()
            adv_on = epoch >= self.warm_up_epochs
            stats = {"epoch": epoch, "adv_on": adv_on, "wait_s": 0.0, "copy_s": 0.0}
            metrics = []
            # the AE ignores class labels
            for imgs, _ in common.timed_batches(train_loader, self.device, stats, show_bar,
                                                f"Epoch {epoch + 1}"):
                m = self.train_step(imgs, adv_on)
                metrics.append(torch.stack([m[k] for k in METRICS]))
            means = dict(zip(METRICS, torch.stack(metrics).mean(0).tolist()))  # one sync
            stats.update(train_s=time.perf_counter() - t0, steps=len(metrics))

            t1 = time.perf_counter()
            val_losses, last_pair = [], None
            for batch in val_loader:
                imgs = common.batch_to_device(batch, self.device)[0]
                loss, recon = self.val_step(imgs)
                val_losses.append(loss)
                last_pair = (imgs[0], recon[0])
            val_rec = float(torch.stack(val_losses).mean())
            if last_pair is not None:
                last_pair = tuple(t.float().cpu().numpy() for t in last_pair)
            stats.update(val_s=time.perf_counter() - t1, val_steps=len(val_losses))

            for key, value in (("train_rec", means["rec"]), ("val_rec", val_rec),
                               ("perc", means["perc"]), ("reg", means["reg"]),
                               ("gen_adv", means["gen_adv"]), ("disc", means["disc"]),
                               ("lr", float(self.g_sched(self.step)))):
                self.loss_dict.setdefault(key, []).append(value)
            print(
                f"Epoch {epoch + 1}/{self.n_epochs} | rec {means['rec']:.4f} | "
                f"val_rec {val_rec:.4f} | perc {means['perc']:.4f} | "
                f"reg {means['reg']:.3e} | adv {means['gen_adv']:.4f} | "
                f"disc {means['disc']:.4f} | {time.perf_counter() - t0:.1f}s | "
                f"{stats['train_s'] * 1e3 / stats['steps']:.1f} ms a train step"
            )
            t2 = time.perf_counter()
            stats.update(self._save_epoch_artifacts(epoch, val_rec, last_pair))
            stats["save_s"] = time.perf_counter() - t2
            self.epoch_stats.append(stats)

    def _save_epoch_artifacts(self, epoch, val_rec, last_pair) -> Dict:
        """loss.png and all_losses.png (when matplotlib is there),
        loss_dict.pkl, last / best, and every ``val_plot_interval`` epochs
        the last validation image beside its reconstruction. Returns the
        checkpoint names written, the payload's host-copy seconds and the
        interval image's path."""
        writer = self.mesh.is_writer
        if writer:
            plots.save_main_losses(self.loss_dict["train_rec"], self.loss_dict["val_rec"],
                                   os.path.join(self.save_dict["plots"], "loss.png"),
                                   title="L1 reconstruction loss")
            # lr rides in loss_dict.pkl but is not a loss
            plots.save_all_losses({k: v for k, v in self.loss_dict.items() if k != "lr"},
                                  os.path.join(self.save_dict["plots"], "all_losses.png"))
            ckpt.save_loss_dict(self.save_path, self.loss_dict)
        record = {"payload_s": 0.0}

        def payload():
            t = time.perf_counter()
            out = self.checkpoint_payload(epoch, val_rec)
            record["payload_s"] = time.perf_counter() - t
            return out

        record["saved"] = common.save_last_best(self, epoch, val_rec, payload)
        interval = int(self.config.get("val_plot_interval", 10))
        if writer and last_pair is not None and (epoch + 1) % interval == 0:
            record["recon"] = plots.save_reconstruction(*last_pair, self.save_dict["plots"],
                                                        epoch, self.spatial_dims)
        return record


# --------------------------------------------------------------------- CLI

def parse_arguments(argv: Optional[Sequence[str]] = None):
    parser = common.train_cli_parser(
        "Train an Autoencoder Model to reconstruct images (PyTorch port).")
    parser.add_argument("-l", "--latent_space_type", default="vae", choices=["vae", "vq"])
    args = common.parse_train_args(parser, argv)
    if args.splitting == "train-val-test" and args.fold is not None:
        parser.error("--fold should not be provided with 'train-val-test'")
    return args


def run_cli(argv: Optional[Sequence[str]] = None) -> AutoEncoderTrainer:
    """``medimgen_torch_train_autoencoder``: the JAX ``main``
    (train_autoencoder.py:463-481) on the port; returns the trainer after
    training. What the port cannot do is refused before the first step."""
    args = parse_arguments(argv)
    device = maybe_initialize_distributed(args.device) or resolve_device(args.device)
    config = get_config_for_current_task(
        args.dataset_id, args.model_type, "autoencoder",
        progress_bar=args.progress_bar, continue_training=args.continue_training,
    )
    # filter BEFORE overrides, latent_space_type first (as the JAX CLI)
    config["latent_space_type"] = args.latent_space_type
    config = filter_config_by_mode(config, "train_autoencoder")
    config = apply_overrides(config, args.overrides)
    if config.get("latent_space_type") != args.latent_space_type:
        raise ValueError(f"--set latent_space_type={config.get('latent_space_type')!r} "
                         f"disagrees with -l {args.latent_space_type}")
    trainer = AutoEncoderTrainer.from_config(
        config, args.latent_space_type, device=device, dtype=common.DTYPES[args.dtype], seed=0,
        steps_per_epoch=int(config.get("steps_per_epoch") or 250),
        mesh=get_mesh(model_parallel=int(config.get("model_parallel", 1)), device=device))
    print_configuration(config, config["results_path"], "train", model="autoencoder")
    train_loader, val_loader = get_data_loaders(
        config, args.dataset_id, args.splitting, config["ae_batch_size"],
        args.model_type, config["ae_transformations"], args.fold,
        data_parallel=trainer.mesh.shape["data"], mesh=trainer.mesh,
    )
    trainer.train(train_loader, val_loader)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cli(argv)


if __name__ == "__main__":
    main()

