#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --maisi    # phases 1-3 and 21 alone

Phases (any failure raises and exits non-zero):

1. build        -- compile every kernel in medical_image_generation_tpu_torch/csrc
                   with nvcc (one process per source, in parallel), print each
                   instantiation's registers and spills and ptxas's notes of
                   serialized wgmmas (none allowed in the bf16 dK/dV pass),
                   and check in the SASS (cuobjdump) that every bf16 flash
                   forward, dQ and dK/dV kernel issues HGMMA (wgmma).
2. kernels      -- each forward kernel against its plain PyTorch version on
                   CUDA tensors at the flagship path's shapes, bf16 and fp32:
                   max error against a stated tolerance, and median kernel /
                   plain / library times (CUDA events) beside the card's bound
                   (flash: TFLOP/s and the ratio to SDPA at both sites);
                   the GroupNorm stats + fold pass must take its 16-byte
                   loads at every flagship shape and give the same bits
                   twice.
3. kernels_bwd  -- the same for the backward kernels (flash dQ and dK/dV,
                   GroupNorm(+SiLU) backward stats and apply); dQ (with
                   delta), dK/dV and both GroupNorm backward passes must give
                   the same bits twice, and the GroupNorm backward must take
                   its 16-byte loads at every flagship shape. The flash
                   passes also at BWD_SHAPES (bf16: the 3D U-Net's sites at
                   the benchmark's batch, the KL-VAE's D = 128), with the
                   dK/dV pass's device ms.
4. parity       -- the tiny 3D config (seeded random weights, fp32, TF32 off)
                   through one U-Net forward and one decode, and through one
                   whole train step from the same weights and random draws,
                   on the CPU (plain versions) and on the GPU (kernels).
5. slice        -- flagship 3D LDM sampling at full width (U-Net
                   [256,512,768], VAE decoder [32,64,128], bf16, batch 2,
                   seeded random weights in every layer): 10 DDIM steps
                   through LDMSampler, then decode to (2, 128, 128, 128, 1);
                   checks the output and the launch counts the code predicts.
6. train        -- the flagship train step (whose launch counts the JSON reports): batch
                   2 of the enlarged (128, 143, 143) loader patch, augment ->
                   frozen KL-VAE encode -> U-Net forward + backward (bf16
                   compute, fp32 masters) -> clip + AdamW(bf16 mu); 2 warm-up
                   and 10 timed steps with the launch counts the code predicts,
                   a profile of one step (each port kernel's device ms beside
                   the bound summed over the step's launches), the peak
                   memory of the step, the U-Net forward + backward and the
                   optimizer alone, the optimizer's two kernels at the
                   U-Net's parameter list against the plain version
                   (``opt_check``: one clipped and one unclipped step, params,
                   mu and nu within OPT_RTOL; device ms, bound and the plain
                   version's ms), then save_checkpoint and sample one volume
                   from it through LDMSampler.from_config.
7. ae_parity    -- the tiny 3D config (seeded random weights, fp32, TF32 off)
                   through one stage-1 AE train step with the adversarial
                   loss on the CPU (plain versions) and on the GPU (kernels),
                   from the same draws: the five losses, the generator's and
                   the discriminator's gradients, the launches predicted.
8. ae_train     -- the flagship stage-1 step (KL-VAE [32,64,128], latent 8,
                   16 groups, fp32 masters and bf16 compute; PatchDiscriminator
                   64ch x3; fake-3D VGG16 perceptual loss at ratio 0.2; batch 2
                   of the rotation-enlarged (128, 165, 165) patch): 2 warm-up and 10
                   timed steps without, then with the adversarial loss (ms a
                   step, peak memory, launches held to the prediction, every
                   GroupNorm shape held by phases 2-3, a profile with device
                   busy, idle share and each kernel's device ms beside its
                   summed bound), then the parts alone (VAE forward+backward,
                   perceptual, the discriminator's passes, both optimizers).
9. ae_cli       -- in a temporary directory under build/ with a synthetic
                   preprocessed dataset (8 patients of (1, 144, 160, 160) with
                   a foreground sphere each, written with the port's
                   VolStore): medimgen_torch_train_autoencoder for one epoch
                   of 100 + 20 steps (the loader's 250 + 50, cut) without the
                   adversarial loss (last and best written), then -c to a
                   second epoch with it (restored state bit for bit equal to
                   the file, the train loader's draws too; the generator's
                   Adam count 100 -> 200, the discriminator's 0 -> 100),
                   launches held to the prediction.
10. cli         -- the LDM training CLI end to end at the same flagship width, on
                   the same dataset and on the best_model.pt phase ae_cli
                   wrote: the loader alone for one train epoch (batches/s,
                   bytes decoded a second); medimgen_torch_train_ldm for one
                   epoch of 100 train and 20 val steps with the interval
                   sampling (2 volumes, 10 DDIM steps) and last/best written,
                   its launch counts held to what the code predicts; a resume
                   with -c to a second epoch (restored state bit for bit
                   equal to the file, the train loader's draws too, AdamW's
                   count 100 -> 200, loss_dict of 2 epochs); then
                   medimgen_torch_sample_ldm on best_model.pt (2 volumes, 10
                   DDIM steps, read back from their .nii.gz), then phase 13.
                   It prints the codec, loader batches/s, CLI ms a step beside
                   phase 6's, the loader wait and copy ms a step,
                   val ms a step and the checkpoints' bytes and write / read
                   seconds, each with the card's name and power limit.

11. kernels_2d   -- (after phase 3) every kernel against its plain version at
                   the planner's 2D flagship shapes, bf16 and fp32: flash
                   forward, dQ and dK/dV at (48, 1024, 1, 512) and (48, 256,
                   1, 768) (the 2D U-Net's two sites, batch 48), the forward
                   at the sampling chunks of 16 and 4 (and at the one 3D
                   volume phase 6 samples, batch 1); the four GroupNorm
                   kernels at every GN_SHAPES_2D shape (the 2D VAE at batch
                   24 and 48, the 2D discriminator, the U-Net at 48, 16 and
                   4, the eval's ResNet50 instance norms over 100 2D images
                   and two 3D volumes, phase 15's 2D probe trial at patch 128
                   x 160), 16-byte loads and the same bits twice.
12. train_2d     -- (after phase 8) the 2D flagship at full width (KL-VAE [64,
                   128, 256] and the 2D discriminator at batch 24 of the
                   rotation-enlarged (330, 330) patch; U-Net [256, 512, 768]
                   at batch 48 of (285, 285) -> latent 64^2 x 8): 2 + 10 AE
                   steps without, then with the adversarial loss, and 2 + 10
                   LDM steps, each with ms a step, device busy and idle share
                   (profiler), peak memory, launches held to the prediction,
                   every GroupNorm shape held by phase 11, each kernel's
                   device ms beside its summed bound, and the parts alone;
                   then ``opt_check`` at the 2D U-Net's parameter list.
13. eval_3d      -- (inside phase 10) the 3D eval's features:
                   FeatureExtractor(spatial_dims=3) on the two volumes the 3D
                   sampling CLI wrote, read back from their .nii.gz, timed.
14. cli_2d       -- (after phase 10) a synthetic 2D task (Task098, 8 patients
                   of (1, 48, 256, 256)): medimgen_torch_train_autoencoder 2d
                   for an epoch, then medimgen_torch_train_ldm 2d for an epoch
                   with val_plot_interval 1 and the default
                   run_generation_eval: the interval grid of 16 and
                   evaluate_generation with n = 100 (FID, SSIM, MS-SSIM and
                   MMD over 4950 pairs, seconds by part, launches held to the
                   prediction); one 16-sample chunk of the full 1000-step
                   ancestral trajectory, timed, and the full protocol's cost
                   projected from it; then medimgen_torch_sample_ldm writing 4
                   PNGs and the grid, read back. Cuts: epochs of 40 train / 8
                   val steps (the loader's 250 / 50), DDIM 10 for the grid
                   and the eval (JAX keys eval_sampler / eval_num_inference_
                   steps; the protocol's default is the 1000-step DDPM).
15. plan         -- (after phase 14) a raw MSD-style task (Task097, 8 patients
                   of .nii.gz written with the port's save_nifti, 120-150
                   voxels an axis, two spacings, three wider than the median
                   in X) through medimgen_torch_plan_and_preprocess with the
                   memory probe: fingerprint, preprocessing and probe timed
                   apart; the 3D vae_params equal the flagship's; the plan
                   (expected: no remat at batch 2 / 24) and each probe
                   trial's peak (reserved and allocated) against the budget,
                   launches held to the prediction; every .vs read back bit
                   for bit against process_patient's arrays. Then the forced
                   ladder at the 3D flagship, batch 2: peak and ms a step
                   for no remat, "acts" and "full" (launches a step held to
                   the prediction: a rematerialised ResBlock runs its two
                   GroupNorm forwards again), auto_select_hyperparams at
                   budgets between those peaks picking (2, 1, True, "acts")
                   (only where "acts" saves 2% or more) and (2, 1, True,
                   "full"); one step from the same weights and draws under
                   each rung against no remat (and no remat against itself:
                   the noise floor); and medimgen_torch_train_autoencoder on
                   the plan with use_checkpointing: true and the policy the
                   ladder chose, one epoch cut to 20 train / 4 val steps,
                   launches held to the prediction. Every GroupNorm shape of
                   the phase is one that phases 3, 4 or 11 hold against the
                   plain versions.

16. ddpm_train   -- (after phase 12) the pixel-space DDPM step (DDPMTrainer,
                   U-Net [256, 512, 768] at pixel resolution, in and out
                   channels 1, fp32 masters, bf16, seeded random weights) at
                   the planner's 3D flagship (batch 4 of (128, 143, 143) ->
                   128^3) and 2D flagship (batch 48 of (285, 285) -> 256^2):
                   one step at the planner's batch without and with
                   use_checkpointing (an out-of-memory error is the
                   measured result, with the bytes it asked), then batches
                   halved until one fits (no remat tried first); at that
                   batch 2 (3D) / 4 (2D) timed steps (ms, peak, launches
                   held to the prediction: every GroupNorm forward kernel
                   46 + 34 times a step under remat), a profile of one step
                   (device busy, idle share, each kernel's device ms beside
                   its summed bound), the two 1-channel convs' kernels
                   (cuDNN's pick), and one sampling forward at batch 1 (3D)
                   / 16 and 4 (2D) with its launches. Every flash and
                   GroupNorm shape met is recorded (the flash calls of the
                   trials that ran out of memory too).
17. kernels_ddpm -- every kernel at every flash and GroupNorm shape phase 16
                   met, bf16 and fp32 (bf16 only, untimed, where only a
                   trial that ran out of memory met it), same bits twice:
                   flash forward, dQ
                   and dK/dV at (B, 262144, 1, 512), (B, 32768, 1, 768),
                   (B, 16384, 1, 512) and (B, 4096, 1, 768) and the sampling
                   batches, against chunked plain references (the lse over
                   every query and key, o / dQ at four query tiles, dK / dV
                   at four key tiles summed over every query, delta every
                   row), with ms, the bound and SDPA's memory-efficient
                   backend beside them (its backward as forward + backward
                   minus forward; one timed call after one warm call at
                   262144 tokens); the four GroupNorm kernels against
                   plain versions computed in row chunks. No fp32 flash at
                   262144 tokens and no fp32 GroupNorm over 2^31 elements
                   (scalar fp32 kernels and whole fp32 references too slow
                   or too large there; neither is on the DDPM's path).
18. ddpm_cli     -- (last, in the CLI workspace, after deleting the earlier
                   phases' runs) medimgen_torch_train_ddpm at the batch and
                   remat phase 16 chose: 2D on Task098, one epoch of 6 + 2
                   steps with the interval grid (16 samples, DDIM 50),
                   last / best, then -c to a second epoch (restored state
                   bit for bit, AdamW's count carries on), then
                   medimgen_torch_sample_ddpm writing 4 PNGs and the grid
                   (DDIM 10), read back; 3D on the dataset of phase 10, one
                   epoch of 2 + 1 steps, then the sampling CLI writing one
                   .nii.gz at 2 DDIM steps, read back. Launches held to the
                   prediction; every GroupNorm shape held by phase 17.
19. aug_cond     -- (inside the CLI workspace, after phase 9) the modules of
                   slice 12 at the 3D flagship's width, bf16, seeded weights:
                   the AE step with the adversarial loss under aug_preset
                   nnunet with gaussian_noise, gaussian_blur, low_resolution
                   and elastic on and the KL-VAE's transposed-conv upsample
                   (batch 2 of the (310, 315, 309) initial patch: rotation
                   about all three axes onto 128^3), 2 + 10 steps; the LDM
                   step of the conditioned U-Net (a SpatialTransformer at each
                   of the 11 attention sites, 528,892,424 params) under the
                   same augmentations (batch 2 of (183, 183, 183): scaling
                   resampled in 3D), 2 + 10 steps. For each: ms a step, peak
                   memory, launches held to the prediction (two flash calls
                   a transformer layer), idle share and each kernel's device
                   ms beside its summed bound (profiler), every GroupNorm
                   shape held by phases 2-3, and augment_batch alone with one
                   transform's coin forced on at a time; for the AE batch its
                   bytes, one copy to the card and the loader's batches/s at
                   that patch on phase 9's dataset beside the step rate. Then
                   the tiny config CPU vs GPU (fp32): a DiffusionEncoder
                   forward and backward and a conditioned U-Net forward with
                   ControlNet residuals; both once at flagship width (timed,
                   launches held). Then a context of its own length and
                   width: the flash forward, dQ and dK/dV at every
                   CONTEXT_PAIRS (q shape, Sk) against their plain versions
                   (bf16; fp32 at CONTEXT_F32), the backward the same bits
                   twice, with ms, the bound, plain ms and SDPA's forward
                   and forward + backward; the tiny fp32
                   U-Net built with context_dim 12, CPU vs GPU, forward and
                   backward with a (2, 7, 12) context; and the flagship-width
                   U-Net with context_dim 768 (bf16, batch 2 of the 32^3 x 8
                   latent), forward + backward with a context of 77 tokens,
                   then of 1: ms forward and backward, 22 launches of each
                   flash kernel (11 self, 11 to the context), no plain
                   attention on the card, idle share, peak memory.
20. dist         -- (after phase 17) (a) the ring attention's per-step block
                   math (ops/ring_attention.py ring_forward / ring_backward,
                   the path's functions, with the n blocks rotated in this
                   process) at (1, 262144, 1, 512), n = 4 (the 3D pixel
                   DDPM's attention as 4 ranks would hold it) and (2, 32768,
                   1, 768), n = 2, bf16, against the whole-sequence flash
                   kernels on the same input at RING_TOL / RING_BWD_TOL, with
                   n^2 launches of each flash kernel and the ms of both in
                   turns; each block shape, and each whole shape no earlier
                   phase held, against the chunked plain versions; (b) python
                   -m torch.distributed.run --nproc_per_node=1 of
                   bench/dist_steps.py: 3 flagship 3D LDM steps (U-Net
                   [256,512,768], batch 2 of (128, 143, 143), bf16, seeded
                   weights) through maybe_initialize_distributed and NCCL,
                   against the same steps run twice in this process without a
                   process group: losses, gradient norms and parameter sums
                   within twice the spread of those two runs (at least 2^-20
                   of the value), launches equal; (c) with two cards, 2 NCCL
                   ranks: data = 2 (a row a rank) against the one-process
                   steps (losses, gradient norms, parameter sums within the
                   spread and DIST_DP_RTOL / DIST_DP_SUM_RTOL), every rank's
                   parameter sums equal, and the ring at (1, 262144, 1, 512)
                   over model = 2 against the whole-sequence kernels; with one
                   card it says so.
21. maisi        -- (after phase 12) MAISI's diffusion U-Net
                   (benchmark/configs/maisi_ct3d.json: [64, 128, 256, 512],
                   heads of 32 at levels 2 and 3, the region and spacing
                   embeddings): the flash forward, dQ and dK/dV at its two
                   sites, (1, 32768, 8, 32) and (1, 4096, 16, 32), bf16 and
                   fp32, against the chunked plain references of phase 17,
                   with ms, the bound, the plain version's ms over every row
                   (a chunk of query rows at a time) and SDPA's; then
                   LDMTrainer on precomputed latents (bf16, seeded weights,
                   batch 1 of a 4 x 128^3 latent with its conditioning): one
                   step counted from launch counts set to 0 just before it,
                   held to the prediction (11 of each flash kernel, 56 of
                   each GroupNorm kernel, the optimizer's tables), every
                   flash call at a shape a phase held and every GroupNorm
                   shape in GN_SHAPES (phases 2-3), no input copied and
                   every GroupNorm launch with 16-byte loads; ms a step
                   (CUDA events) and the step's peak memory.
Every flash forward and backward of every phase is recorded with q's shape
and the keys' length, and the run fails at the end if one ran at a (shape,
Sk) no kernel phase (or the CPU-vs-GPU parity phases) held against its plain
version.

The last two lines of standard output are the kernels' JSON record (launches
counted on the LDM train path, ``ae_launches`` on the ten timed AE steps with
the adversarial loss, ``launches_2d`` a 2D LDM step, a 2D AE step with the
adversarial loss, one 2D eval and the 3D eval call, ``launches_plan`` one
3D AE step with the adversarial loss under each remat rung, ``launches_ddpm``
a 2D and a 3D DDPM step, one 2D (batch 16) and one 3D (batch 1) sampling
forward and each DDPM CLI's first epoch, ``step_ms_ddpm`` each kernel's
device ms / bound a DDPM step, ``shapes_ddpm`` (shape, ms, bound_ms) at
phase 17's shapes, ``launches_aug_cond`` an AE step and a conditioned LDM step of
phase 19, ``step_ms_aug_cond`` their device ms / bound, ``shapes_context`` (shape,
Sk, ms, bound_ms) at phase 19's context pairs, ``launches_context`` one flagship
U-Net forward + backward with a 77-token context, ``launches_ring`` phase 20's
in-process rings, ``launches_dist_step`` a torchrun LDM step; the optimizer's
``sq_norm`` and ``adamw_update`` with their launches on every training path
and ``opt_check``'s records at the 3D and 2D flagship U-Nets; ``launches_maisi``
phase 21's step and ``shapes_maisi`` (shape, dtype, ms, bound_ms, plain_ms,
library_ms) at its flash sites) and the device record; the
card's name and power limit are printed before them.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from medical_image_generation_tpu_torch.bench import randomize_
from medical_image_generation_tpu_torch.ops import kernels as kernel_table

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM fp32 (non-tensor) rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate

FLASH_TOL = {  # (rtol, atol) elementwise on o: |o - o_plain| <= atol + rtol * |o_plain|
    torch.bfloat16: (2**-7, 2**-10),  # one bf16 ulp of o, plus P rounded to bf16 before P V
    torch.float32: (0.0, 1e-5),       # summation order only
}
LSE_TOL = 1e-4  # max abs error of the f32 row logsumexp (~8.9 at 4096 keys), any dtype
AFFINE_TOL = {  # (rtol, atol) elementwise: |y - y_plain| <= atol + rtol * |y_plain|
    torch.bfloat16: (2**-7, 2**-9),  # one bf16 ulp (exp/sigmoid rounding can flip it)
    torch.float32: (1e-6, 1e-6),
}
STATS_REL_TOL = 1e-4  # stats: max abs error / max |sum|, fp32 summation order
FOLD_REL_TOL = 1e-5   # fold: max abs error / max |ref|, fp32 (rsqrtf, sum order)
# Backward kernels, elementwise per tensor: |g - g_plain| <= rtol * |g_plain|
# + atol * max|g_plain|.
FLASH_BWD_TOL = {
    # one bf16 ulp of the output, plus p and ds rounded to bf16 before their
    # products (sums of random-sign terms: ~2^-9 of a typical element)
    torch.bfloat16: (2**-7, 2**-8),
    torch.float32: (1e-5, 1e-5),  # summation order only
}
GN_BWD_TOL = {
    torch.bfloat16: (2**-7, 1e-5),  # one bf16 ulp of dx: fp32 sums in another order flip it
    torch.float32: (1e-5, 1e-5),    # summation order only
}
GN_PARAM_GRAD_TOL = 1e-4  # dscale, dbias, [P, Q]: max abs error / max |ref|, fp32 sums
# tiny-config train step, fp32 with TF32 off, CPU vs GPU: per-gradient max abs
# error / max |ref| (summation order over up to 16^3 positions and the
# gradient-norm clip); loss relative
PARITY_GRAD_TOL = 1e-4
PARITY_LOSS_TOL = 1e-5
LR = 2e-5  # the flagship config's ddpm_learning_rate
OPT_RTOL = 1e-6  # clip + AdamW kernels vs the plain version driven by their norm (same ops)
OPT_NORM_RTOL = 1e-5  # the kernels' gradient norm vs the plain one: fp32 summation order

GN_SHAPES = [  # (M, C, groups) of every GroupNorm on the flagship and MAISI paths, batch 2
    (32768, 256, 32), (32768, 768, 32), (4096, 512, 32), (4096, 1280, 32),
    (512, 768, 32), (512, 1536, 32), (32768, 128, 16), (262144, 64, 16),
    (2097152, 32, 16),
    # the KL-VAE's other widths, forward and backward (stage-1 training): the
    # first ResBlock of a level normalises the previous level's channels
    (262144, 32, 16), (32768, 64, 16), (262144, 128, 16), (2097152, 64, 16),
    # the discriminator's instance norms: one channel a group, 32^3 and 31^3 rows
    (32768, 128, 128), (29791, 256, 256),
    # the U-Net's other widths (the up path's concatenations, the levels' first
    # blocks), which phase aug_cond's LDM step checks against this list
    (32768, 512, 32), (4096, 256, 32), (4096, 768, 32), (4096, 1024, 32),
    (512, 512, 32), (512, 1280, 32),
    # MAISI's U-Net (phase maisi) at a 128^3 latent: 2 to 12 channels a group
    (2097152, 64, 32), (2097152, 128, 32), (2097152, 192, 32), (262144, 64, 32),
    (262144, 128, 32), (262144, 192, 32), (262144, 256, 32), (262144, 384, 32),
    (32768, 128, 32), (32768, 384, 32)]
FLASH_SHAPES = [(2, 4096, 1, 512), (2, 512, 1, 768), (2, 1000, 3, 96)]  # (B, S, H, D)
FLAGSHIP_FLASH = FLASH_SHAPES[:2]  # the U-Net's two attention sites
# the backward alone, bf16: the 3D U-Net's two sites at the benchmark's batch
# of 4 and the KL-VAE's single-head attention at D = 128
BWD_SHAPES = [(4, 4096, 1, 512), (4, 512, 1, 768), (1, 4096, 1, 128)]
FLASH_TILE = 32  # keys a tile of the forward kernel, queries a tile of the dK/dV kernel
DQ_TILE = 16     # keys a tile of the dQ kernel at the flagship sites (its smallest tile)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=3, iters=10):
    """Median per-call time in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(flops, nbytes, peak_flops):
    """(least ms for the work on this card, "operations" or "bytes")."""
    return max((flops / peak_flops * 1e3, "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"))


def phase_build():
    import threading

    from medical_image_generation_tpu_torch.io import volstore
    from medical_image_generation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    codec = threading.Thread(target=volstore.codec_in_use)  # g++, beside the nvcc builds
    codec.start()
    logs = _build.build_all(kernel_table.SOURCES)
    codec.join()
    log(f"[build] {len(logs)} libraries built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # ptxas's "Potential Performance Loss" notes (C7510-C7519): wgmmas it
    # serialized; the pipelined dK/dV pass must compile without them
    serialized = [line.strip() for text in logs.values() for line in text.splitlines()
                  if "Potential Performance Loss" in line]
    for line in serialized:
        log(f"[build] {line}")
    if any("flash_bwd_dkdv_bf16" in line for line in serialized):
        raise AssertionError("ptxas serializes the wgmmas of the bf16 dK/dV pass")
    check_hgmma(_build)


def check_hgmma(build):
    """Every instantiation of the bf16 flash forward, dQ and dK/dV kernels,
    wide and narrow, must issue HGMMA (wgmma) in its SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel in ((k.source, dn) for k in kernel_table.KERNELS.values()
                        for dn in k.device_names if dn.startswith("flash_") and "bf16" in dn):
        sass = subprocess.run([tool, "--dump-sass", build.lib_path(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts, cur = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                cur = fn if kernel in fn else None
                if cur:
                    counts[cur] = 0
            elif cur and "HGMMA" in line:
                counts[cur] += 1
        log(f"[build] SASS {lib}: HGMMA instructions per {kernel} instantiation "
            f"{sorted(counts.values())}")
        if not counts or not all(counts.values()):
            raise AssertionError(f"{kernel} has no HGMMA in its SASS: {counts}")


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def within(got, ref, rtol, atol_rel):
    """(every element within rtol*|ref| + atol_rel*max|ref|, max abs error,
    largest error / allowed error over the elements)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    allowed = rtol * r.abs() + atol_rel * r.abs().max()
    return bool((d <= allowed).all()), d.max().item(), (d / allowed).max().item()


def flash_close(o, lse, o_ref, lse_ref, dtype):
    """(o within FLASH_TOL, lse within LSE_TOL, max|o - o_ref|, max|lse - lse_ref|)."""
    rtol, atol = FLASH_TOL[dtype]
    d = (o.float() - o_ref.float()).abs()
    lerr = _err(lse, lse_ref)
    o_ok = bool((d <= atol + rtol * o_ref.float().abs()).all())
    return o_ok, lerr <= LSE_TOL, d.max().item(), lerr


def top_kernel(fn):
    """Name of the device kernel with the most time in one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
    return max(by, key=by.get)[:90] if by else "not recorded"


def add_record(rec, name, r):
    """The first flagship shape's record is the kernel's; later shapes are
    listed under "other_shapes"."""
    if name in rec:
        rec[name].setdefault("other_shapes", []).append(r)
    else:
        rec[name] = r


def phase_kernels():
    """Returns {kernel: record at its representative shape}."""
    import torch.nn.functional as F

    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {}

    # ---- flash attention: (B, S, H, D) of the U-Net's attention sites
    for (B, S, H, D) in FLASH_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
                       for _ in range(3))
            scale = D ** -0.5
            o, lse = fa.flash_attention(q, k, v, scale)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
            # each tolerance, o's and lse's, must see a kernel that skips one K/V tile
            o_cut, lse_cut = fa.flash_attention_plain(q, k[:, FLASH_TILE:], v[:, FLASH_TILE:],
                                                      scale)
            torch.cuda.synchronize()
            o_ok, l_ok, err, lerr = flash_close(o, lse, o_ref, lse_ref, dt)
            ok = o_ok and l_ok
            cut_seen = not any(flash_close(o_cut, lse_cut, o_ref, lse_ref, dt)[:2])
            ms = time_ms(lambda: fa.flash_attention(q, k, v, scale))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale), 1, 5)
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
            flops = 4 * B * H * S * S * D
            nbytes = 4 * B * S * H * D * q.element_size() + 4 * B * H * S
            peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
            bnd, bound_by = bound(flops, nbytes, peak)
            rtol, atol = FLASH_TOL[dt]
            log(f"[kernels] flash_attn_fwd {str(dt)[6:]} B={B} S={S} H={H} D={D}: "
                f"max|o-o_plain|={err:.3e} (tol {atol:g} + {rtol:g}*|o|, max|o_plain|="
                f"{o_ref.float().abs().max().item():.3e}) max|lse-lse_plain|={lerr:.3e} "
                f"(tol {LSE_TOL:g}) one-tile-skip caught={cut_seen} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={bnd:.4f} "
                f"({bound_by}) ({flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.2f}x SDPA's time) "
                f"{'OK' if ok and cut_seen else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash attention disagrees with its plain version at "
                                     f"{(B, S, H, D)} {dt}: {err} / {lerr}")
            if not cut_seen:
                raise AssertionError(f"flash tolerance at {(B, S, H, D)} {dt} cannot see a "
                                     "skipped K/V tile")
            if (B, S, H, D) in FLAGSHIP_FLASH and dt == torch.bfloat16:
                add_record(rec, "flash_attn_fwd", dict(
                    shape=[B, S, H, D], dtype="bf16", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=bound_by, library_ms=lib_ms,
                    tflops=flops / ms / 1e9))

    # ---- GroupNorm stats + fold, affine(+SiLU): (B, M, C) activations, groups
    B = 2
    for (M, C, G) in GN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((B, M, C), generator=gen, device="cuda") * 1.3 + 0.7).to(dt)
            w = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
            b = 0.1 * torch.randn(C, generator=gen, device="cuda")
            vec0 = kernel_table.read("gn_stats_fold.vector_launches")
            st, A, bb = gn.stats_fold(x, w, b, G, 1e-6)
            vec_path = kernel_table.read("gn_stats_fold.vector_launches") == vec0 + 1
            st_ref, rA, rbb = gn.stats_fold_plain(x, w, b, G, 1e-6)
            # no float atomics, fixed summation order
            st_same = all(torch.equal(u, v) for u, v in
                          zip((st, A, bb), gn.stats_fold(x, w, b, G, 1e-6)))
            torch.cuda.synchronize()
            serr = _err(st, st_ref)
            srel = serr / st_ref.abs().max().item()
            ferr = max(_err(A, rA) / rA.abs().max().item(), _err(bb, rbb) / rbb.abs().max().item())
            y = gn.affine_act(x, A, bb, True)
            y_ref = gn.affine_act_plain(x, A, bb, True)
            torch.cuda.synchronize()
            aerr = _err(y, y_ref)
            rtol, atol = AFFINE_TOL[dt]
            a_ok = bool(((y.float() - y_ref.float()).abs()
                         <= atol + rtol * y_ref.float().abs()).all())
            ok = srel <= STATS_REL_TOL and a_ok and ferr <= FOLD_REL_TOL and st_same and vec_path
            isz = x.element_size()
            s_ms = time_ms(lambda: gn.stats_fold(x, w, b, G, 1e-6))
            s_plain = time_ms(lambda: gn.stats_fold_plain(x, w, b, G, 1e-6), 1, 5)
            s_lib = time_ms(lambda: torch.var_mean(x, dim=1, correction=0))
            a_ms = time_ms(lambda: gn.affine_act(x, A, bb, True))
            a_plain = time_ms(lambda: gn.affine_act_plain(x, A, bb, True), 1, 5)
            xl = x.permute(0, 2, 1)  # (B, C, M) view of the same buffer
            lib_ms = time_ms(lambda: F.silu(F.group_norm(xl, G, w.to(dt), b.to(dt), 1e-6)))
            s_bound = stats_fold_bytes(B, M, C, isz) / PEAK_BYTES * 1e3
            a_bound = (B * M * C * 2 * isz + 2 * B * C * 4) / PEAK_BYTES * 1e3
            log(f"[kernels] groupnorm {str(dt)[6:]} B={B} M={M} C={C} G={G}: "
                f"stats+fold stats rel_err={srel:.3e} (tol {STATS_REL_TOL:g}) A/b rel_err="
                f"{ferr:.3e} (tol {FOLD_REL_TOL:g}) 16-byte loads={vec_path} bit-identical on a "
                f"rerun={st_same} ms={s_ms:.4f} plain_ms={s_plain:.4f} var_mean_ms={s_lib:.4f} "
                f"bound_ms={s_bound:.4f} ({s_bound / s_ms:.2f} of the bound's rate) | affine+silu "
                f"max_abs_err={aerr:.3e} (tol {atol:g} + {rtol:g}*|y|) ms={a_ms:.4f} plain_ms={a_plain:.4f} "
                f"bound_ms={a_bound:.4f} | F.group_norm+F.silu ms={lib_ms:.4f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"GroupNorm kernels disagree at {(B, M, C)} {dt}: "
                                     f"stats {srel}, A/b {ferr} (same bits on a rerun "
                                     f"{st_same}, 16-byte loads {vec_path}), affine {aerr}")
            if dt == torch.bfloat16:  # every GroupNorm shape, (2, 32768, 256) first
                add_record(rec, "gn_stats_fold", dict(
                    shape=[B, M, C], dtype="bf16",
                    max_abs_err=max(serr, _err(A, rA), _err(bb, rbb)), ms=s_ms,
                    plain_ms=s_plain, bound_ms=s_bound, bound_by="bytes", library_ms=s_lib))
            if (M, C) == (32768, 256) and dt == torch.bfloat16:
                rec["gn_affine_act"] = dict(
                    shape=[B, M, C], dtype="bf16", max_abs_err=aerr, ms=a_ms, plain_ms=a_plain,
                    bound_ms=a_bound, bound_by="bytes", library_ms=lib_ms)
    return rec


def stats_fold_bytes(B, M, C, isz):
    """Bytes the GroupNorm stats + fold pass must move: x once, weight and
    bias, the (B, 2, C) sums and the (B, C) A and b in fp32."""
    return B * M * C * isz + 2 * C * 4 + 4 * B * C * 4


def phase_kernels_bwd():
    """The backward kernels against their plain versions; returns
    {kernel: record at its representative shape}."""
    import torch.nn.functional as F

    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = {}

    # ---- flash backward: dQ pass, then dK/dV pass
    for (B, S, H, D) in FLASH_SHAPES + BWD_SHAPES:
        for dt in ((torch.bfloat16, torch.float32) if (B, S, H, D) in FLASH_SHAPES
                   else (torch.bfloat16,)):
            q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
                           for _ in range(4))
            scale = D ** -0.5
            o, lse = fa.flash_attention_plain(q, k, v, scale)
            dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
            dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, scale)
            r_dq, r_delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, scale)
            r_dk, r_dv = fa.flash_bwd_dkdv_plain(q, k, v, do, lse, r_delta, scale)
            # the tolerance must see a backward that skips one K/V tile of the
            # dq kernel or one Q/dO tile of the dk/dv kernel
            c_dq = fa.flash_attention_bwd_plain(q, k[:, DQ_TILE:], v[:, DQ_TILE:], o, lse, do,
                                                scale)[0]
            lse_c = lse.reshape(B * H, S)[:, FLASH_TILE:]
            _, c_dk, c_dv = fa.flash_attention_bwd_plain(q[:, FLASH_TILE:], k, v,
                                                         o[:, FLASH_TILE:], lse_c,
                                                         do[:, FLASH_TILE:], scale)
            # no atomics, fixed summation orders: dq, delta, dk, dv the same bits twice
            dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
            dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, scale)
            same_bits = all(torch.equal(a_, b_) for a_, b_ in
                            ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
            torch.cuda.synchronize()
            tol = FLASH_BWD_TOL[dt]
            res = {n: within(g, r, *tol) for n, g, r in
                   (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv))}
            d_ok, d_err, _ = within(delta, r_delta, 1e-5, 1e-5)
            ok = all(v_[0] for v_ in res.values()) and d_ok
            use = max(v_[2] for v_ in res.values())
            cut_seen = not any(within(g, r, *tol)[0] for g, r in
                               ((c_dq, r_dq), (c_dk, r_dk), (c_dv, r_dv)))
            mx = {n: g.float().abs().max().item() for n, g in
                  (("dq", r_dq), ("dk", r_dk), ("dv", r_dv))}
            line = (f"[kernels_bwd] flash_attn_bwd {str(dt)[6:]} B={B} S={S} H={H} D={D}: "
                    + " ".join(f"max|{n}-plain|={e:.3e} (max|{n}|={mx[n]:.3e})"
                               for n, (_, e, _) in res.items())
                    + f" max|delta-plain|={d_err:.3e} (tol {tol[1]:g}*max + {tol[0]:g}*|g|;"
                    f" largest error / allowed {use:.3f}) one-tile-skip caught={cut_seen}"
                    f" dq/delta/dk/dv bit-identical on a rerun={same_bits}")
            if dt == torch.bfloat16:
                isz = q.element_size()
                ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, scale))
                ms_kv = time_ms(lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta, scale))
                dev = [x for n_, x in _kernel_device_ms(
                    lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta, scale)).items()
                    if kernel_table.owner(n_) == "flash_attn_bwd_dkdv"]
                dev_kv = sum(m for m, _ in dev) / max(1, sum(c for _, c in dev))
                plain_dq = time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, o, lse, do, scale), 1, 5)
                plain_kv = time_ms(lambda: fa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                                    scale), 1, 5)
                qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
                doh = do.transpose(1, 2).contiguous()

                def sdpa():
                    return F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

                def sdpa_fwd_bwd():
                    torch.autograd.grad(sdpa(), (qh, kh, vh), doh)

                lib_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa)
                backend = top_kernel(sdpa_fwd_bwd)
                n, bhs = B * S * H * D, B * H * S
                b_dq = bound(6 * B * H * S * S * D, 6 * n * isz + 8 * bhs, PEAK_BF16_FLOPS)
                b_kv = bound(8 * B * H * S * S * D, 6 * n * isz + 8 * bhs, PEAK_BF16_FLOPS)
                b_all = bound(10 * B * H * S * S * D, 8 * n * isz + 4 * bhs, PEAK_BF16_FLOPS)
                fl = B * H * S * S * D
                line += (f" | dq ms={ms_dq:.4f} plain_ms={plain_dq:.4f} bound_ms={b_dq[0]:.4f}"
                         f" ({b_dq[1]}; {6 * fl / ms_dq / 1e9:.1f} TFLOP/s) | dkdv ms={ms_kv:.4f}"
                         f" (device {dev_kv:.4f}) plain_ms={plain_kv:.4f} bound_ms={b_kv[0]:.4f}"
                         f" ({b_kv[1]}; "
                         f"{8 * fl / ms_kv / 1e9:.1f} TFLOP/s) | pair ms={ms_dq + ms_kv:.4f} "
                         f"bound_ms={b_all[0]:.4f} ({b_all[1]}, 5 S^2 D matmuls) | SDPA "
                         f"backward (fwd+bwd - fwd) ms={lib_ms:.4f} (pair "
                         f"{(ms_dq + ms_kv) / lib_ms:.2f}x its time), top kernel {backend!r}")
                if (B, S, H, D) in FLAGSHIP_FLASH + BWD_SHAPES:
                    for name, ms, pl, b_, e, f_ in (
                            ("flash_attn_bwd_dq", ms_dq, plain_dq, b_dq, res["dq"][1], 6 * fl),
                            ("flash_attn_bwd_dkdv", ms_kv, plain_kv, b_kv,
                             max(res["dk"][1], res["dv"][1]), 8 * fl)):
                        add_record(rec, name, dict(
                            shape=[B, S, H, D], dtype="bf16", max_abs_err=e, ms=ms, plain_ms=pl,
                            bound_ms=b_[0], bound_by=b_[1], library_ms=lib_ms,
                            tflops=f_ / ms / 1e9))
            log(line + (" OK" if ok and cut_seen else " FAIL"))
            if not ok:
                raise AssertionError(f"flash backward disagrees with its plain version at "
                                     f"{(B, S, H, D)} {dt}: {res}, delta {d_err}")
            if not cut_seen:
                raise AssertionError(f"flash backward tolerance at {(B, S, H, D)} {dt} cannot "
                                     "see a skipped tile")
            if not same_bits:
                raise AssertionError(f"flash backward at {(B, S, H, D)} {dt} differs between runs")

    # ---- GroupNorm(+SiLU) backward: stats pass, apply pass
    B = 2
    for (M, C, G) in GN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((B, M, C), generator=gen, device="cuda") * 1.3 + 0.7).to(dt)
            g = torch.randn((B, M, C), generator=gen, device="cuda").to(dt)
            w = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
            b = 0.1 * torch.randn(C, generator=gen, device="cuda")
            st, A, bb = gn.stats_fold_plain(x, w, b, G, 1e-6)
            for silu in (False, True):
                vec0 = _vector_launches()
                coef, ds, db = gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, silu)
                dx = gn.gn_bwd_apply(x, g, A, bb, coef, silu)
                vec = _vector_launches()
                vec_path = (vec["gn_bwd_stats"], vec["gn_bwd_apply"]) == (
                    vec0["gn_bwd_stats"] + 1, vec0["gn_bwd_apply"] + 1)
                r_coef, r_ds, r_db = gn.gn_bwd_stats_plain(x, g, A, bb, st, w, G, 1e-6, silu)
                r_dx = gn.gn_bwd_apply_plain(x, g, A, bb, r_coef, silu)
                # no float atomics, fixed summation order: coef, dscale, dbias, dx the
                # same bits twice
                again = gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, silu)
                same_bits = all(torch.equal(a_, b_) for a_, b_ in zip(
                    (coef, ds, db, dx), (*again, gn.gn_bwd_apply(x, g, A, bb, again[0], silu))))
                torch.cuda.synchronize()
                x_ok, x_err, x_use = within(dx, r_dx, *GN_BWD_TOL[dt])
                p_rel = max(_err(t_, r_) / r_.abs().max().item()
                            for t_, r_ in ((coef, r_coef), (ds, r_ds), (db, r_db)))
                ok = x_ok and p_rel <= GN_PARAM_GRAD_TOL and vec_path and same_bits
                line = (f"[kernels_bwd] gn_bwd {str(dt)[6:]} silu={silu} B={B} M={M} C={C} G={G}: "
                        f"max|dx-plain|={x_err:.3e} (max|dx|={r_dx.float().abs().max().item():.3e},"
                        f" tol {GN_BWD_TOL[dt][1]:g}*max + {GN_BWD_TOL[dt][0]:g}*|dx|; largest "
                        f"error / allowed {x_use:.3f}) "
                        f"coef/dscale/dbias rel_err={p_rel:.3e} (tol {GN_PARAM_GRAD_TOL:g}) "
                        f"16-byte loads={vec_path} coef/dscale/dbias/dx bit-identical on a "
                        f"rerun={same_bits}")
                if silu:
                    isz = x.element_size()
                    s_ms = time_ms(lambda: gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, True))
                    s_plain = time_ms(lambda: gn.gn_bwd_stats_plain(x, g, A, bb, st, w, G, 1e-6,
                                                                    True), 1, 5)
                    a_ms = time_ms(lambda: gn.gn_bwd_apply(x, g, A, bb, coef, True))
                    a_plain = time_ms(lambda: gn.gn_bwd_apply_plain(x, g, A, bb, coef, True),
                                      1, 5)
                    xg = x.detach().requires_grad_()
                    wl, bl = w.to(dt).requires_grad_(), b.to(dt).requires_grad_()
                    y = F.silu(F.group_norm(xg.permute(0, 2, 1), G, wl, bl, 1e-6))
                    gl = g.permute(0, 2, 1)
                    lib_ms = time_ms(lambda: torch.autograd.grad(y, (xg, wl, bl), gl,
                                                                 retain_graph=True))
                    s_lib = native_gn_bwd_params_ms(x, g, wl.detach(), bl.detach(), G)
                    s_bound = (2 * B * M * C * isz + 9 * B * C * 4) / PEAK_BYTES * 1e3
                    a_bound = (3 * B * M * C * isz + 4 * B * C * 4) / PEAK_BYTES * 1e3
                    line += (f" | stats ms={s_ms:.4f} plain_ms={s_plain:.4f} bound_ms="
                             f"{s_bound:.4f} (bytes) native_group_norm_backward dscale+dbias "
                             f"(no SiLU) ms={s_lib:.4f} | apply ms={a_ms:.4f} plain_ms="
                             f"{a_plain:.4f} bound_ms={a_bound:.4f} (bytes) | F.group_norm+F.silu "
                             f"backward ms={lib_ms:.4f}")
                    if (M, C) == (32768, 256) and dt == torch.bfloat16:
                        rec["gn_bwd_stats"] = dict(
                            shape=[B, M, C], dtype="bf16", max_abs_err=_err(coef, r_coef),
                            ms=s_ms, plain_ms=s_plain, bound_ms=s_bound, bound_by="bytes",
                            library_ms=s_lib)
                        rec["gn_bwd_apply"] = dict(
                            shape=[B, M, C], dtype="bf16", max_abs_err=x_err, ms=a_ms,
                            plain_ms=a_plain, bound_ms=a_bound, bound_by="bytes",
                            library_ms=lib_ms)
                log(line + (" OK" if ok else " FAIL"))
                if not ok:
                    raise AssertionError(f"GroupNorm backward disagrees at {(B, M, C)} {dt} "
                                         f"silu={silu}: dx {x_err}, params {p_rel}, 16-byte "
                                         f"loads {vec_path}, same bits on a rerun {same_bits}")
    return rec


def native_gn_bwd_params_ms(x, g, w, bias, G):
    """Median ms of ``aten.native_group_norm_backward`` for dscale and dbias
    only (no SiLU) on channels-first copies of the (B, M, C) x and g: the one
    PyTorch call that does the backward stats' reduction over x and dy."""
    B, M, C = x.shape
    xc, gc = x.permute(0, 2, 1).contiguous(), g.permute(0, 2, 1).contiguous()
    _, mean, rstd = torch.ops.aten.native_group_norm(xc, w, bias, B, C, M, G, 1e-6)
    return time_ms(lambda: torch.ops.aten.native_group_norm_backward(
        gc, xc, mean, rstd, w, B, C, M, G, [False, True, True]))


def _build_models(dtype, device, tiny, seed):
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.planning.planner import (
        compute_output_size,
        flagship_configs,
    )

    vae_p, ddpm_p, image = flagship_configs(tiny=tiny)
    unet = DiffusionUNet.from_config(ddpm_p, dtype=dtype, device=device).eval()
    vae = AutoencoderKL.from_config(vae_p, dtype=dtype, device=device).eval()
    randomize_(unet, seed)
    randomize_(vae, seed + 1)
    latent = compute_output_size(image, vae_p["downsample_parameters"])
    return unet, vae, latent, ddpm_p, image


def _train_config(tiny, spatial_dims=3):
    from medical_image_generation_tpu_torch.planning.planner import (
        create_config_dict,
        flagship_configs,
        flagship_dataset,
    )

    vae_p, ddpm_p, _ = flagship_configs(tiny=tiny, spatial_dims=spatial_dims)
    return create_config_dict(flagship_dataset(tiny, spatial_dims), [0], 1, vae_p, ddpm_p)


def launches(**kw):
    """A launch count for every kernel of the table: ``kw``'s, else 0."""
    return {k: kw.get(k, 0) for k in kernel_table.KERNELS}


def _vector_launches():
    """{kernel: launches that took 16-byte loads} of the kernels counting them."""
    return {k: kernel_table.read(f"{k}.vector_launches") for k in kernel_table.KERNELS
            if f"{k}.vector_launches" in kernel_table.SIDE_COUNTS}


def _scalar_launches():
    """{kernel: launches since the last reset that did not take the 16-byte
    loads} of the GroupNorm kernels that have both paths."""
    return {k: kernel_table.read(k) - n for k, n in _vector_launches().items()}


def opt_launches(*opts):
    """{kernel: launches} of one step of each optimizer (``common.AdamW``, or
    anything with its ``params`` and ``clip``) on the card: a launch of each
    kernel a table of ``ops.adamw.partition``, ``sq_norm`` only under a
    clip."""
    from medical_image_generation_tpu_torch.ops import adamw

    out = {"sq_norm": 0, "adamw_update": 0}
    for opt in opts:
        n = len(adamw.partition([p.numel() for p in opt.params]))
        out["sq_norm"] += n if opt.clip else 0
        out["adamw_update"] += n
    return out


def opt_bounds(*opts):
    """{kernel: least ms of one step of each optimizer}: ``sq_norm`` reads
    every gradient once (4 B a parameter), ``adamw_update`` reads g, p, mu
    and nu and writes p, mu and nu (16 B a parameter and twice mu's item
    size: 24 with a bf16 mu)."""
    out = {"sq_norm": 0.0, "adamw_update": 0.0}
    for opt in opts:
        n = sum(p.numel() for p in opt.params)
        out["sq_norm"] += (4 * n if opt.clip else 0) / PEAK_BYTES * 1e3
        out["adamw_update"] += (20 + 2 * opt.mu[0].element_size()) * n / PEAK_BYTES * 1e3
    return out


def peak_gib(fn):
    """fn()'s peak allocated device memory, GiB (what it holds included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _kernel_device_ms(fn, calls=3):
    """{profile kernel name: (summed device ms, events)} of ``calls``
    profiled calls of fn after one; the profile first records WARM_LAUNCHES
    spin kernels, left out, as ``profile_breakdown``'s does. The profiler
    can drop events, so a caller divides by the events it kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


def opt_check(label, opt, grads):
    """The optimizer's kernels at a trainer's parameter list against the
    plain version. Copies of ``opt``'s params, mu, nu and count take one
    clipped step (the clip at half the gradients' norm) and one unclipped
    (at twice it) through ``common.AdamW`` (the kernels), launches counted
    from just before each; other copies take the plain
    ``clip_by_global_norm`` + ``adamw_plain_`` on the same ``grads``, the
    clip decided by the kernels' norm. Held: params, mu and nu within
    OPT_RTOL of the plain ones, the norm within OPT_NORM_RTOL of the plain
    ``global_norm`` (summation order), one launch of each kernel a table,
    no gradient copied, the norm a 0-d device tensor. Then at ``opt``'s clip:
    each kernel's device ms (profiler) beside its bytes bound, the whole
    step and the plain version in ms (CUDA events), and the device memory
    each allocates beyond what it holds. Returns the record."""
    from medical_image_generation_tpu_torch.ops import adamw as ta
    from medical_image_generation_tpu_torch.training import common

    def twin():
        o = common.AdamW([p.detach().clone() for p in opt.params], lambda s: lr, opt.clip,
                         opt.wd, opt.b1, opt.b2, opt.eps, mu_dtype=opt.mu[0].dtype)
        torch._foreach_copy_(o.mu, opt.mu)
        torch._foreach_copy_(o.nu, opt.nu)
        o.count = opt.count
        return o

    lr = opt.lr_schedule(opt.count)
    k, r = twin(), twin()
    n = sum(p.numel() for p in opt.params)
    zg = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, opt.params)]
    norm0 = float(ta.global_norm(zg))
    rec = {"params": n, "tensors": len(opt.params), "mu_dtype": str(opt.mu[0].dtype),
           "wd": opt.wd, "norm": norm0}
    for case, clip in (("clipped", 0.5 * norm0), ("unclipped", 2.0 * norm0)):
        k.clip = clip
        torch.cuda.synchronize()
        before = kernel_table.launches()
        copies = kernel_table.read("adamw_update.grad_copies")
        k.step(grads)
        torch.cuda.synchronize()
        got = {name: n - before[name] for name, n in kernel_table.launches().items()}
        gs = [g.clone() for g in zg]
        plain_norm = ta.global_norm(gs)
        ta.clip_by_global_norm(gs, clip, norm=k.last_norm)
        ta.adamw_plain_(r.params, gs, r.mu, r.nu, r._hyper())
        del gs
        off = sum(int(((a.float() - b.float()).abs() > OPT_RTOL * b.float().abs()).sum())
                  for a, b in zip(k.params + k.mu + k.nu, r.params + r.mu + r.nu))
        norm_rel = abs(float(k.last_norm) / float(plain_norm) - 1)
        rec[case] = dict(launches={n_: v for n_, v in got.items() if v}, elements_off=off,
                         norm_rel=norm_rel,
                         grad_copies=kernel_table.read("adamw_update.grad_copies") - copies)
        log(f"[{label}] optimizer {case} (clip {clip:.4g}, norm {norm0:.4g}): kernels vs plain "
            f"driven by the kernels' norm: {off} of {3 * n:,} params / mu / nu elements off "
            f"by more than rtol {OPT_RTOL:g}; norm rel_err vs the plain norm {norm_rel:.2e} "
            f"(tol {OPT_NORM_RTOL:g}); launches {rec[case]['launches']}; gradients copied "
            f"{rec[case]['grad_copies']}")
        if (off or norm_rel > OPT_NORM_RTOL or got != launches(**opt_launches(k))
                or rec[case]["grad_copies"] or k.last_norm.dim() or not k.last_norm.is_cuda):
            raise AssertionError(f"[{label}] optimizer kernels vs plain, {case}: {rec[case]}, "
                                 f"launches predicted {opt_launches(k)}")
    k.clip = r.clip = opt.clip
    dev = _kernel_device_ms(lambda: k.step(grads))
    bounds, per = opt_bounds(k), opt_launches(k)
    for name in ("sq_norm", "adamw_update"):  # ms a step: the mean of the events kept
        hits = [v for e, v in dev.items() if kernel_table.owner(e) == name]
        ms, n_ev = sum(h[0] for h in hits), sum(h[1] for h in hits)
        rec[name] = dict(ms=ms / max(n_ev, 1) * per[name], bound_ms=bounds[name], events=n_ev)
    rec["other_device_ms"] = sum(ms / n for e, (ms, n) in dev.items() if "adamw_" not in e)

    def plain():
        gs = [g.clone() for g in zg]
        ta.clip_by_global_norm(gs, opt.clip)
        ta.adamw_plain_(r.params, gs, r.mu, r.nu, r._hyper())

    rec["step_ms"] = time_ms(lambda: k.step(grads), 1, 5)
    rec["plain_ms"] = time_ms(plain, 1, 5)
    held = torch.cuda.memory_allocated()
    rec["step_extra_bytes"] = peak_gib(lambda: k.step(grads)) * 2**30 - held
    rec["plain_extra_bytes"] = peak_gib(plain) * 2**30 - held
    both = rec["sq_norm"]["ms"] + rec["adamw_update"]["ms"]
    bound_ms = bounds["sq_norm"] + bounds["adamw_update"]
    log(f"[{label}] kernels: optimizer at {len(opt.params)} tensors, {n:,} params (mu "
        f"{opt.mu[0].dtype}, wd {opt.wd:g}, clip {opt.clip:g}): sq_norm ms="
        f"{rec['sq_norm']['ms']:.4f} bound_ms={bounds['sq_norm']:.4f} | adamw_update ms="
        f"{rec['adamw_update']['ms']:.4f} bound_ms={bounds['adamw_update']:.4f} | both "
        f"{both:.4f} ms = {both / bound_ms:.2f}x the bound, other device ms "
        f"{rec['other_device_ms']:.4f} (profiler) | AdamW.step ms={rec['step_ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} (the _foreach chain, gradients cloned; CUDA events) | "
        f"allocated beyond what is held: kernels {rec['step_extra_bytes'] / 2**10:.1f} KiB, "
        f"plain {rec['plain_extra_bytes'] / 2**30:.3f} GiB")
    del k, r, zg
    torch.cuda.empty_cache()
    return rec


def phase_parity():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    unet, vae, latent, ddpm_p, _ = _build_models(torch.float32, "cpu", True, 7)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, *latent, ddpm_p["in_channels"]), generator=g)
    t = torch.tensor([17, 901])
    with torch.no_grad():
        eps_cpu, img_cpu = unet(x, t), vae.decode(x)
        unet_g, vae_g = copy.deepcopy(unet).cuda(), copy.deepcopy(vae).cuda()
        kernel_table.reset()
        eps_gpu, img_gpu = unet_g(x.cuda(), t.cuda()), vae_g.decode(x.cuda())
        torch.cuda.synchronize()
    counts = kernel_table.launches()
    fwd = ("flash_attn_fwd", "gn_stats_fold", "gn_affine_act")
    tol = 1e-4  # fp32 everywhere (TF32 off); summation order only
    e1 = _err(eps_gpu.cpu(), eps_cpu) / max(1.0, eps_cpu.abs().max().item())
    e2 = _err(img_gpu.cpu(), img_cpu) / max(1.0, img_cpu.abs().max().item())
    log(f"[parity] tiny 3D config fp32, CPU plain vs GPU kernels: unet err={e1:.3e} "
        f"decode err={e2:.3e} (max abs / max(1, max|ref|), tol {tol:g}); "
        f"GPU launches {counts}")
    if not (e1 <= tol and e2 <= tol and all(counts[k] > 0 for k in fwd)):
        raise AssertionError("tiny-config CPU/GPU parity failed")
    if any(counts[k] for k in counts if k not in fwd):
        raise AssertionError(f"backward kernels launched under no_grad: {counts}")


def phase_parity_train():
    """One whole train_step of the tiny config on the CPU (plain versions)
    and on the GPU (kernels), from the same weights and the same draws."""
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_config(tiny=True)
    unet, vae, _, _, _ = _build_models(torch.float32, "cpu", True, 11)
    unet.train()
    unet_g, vae_g = copy.deepcopy(unet).cuda(), copy.deepcopy(vae).cuda()
    cpu = LDMTrainer(cfg, unet, vae, device="cpu")
    gpu = LDMTrainer(cfg, unet_g, vae_g, device="cuda")
    cpu.scale_factor = gpu.scale_factor = 0.7
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    x = torch.rand((2, *initial, 1), generator=torch.Generator().manual_seed(5))
    draws = cpu.make_draws(x, generator=torch.Generator().manual_seed(6))
    old = [p.detach().clone() for p in cpu.params]
    grads = {}
    for name, tr in (("cpu", cpu), ("gpu", gpu)):
        _capture_grads(tr.opt, grads, name)
    loss_c = cpu.train_step(x, draws=draws)
    kernel_table.reset()
    loss_g = gpu.train_step(x.cuda(), draws=draws)
    torch.cuda.synchronize()
    counts = kernel_table.launches()
    l_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    names = [n for n, p in cpu.unet.named_parameters() if p.requires_grad]
    g_err = max(_err(gg.cpu(), gc) / max(gc.abs().max().item(), 1e-30)
                for gc, gg in zip(grads["cpu"], grads["gpu"]))
    # Adam's first update is -lr * (g / (|g| + eps) + wd * p): u = g / (|g| + eps)
    # is about sign(g). Where |u_cpu| > 0.99 the GPU's u agrees to 1e-3; where
    # |g| is near eps the sign hangs on rounding, so those (at most 1%) are
    # only held to |u| <= 1.
    n_off, n_all, u_err = 0, 0, 0.0
    for name, p0, pc, pg in zip(names, old, cpu.params, gpu.params):
        u_c = (p0 - pc.detach()) / LR - 1e-2 * p0
        u_g = (p0 - pg.detach().cpu()) / LR - 1e-2 * p0
        firm = u_c.abs() > 0.99
        if firm.any():
            u_err = max(u_err, _err(u_g[firm], u_c[firm]))
        if not bool((u_g.abs() <= 1.0 + 2.0 ** -22 * p0.abs() / LR + 1e-6).all()):
            raise AssertionError(f"train parity: |update| of {name} beyond lr")
        n_off += int((~firm).sum())
        n_all += firm.numel()
    log(f"[parity] tiny 3D train step fp32, CPU plain vs GPU kernels: loss rel_err={l_err:.3e} "
        f"(tol {PARITY_LOSS_TOL:g}); max gradient err / max|grad| over {len(names)} params="
        f"{g_err:.3e} (tol {PARITY_GRAD_TOL:g}); Adam update max|u_gpu-u_cpu|={u_err:.3e} "
        f"(tol 1e-3) on |u|>0.99, {n_off}/{n_all} elements below; GPU launches {counts}")
    if not (l_err <= PARITY_LOSS_TOL and g_err <= PARITY_GRAD_TOL and u_err <= 1e-3
            and n_off <= 0.01 * n_all):
        raise AssertionError("tiny-config train-step CPU/GPU parity failed")
    # fp32: every kernel but the narrow flash ones (bf16 only), which stay at 0
    wide = {k: v for k, v in counts.items() if not k.endswith("_narrow")}
    if not all(wide.values()) or any(counts[k] for k in counts if k not in wide):
        raise AssertionError(f"a kernel did not launch in the GPU train step, or a narrow one "
                             f"did: {counts}")


def phase_slice(steps=10):
    from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.training.sample import LDMSampler

    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    unet, vae, latent, ddpm_p, image = _build_models(torch.bfloat16, dev, False, 1234)
    n_params = sum(p.numel() for p in unet.parameters())
    n_vae = sum(p.numel() for p in vae.decoder.parameters())
    log(f"[slice] flagship U-Net {ddpm_p['num_channels']} params={n_params:,}; VAE decoder "
        f"params={n_vae:,}; latent {latent}x{ddpm_p['in_channels']} -> image {image}; bf16 batch 2")
    B = 2
    sampler = LDMSampler(unet, vae, NoiseSchedule.create(device=dev), scale_factor=1.0,
                         latent_shape=(B, *latent, ddpm_p["in_channels"]), device=dev)

    def count(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    flash_per_fwd = count(unet, AttentionBlock)
    gn_per_fwd = count(unet, GroupNorm)
    gn_per_decode = count(vae.decoder, GroupNorm)
    gen = torch.Generator(device=dev).manual_seed(0)
    sampler.sample(B, sampler="ddim", num_inference_steps=2, generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernel_table.reset()
    t0 = time.perf_counter()
    images = sampler.sample(B, sampler="ddim", num_inference_steps=steps, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernel_table.launches()
    copies = kernel_table.total("input_copies")
    scalar = _scalar_launches()

    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expect = {k: 0 for k in counts}
    expect.update({"flash_attn_fwd": flash_per_fwd * steps,
                   "gn_stats_fold": gn_per_fwd * steps + gn_per_decode,
                   "gn_affine_act": gn_per_fwd * steps + gn_per_decode})
    log(f"[slice] launches per U-Net forward: flash {flash_per_fwd}, GroupNorm {gn_per_fwd}; "
        f"per decode: GroupNorm {gn_per_decode}; {steps} DDIM steps + decode: counted "
        f"{counts}, expected {expect}; flash inputs copied for TMA: {copies}; stats+fold "
        f"GroupNorm launches without 16-byte loads: {scalar}")
    finite = bool(torch.isfinite(torch.from_numpy(images)).all())
    shape_ok = images.shape == (B, *image, 1)
    spread = float(images.std())
    log(f"[slice] images shape={images.shape} finite={finite} min={images.min():.4f} "
        f"max={images.max():.4f} std={spread:.4f}")
    if counts != expect or flash_per_fwd != 11 or copies or any(scalar.values()):
        raise AssertionError(f"launch counts {counts} != expected {expect}, or {copies} "
                             f"flash inputs copied, or scalar GroupNorm launches {scalar}")
    if not (finite and shape_ok and spread > 0):
        raise AssertionError("sampled volumes are not finite / of the expected shape")

    x = torch.randn((B, *latent, ddpm_p["in_channels"]), generator=gen, device=dev)
    t = torch.full((B,), 500, device=dev, dtype=torch.long)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: unet(x, t), 2, 5)
        dec_ms = time_ms(lambda: sampler.decode(x), 1, 3)
    vols_min = B / secs * 60
    log(f"[slice] ms per U-Net forward={fwd_ms:.3f}; ms per decode={dec_ms:.3f}; "
        f"{steps}-step DDIM + decode of {B} volumes: {secs * 1e3:.1f} ms "
        f"= {vols_min:.2f} volumes/min; peak memory {peak_gb:.2f} GiB")
    with torch.no_grad():
        busy, _ = profile_breakdown("U-Net forward", lambda: unet(x, t))
        profile_breakdown("decode", lambda: sampler.decode(x))
    log(f"[slice] device busy per U-Net forward={busy:.3f} ms (profiler)")


def phase_train(warmup=2, steps=10):
    """The flagship train step; returns the launch counts of the timed steps,
    {kernel: its device ms and bound a step}, ms a step and the optimizer's
    ``opt_check`` record."""
    from medical_image_generation_tpu_torch.data.augment import augment_batch
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.ops import _build
    from medical_image_generation_tpu_torch.training.sample import (
        LDMSampler,
        load_torch_checkpoint,
    )
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    cfg = _train_config(tiny=False)
    vae_f32 = AutoencoderKL.from_config(cfg["vae_params"], dtype=torch.float32, device=dev)
    randomize_(vae_f32, 4321)
    trainer = LDMTrainer.from_config(cfg, vae_f32.state_dict(), device=dev,
                                     dtype=torch.bfloat16, seed=0)
    del vae_f32
    randomize_(trainer.unet, 4322)  # every layer, the zero-initialised output conv too
    unet, vae = trainer.unet, trainer.vae
    n_params = sum(p.numel() for p in trainer.params)
    initial = tuple(compute_initial_patch_size(cfg["ddpm_transformations"]))
    B = 2
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = torch.rand((B, *initial, 1), generator=gen, device=dev)
    scale_factor, latent_shape = trainer.probe_latent(batch)
    log(f"[train] flagship U-Net {cfg['ddpm_params']['num_channels']} trainable params="
        f"{n_params:,} (fp32 masters, bf16 compute); batch {tuple(batch.shape)} -> crop "
        f"{trainer.aug_cfg.crop_to} -> latent {latent_shape}; scale_factor={scale_factor:.5f}; "
        f"lr {cfg['ddpm_learning_rate']}, clip {trainer.clip}, adam mu "
        f"{trainer.opt.mu[0].dtype}")
    if initial != (128, 143, 143) or n_params != 441_490_952:
        raise AssertionError(f"not the flagship config: patch {initial}, params {n_params}")

    def count(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    attn_u, gn_u = count(unet, AttentionBlock), count(unet, GroupNorm)
    attn_e, gn_e = count(vae.encoder, AttentionBlock), count(vae.encoder, GroupNorm)
    per_step = launches(flash_attn_fwd=attn_u + attn_e, flash_attn_bwd_dq=attn_u,
                        flash_attn_bwd_dkdv=attn_u, gn_stats_fold=gn_u + gn_e,
                        gn_affine_act=gn_u + gn_e, gn_bwd_stats=gn_u, gn_bwd_apply=gn_u,
                        **opt_launches(trainer.opt))

    p0 = [p.detach().clone() for p in trainer.params[:4]]
    losses = [trainer.train_step(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_table.reset()
    t0 = time.perf_counter()
    losses += [trainer.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernel_table.launches()
    copies = kernel_table.read("gn_bwd_apply.grad_copies")
    opt_copies = kernel_table.read("adamw_update.grad_copies")
    flash_copies = kernel_table.total("input_copies")
    scalar, vec = _scalar_launches(), _vector_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    expect = {k: v * steps for k, v in per_step.items()}
    changed = all(not torch.equal(a, p.detach()) for a, p in zip(p0, trainer.params[:4]))
    log(f"[train] losses {['%.5f' % v for v in losses]}")
    log(f"[train] launches per step predicted {per_step} (U-Net: {attn_u} attention, {gn_u} "
        f"GroupNorm; encoder: {attn_e} attention, {gn_e} GroupNorm); {steps} steps counted "
        f"{counts}, expected {expect}; GroupNorm gradients copied to channels-last: "
        f"{copies / steps:g} a step; flash inputs copied for TMA: {flash_copies}; "
        f"GroupNorm launches with 16-byte loads {vec}, without {scalar}; gradients the "
        f"optimizer copied into their param's layout: {opt_copies}")
    ms_step = secs * 1e3 / steps
    log(f"[train] {steps} steps in {secs * 1e3:.1f} ms: {ms_step:.3f} ms per step = "
        f"{1e3 / ms_step:.3f} steps/s; peak memory {peak_gb:.2f} GiB; params changed={changed}; "
        f"mu dtype {trainer.opt.mu[0].dtype}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if (counts != expect or attn_u != 11 or gn_u != 46 or gn_e != 13 or flash_copies
            or any(scalar.values()) or copies or opt_copies):
        raise AssertionError(f"launch counts {counts} != expected {expect}, or {flash_copies} "
                             f"flash inputs copied, or scalar GroupNorm launches {scalar}, "
                             f"or {copies} GroupNorm gradients copied, or {opt_copies} "
                             f"gradients the optimizer copied")
    if not changed or trainer.opt.mu[0].dtype != torch.bfloat16:
        raise AssertionError("params unchanged by the steps, or mu not stored in bf16")

    # U-Net forward + backward alone, and the optimizer alone, on fixed inputs
    z = torch.randn(latent_shape, generator=gen, device=dev)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev)

    def fwd_bwd():
        for p in trainer.params:
            p.grad = None
        torch.mean((unet(z, t).float() - z) ** 2).backward()

    fb_ms = time_ms(fwd_bwd, 1, 5)
    fb_peak = peak_gib(fwd_bwd)
    grads = [p.grad for p in trainer.params]
    opt_ms = time_ms(lambda: trainer.opt.step(grads), 1, 5)
    peaks = {"step": peak_gb, "U-Net forward+backward alone": fb_peak,
             "clip+AdamW alone": peak_gib(lambda: trainer.opt.step(grads))}
    log("[train] peak allocated GiB (what the trainer holds included): "
        + "; ".join(f"{k} {v:.3f}" for k, v in peaks.items()))
    opt_rec = opt_check("train", trainer.opt, grads)
    opt_rec["peaks_gib"] = peaks
    draws = trainer.make_draws(batch)
    aug_ms = time_ms(lambda: augment_batch(batch, draws.augment, trainer.aug_cfg), 1, 5)
    imgs = augment_batch(batch, draws.augment, trainer.aug_cfg)
    with torch.no_grad():
        enc_ms = time_ms(lambda: vae.encode_stage_2_inputs(imgs, draws.eps), 1, 5)
    log(f"[train] ms of U-Net forward+backward alone={fb_ms:.3f}; ms of clip+AdamW "
        f"alone={opt_ms:.3f}; ms of augment alone={aug_ms:.3f}; ms of the frozen encode "
        f"alone={enc_ms:.3f}")
    bounds = step_bounds(trainer, batch)
    busy, shares = profile_breakdown("train step", lambda: trainer.train_step(batch))
    log(f"[train] device busy per train step={busy:.3f} ms (profiler)")
    unseen = [name for name, n in per_step.items() if n and not shares[name] > 0]
    if unseen:
        raise AssertionError(f"port kernels launched in the step but read 0 ms in its profile "
                             f"(device names of ops/kernels.py out of date?): {unseen}")
    for name, b_ms in bounds.items():
        if not b_ms:  # a kernel the step does not run (the narrow flash kernels here)
            continue
        log(f"[train] per step: {name} device ms={shares[name]:.4f} bound ms (summed over the "
            f"step's {per_step[name]} launches)={b_ms:.4f} ratio={shares[name] / b_ms:.2f}")

    # the trained model goes straight into the sampler
    ckpt_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "ldm.pt")
    trainer.save_checkpoint(path)
    del trainer, unet, vae, grads, imgs
    torch.cuda.empty_cache()
    payload = load_torch_checkpoint(path)
    os.remove(path)
    sampler = LDMSampler.from_config(cfg, payload["unet"], payload["vae"],
                                     payload["scale_factor"], payload["latent_shape"],
                                     dtype=torch.bfloat16, device=dev)
    images = sampler.sample(1, sampler="ddim", num_inference_steps=2,
                            generator=torch.Generator(device=dev).manual_seed(8))
    ok = images.shape == (1, 128, 128, 128, 1) and bool(torch.isfinite(
        torch.from_numpy(images)).all())
    log(f"[train] save_checkpoint -> LDMSampler.from_config -> 2 DDIM steps: images "
        f"{images.shape} finite={ok} std={float(images.std()):.4f}")
    if not ok:
        raise AssertionError("sampling from the saved checkpoint failed")
    return counts, {name: dict(step_ms=shares[name], step_bound_ms=b_ms)
                    for name, b_ms in bounds.items()}, ms_step, opt_rec


def step_bounds(trainer, batch):
    """{kernel: least ms the card could take for the kernel's launches in one
    LDM train step} (``module_bounds`` over the U-Net and the frozen
    encoder, ``opt_bounds`` of its optimizer)."""
    return {**module_bounds([trainer.unet, trainer.vae.encoder],
                            lambda: trainer.train_step(batch))[0], **opt_bounds(trainer.opt)}


WARM_LAUNCHES = 256  # tiny kernels a profile records before the call it reads

def profile_breakdown(label, fn, time_host=True):
    """One call under torch.profiler: device time by kernel, the port
    kernels' share, and the device's busy share of the call's wall time
    (single stream, so kernels do not overlap); plus the host's enqueue time.
    A trace started cold can miss its first kernels, so the profiler first
    records WARM_LAUNCHES `torch.cuda._sleep` kernels (`spin_kernel`, which
    no path of the port launches) and a sync; they are left out of what is
    read. Launch counts are checked on the kernel table's counters, which
    miss nothing; a launch runs each of its kernel's device names at most
    once (``device_launches`` of them in all), so the profile may show fewer
    (events it dropped, logged) but never more.
    ``time_host=False`` skips the unprofiled call that times the host's
    enqueue (for calls of tens of seconds). Returns (device busy ms, {port
    kernel: device ms})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    host_ms = float("nan")
    if time_host:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    kernel_table.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    counts = kernel_table.launches()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in dev if "spin_kernel" not in e.name]
    log(f"[profile] {label}: warm-up kernels recorded {len(dev) - len(kern)} of "
        f"{WARM_LAUNCHES}")
    if not kern:
        raise AssertionError(f"[profile] {label}: the profiler recorded no device kernels")
    by_name = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy = sum(v[0] for v in by_name.values()) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    owners = {n: kernel_table.owner(n) for n in by_name}
    shares = {k: sum(v[0] for n, v in by_name.items() if owners[n] == k) / 1e3
              for k in kernel_table.KERNELS}
    entries = kernel_table.KERNELS.values()
    by_device = {dn: (sum(v[1] for n, v in by_name.items() if dn in n),
                      sum(v[0] for n, v in by_name.items() if dn in n) / 1e3)
                 for k in entries for dn in k.device_names}
    log(f"[profile] {label}: {len(kern)} kernels, device busy {busy:.3f} ms over a "
        f"{span:.3f} ms span (idle share {1 - busy / span:.3f}); host enqueue "
        f"{host_ms:.3f} ms; port kernels ms {({k: round(v, 3) for k, v in shares.items()})}")
    log(f"[profile] {label}: port kernels by name, launches and summed ms "
        f"{({dn: (n, round(ms, 4)) for dn, (n, ms) in by_device.items() if n})}")
    dropped = {k.name: counts[k.name] * k.device_launches
               - sum(by_device[dn][0] for dn in k.device_names) for k in entries}
    log(f"[profile] {label}: wrapper launches {counts}; port kernels the profile dropped "
        f"{sum(dropped.values())} {({k: n for k, n in dropped.items() if n})}")
    extra = kernel_table.beyond_launches(counts, {dn: n for dn, (n, _) in by_device.items()})
    stale = [n for n in by_name if "::fold_kernel" in n or "stats_reduce_kernel" in n]
    if extra or stale:
        raise AssertionError(f"[profile] {label}: port kernels beyond their wrappers' "
                             f"launches {extra}, or the old GroupNorm fold / reduce {stale}: "
                             "a GroupNorm forward is not three launches")
    if not counts["gn_stats_fold"] or counts["gn_stats_fold"] != counts["gn_affine_act"]:
        raise AssertionError(f"[profile] {label}: stats + fold launched "
                             f"{counts['gn_stats_fold']} times, affine {counts['gn_affine_act']}: "
                             "not one of each a GroupNorm forward")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {us / 1e3:8.3f} ms  x{n:<4d} {name[:110]}")
    profile_breakdown.last = {"busy_ms": busy, "span_ms": span, "idle_share": 1 - busy / span,
                              "host_ms": host_ms}
    return busy, shares

def gn_bounds_ms(shape, isz, grad):
    """{kernel: least ms} of one GroupNorm call on an N C *spatial input of
    ``shape`` and item size ``isz`` (forward; backward too when ``grad``)."""
    B, C, M = shape[0], shape[1], math.prod(shape[2:])
    out = {"gn_stats_fold": stats_fold_bytes(B, M, C, isz) / PEAK_BYTES * 1e3,
           "gn_affine_act": (B * M * C * 2 * isz + 2 * B * C * 4) / PEAK_BYTES * 1e3}
    if grad:
        out["gn_bwd_stats"] = (2 * B * M * C * isz + 9 * B * C * 4) / PEAK_BYTES * 1e3
        out["gn_bwd_apply"] = (3 * B * M * C * isz + 4 * B * C * 4) / PEAK_BYTES * 1e3
    return out


def ae_per_step(trainer, adv_on):
    """Launches of each port kernel the code predicts for one AE train step:
    every GroupNorm of the encoder and the decoder once forward and once
    backward, and with the adversarial loss the discriminator's three times
    (on the reconstruction for the generator, then on the detached
    reconstruction and the batch for its own update), each differentiated;
    the generator's optimizer steps, and with the adversarial loss the
    discriminator's. No attention: the planner's VAE has none."""
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm

    def n(mod):
        return sum(isinstance(m, GroupNorm) for m in mod.modules())

    gn = n(trainer.model.encoder) + n(trainer.model.decoder)
    gn += 3 * n(trainer.discriminator) if adv_on else 0
    return launches(**{k: gn for k in kernel_table.KERNELS if k.startswith("gn_")},
                    **opt_launches(*ae_opts(trainer, adv_on)))


def ae_opts(trainer, adv_on):
    """The optimizers an AE train step steps: the generator's, and with the
    adversarial loss the discriminator's."""
    return [trainer.g_opt, trainer.d_opt] if adv_on else [trainer.g_opt]


def _capture_grads(opt, store, key):
    """Wrap opt.step to keep a copy of the gradients it is given (the CPU's
    plain version clips them in place)."""
    orig = opt.step

    def step(grads):
        store[key] = [g.detach().clone() for g in grads]
        return orig(grads)

    opt.step = step


def phase_ae_parity():
    """One AE train_step with the adversarial loss of the tiny config on the
    CPU (plain versions) and on the GPU (kernels), from the same weights and
    the same draws: the five losses, the gradients of the generator and of
    the discriminator, and the GPU's launches against the prediction."""
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.training.train_autoencoder import (
        METRICS,
        AutoEncoderTrainer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_config(tiny=True)
    cpu = AutoEncoderTrainer.from_config(cfg, "vae", device="cpu", dtype=torch.float32, seed=21)
    randomize_(cpu.model, 22)
    randomize_(cpu.discriminator, 23)
    gpu = AutoEncoderTrainer(cfg, copy.deepcopy(cpu.model).cuda(),
                             copy.deepcopy(cpu.discriminator).cuda(),
                             copy.deepcopy(cpu.perceptual).cuda(), "vae", device="cuda")
    initial = compute_initial_patch_size(cfg["ae_transformations"])
    x = torch.rand((2, *initial, 1), generator=torch.Generator().manual_seed(24))
    draws = cpu.make_draws(x, generator=torch.Generator().manual_seed(25),
                           host_generator=torch.Generator().manual_seed(26))
    grads = {}
    for name, tr in (("cpu", cpu), ("gpu", gpu)):
        _capture_grads(tr.g_opt, grads, name + "_g")
        _capture_grads(tr.d_opt, grads, name + "_d")
    m_c = cpu.train_step(x, True, draws=draws)
    kernel_table.reset()
    m_g = gpu.train_step(x.cuda(), True, draws=draws)
    torch.cuda.synchronize()
    counts = kernel_table.launches()
    expect = ae_per_step(gpu, True)
    l_err = max(abs(m_g[k].item() - m_c[k].item()) / abs(m_c[k].item()) for k in METRICS)
    g_err = {net: max(_err(g.cpu(), c) / max(c.abs().max().item(), 1e-30)
                      for c, g in zip(grads["cpu_" + net], grads["gpu_" + net]))
             for net in ("g", "d")}
    log(f"[ae_parity] tiny 3D AE step fp32 with the adversarial loss, CPU plain vs GPU "
        f"kernels: losses {({k: round(m_c[k].item(), 6) for k in METRICS})} max rel_err="
        f"{l_err:.3e} (tol {PARITY_LOSS_TOL:g}); max gradient err / max|grad| generator "
        f"{g_err['g']:.3e} over {len(grads['cpu_g'])} params, discriminator {g_err['d']:.3e} "
        f"over {len(grads['cpu_d'])} params (tol {PARITY_GRAD_TOL:g}); GPU launches {counts}, "
        f"predicted {expect}")
    if not (l_err <= PARITY_LOSS_TOL and max(g_err.values()) <= PARITY_GRAD_TOL):
        raise AssertionError("tiny-config AE train-step CPU/GPU parity failed")
    if counts != expect:
        raise AssertionError(f"AE step launches {counts} != predicted {expect}")


def phase_ae_train(warmup=2, steps=10):
    """The flagship stage-1 step (see the module docstring); returns
    ({kernel: launches of the timed adversarial steps}, {kernel: device ms
    and bound a step}, the prediction per step with and without the
    adversarial loss)."""
    from medical_image_generation_tpu_torch.data.augment import augment_batch
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.discriminator import least_squares_gan_loss
    from medical_image_generation_tpu_torch.training import common
    from medical_image_generation_tpu_torch.training.train_autoencoder import (
        METRICS,
        AutoEncoderTrainer,
    )

    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    gpu = card()
    cfg = _train_config(tiny=False)
    tr = AutoEncoderTrainer.from_config(cfg, "vae", device=dev, dtype=torch.bfloat16, seed=0)
    randomize_(tr.model, 5321)
    randomize_(tr.discriminator, 5322)
    n_g, n_d = sum(p.numel() for p in tr.g_params), sum(p.numel() for p in tr.d_params)
    initial = tuple(compute_initial_patch_size(cfg["ae_transformations"]))
    B = int(cfg["ae_batch_size"])
    gen = torch.Generator(device=dev).manual_seed(9)
    batch = torch.rand((B, *initial, 1), generator=gen, device=dev)
    pp = cfg["perceptual_params"]
    log(f"[ae_train] {gpu}: flagship KL-VAE {cfg['vae_params']['num_channels']} latent "
        f"{cfg['vae_params']['latent_channels']} groups {cfg['vae_params']['norm_num_groups']} "
        f"params={n_g:,} (fp32 masters, bf16 compute); PatchDiscriminator "
        f"{cfg['discriminator_params']['num_channels']}ch x{cfg['discriminator_params']['num_layers_d']}"
        f" params={n_d:,}; perceptual VGG16 plan {tr.perceptual.plan} fake-3D ratio "
        f"{pp['fake_3d_ratio']}; batch {tuple(batch.shape)} -> crop {tr.aug_cfg.crop_to}; "
        f"weights perc {tr.perc_weight} kl {tr.kl_weight} adv {tr.adv_weight}; lr "
        f"{cfg['ae_learning_rate']} / {cfg['d_learning_rate']}, clip {tr.clip}, adam mu "
        f"{tr.g_opt.mu[0].dtype}")
    if (initial != (128, 165, 165) or B != 2 or n_g != 5_281_985 or n_d != 2_642_753
            or tr.perc_weight != 0.125 or tr.kl_weight != 1e-7 or tr.adv_weight != 0.01):
        raise AssertionError(f"not the flagship stage-1 config: patch {initial}, batch {B}, "
                             f"params {n_g} / {n_d}")
    per_step, out = {}, {}
    for adv_on in (False, True):
        per_step[adv_on] = ae_per_step(tr, adv_on)
        for _ in range(warmup):
            tr.train_step(batch, adv_on)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_table.reset()
        t0 = time.perf_counter()
        ms = [tr.train_step(batch, adv_on) for _ in range(steps)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, scalar = kernel_table.launches(), _scalar_launches()
        copies = kernel_table.read("gn_bwd_apply.grad_copies")
        opt_copies = kernel_table.read("adamw_update.grad_copies")
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = {k: [float(m[k]) for m in ms] for k in METRICS}
        expect = {k: v * steps for k, v in per_step[adv_on].items()}
        ms_step = secs * 1e3 / steps
        log(f"[ae_train] {gpu}: adv_on={adv_on} losses (first, last) "
            f"{({k: (round(v[0], 5), round(v[-1], 5)) for k, v in losses.items()})}")
        log(f"[ae_train] {gpu}: adv_on={adv_on} launches per step predicted "
            f"{per_step[adv_on]}; {steps} steps counted {counts}, expected {expect}; GroupNorm "
            f"launches without 16-byte loads {scalar}; "
            f"GroupNorm gradients copied to channels-last {copies / steps:g} a step; gradients "
            f"the optimizers copied into their param's layout {opt_copies / steps:g} a step")
        log(f"[ae_train] {gpu}: adv_on={adv_on} {steps} steps in {secs * 1e3:.1f} ms: "
            f"{ms_step:.3f} ms per step = {1e3 / ms_step:.3f} steps/s; peak memory "
            f"{peak_gb:.2f} GiB")
        if not all(math.isfinite(v) for vs in losses.values() for v in vs):
            raise AssertionError(f"non-finite AE loss: {losses}")
        if counts != expect or any(scalar.values()):
            raise AssertionError(f"AE launches {counts} != expected {expect}, or scalar "
                                 f"GroupNorm launches {scalar}")
        bounds, shapes = gn_seen([tr.model, tr.discriminator],
                                 lambda: tr.train_step(batch, adv_on))
        bounds.update(opt_bounds(*ae_opts(tr, adv_on)))
        shapes = {s[1:] for s in shapes}  # (M, C, groups) at batch 2
        missing = shapes - set(GN_SHAPES)
        if missing:
            raise AssertionError(f"GroupNorm shapes of the AE step not held by the kernel "
                                 f"phases (add them to GN_SHAPES): {sorted(missing)}")
        busy, shares = profile_breakdown(f"AE train step adv_on={adv_on}",
                                         lambda: tr.train_step(batch, adv_on))
        prof = profile_breakdown.last
        log(f"[ae_train] {gpu}: adv_on={adv_on} device busy per step={busy:.3f} ms, idle share "
            f"{prof['idle_share']:.3f} of a {prof['span_ms']:.3f} ms span (profiler); "
            f"GroupNorm shapes (M, C, groups) {sorted(shapes)}")
        for name, b_ms in bounds.items():
            if per_step[adv_on][name]:
                log(f"[ae_train] {gpu}: adv_on={adv_on} per step: {name} device ms="
                    f"{shares[name]:.4f} bound ms (summed over the step's "
                    f"{per_step[adv_on][name]} launches)={b_ms:.4f} ratio="
                    f"{shares[name] / b_ms:.2f}")
        out[adv_on] = dict(ms_step=ms_step, busy_ms=busy, peak_gb=peak_gb, counts=counts,
                           **{f"{k}_step": (shares[k], bounds[k]) for k in bounds})

    # the parts alone, on fixed inputs, with the adversarial loss
    draws = tr.make_draws(batch)
    imgs = augment_batch(batch, draws.augment, tr.aug_cfg)
    D = tr.discriminator

    def vae_fwd_bwd():
        recon, mu, sigma = tr.model(imgs, draws.eps)
        loss = common.l1_loss(recon, imgs) + common.kl_loss(mu, sigma) * tr.kl_weight
        return torch.autograd.grad(loss, tr.g_params)

    with torch.no_grad():
        recon = tr.model(imgs, draws.eps)[0]
    r = recon.detach().requires_grad_()
    parts = {
        "VAE forward+backward (L1 + KL)": vae_fwd_bwd,
        "perceptual forward+backward": lambda: torch.autograd.grad(
            tr.perceptual(r, imgs) * tr.perc_weight, r),
        "discriminator on the reconstruction, forward+backward to it": lambda: torch.autograd.grad(
            least_squares_gan_loss(logits_fake=D(r)) * tr.adv_weight, r),
        "discriminator update's forward+backward (fake, real)": lambda: torch.autograd.grad(
            least_squares_gan_loss(logits_real=D(imgs), logits_fake=D(recon)) * tr.adv_weight,
            tr.d_params),
    }
    times = {k: time_ms(fn, 1, 5) for k, fn in parts.items()}
    g_grads = list(vae_fwd_bwd())
    d_grads = list(parts["discriminator update's forward+backward (fake, real)"]())
    times["generator clip+Adam"] = time_ms(lambda: tr.g_opt.step(g_grads), 1, 5)
    times["discriminator clip+Adam"] = time_ms(lambda: tr.d_opt.step(d_grads), 1, 5)
    times["augment"] = time_ms(lambda: augment_batch(batch, draws.augment, tr.aug_cfg), 1, 5)
    log(f"[ae_train] {gpu}: ms of the parts alone (CUDA events, median of 5): "
        + "; ".join(f"{k}={v:.3f}" for k, v in times.items()))
    out["parts_ms"] = times
    del tr, imgs, recon, r, g_grads, d_grads
    torch.cuda.empty_cache()
    return out, per_step


def _ae_state_diff(trainer, payload):
    """Names of the AE trainer states that differ, bit for bit, from a
    last/best payload."""
    bad = [k for k, v in trainer.model.state_dict().items()
           if not torch.equal(v.detach().cpu(), payload["vae"][k])]
    bad += [f"discriminator.{k}" for k, v in trainer.discriminator.state_dict().items()
            if not torch.equal(v.detach().cpu(), payload["discriminator"][k])]
    for key, opt, names in (("g_opt_state", trainer.g_opt, trainer.g_names),
                            ("d_opt_state", trainer.d_opt, trainer.d_names)):
        for part in ("mu", "nu"):
            bad += [f"{key}.{part}.{n}" for n, t in zip(names, getattr(opt, part))
                    if not torch.equal(t.cpu(), payload[key][part][n])]
        if opt.count != payload[key]["count"]:
            bad.append(f"{key}.count {opt.count} / {payload[key]['count']}")
    if trainer.step != payload["step"] or trainer.kl_weight != payload["kl_weight"]:
        bad.append("step / kl_weight")
    if not torch.equal(trainer.host_generator.get_state(), payload["generators"]["host"]):
        bad.append("host generator")
    if not torch.equal(trainer.generator.get_state(), payload["generators"]["device"]):
        bad.append("device generator")
    return bad


def phase_ae_cli(ws, per_step):
    """medimgen_torch_train_autoencoder end to end on the CLI workspace's
    dataset: epoch 1 without the adversarial loss, then -c to epoch 2 with
    it, epochs cut to AE_CLI_TRAIN_STEPS / AE_CLI_VAL_STEPS; returns the
    launch counts of both runs."""
    import functools
    from unittest import mock

    from medical_image_generation_tpu_torch.training import train_autoencoder

    loaders = functools.partial(train_autoencoder.get_data_loaders,
                                train_steps=AE_CLI_TRAIN_STEPS, val_steps=AE_CLI_VAL_STEPS)
    with mock.patch.object(train_autoencoder, "get_data_loaders", loaders):
        return _ae_cli_runs(ws, per_step)


def _ae_cli_runs(ws, per_step):
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm
    from medical_image_generation_tpu_torch.training import checkpoints, train_autoencoder

    t_phase = time.perf_counter()
    gpu = ws["gpu"]
    argv = ["099", "train-val-test", "3d", "--set", "autoencoder_warm_up_epochs=1",
            "--set", "val_plot_interval=1"]
    runs = {}

    def fwd(tr):  # a reconstruct: the encoder's and the decoder's GroupNorms, forward only
        n = sum(isinstance(m, GroupNorm) for m in tr.model.modules())
        return launches(gn_stats_fold=n, gn_affine_act=n)

    restored = {}
    orig_restore = train_autoencoder.AutoEncoderTrainer._restore

    def checked_restore(self):
        orig_restore(self)
        restored["diff"] = _ae_state_diff(self, restored["payload"])
        restored["start"] = self.start_epoch
        restored["loader"] = self.train_loader.state() == restored["payload"]["train_loader"]

    for run, extra in (("epoch 1", ["--set", "n_epochs=1"]),
                       ("-c to epoch 2", ["-c", "--set", "n_epochs=2"])):
        adv_on = run != "epoch 1"
        kernel_table.reset()
        train_autoencoder.AutoEncoderTrainer._restore = checked_restore
        try:
            t0 = time.perf_counter()
            tr = _run_main(train_autoencoder.run_cli, argv + extra)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            train_autoencoder.AutoEncoderTrainer._restore = orig_restore
        counts = kernel_table.launches()
        st = tr.epoch_stats[0]
        steps, val_steps = st["steps"], st["val_steps"]
        f = fwd(tr)
        expect = {k: steps * per_step[adv_on][k] + val_steps * f[k] for k in counts}
        ld = tr.loss_dict
        log(f"[ae_cli] {gpu}: {run}: adv_on={st['adv_on']}, {steps} train + {val_steps} val "
            f"steps, launches {counts}, predicted {expect}; CLI ms a train step "
            f"{st['train_s'] * 1e3 / steps:.3f}; loader wait {st['wait_s'] * 1e3 / steps:.3f} ms and "
            f"host-to-device copy {st['copy_s'] * 1e3 / steps:.3f} ms a step; val "
            f"{st['val_s'] * 1e3 / val_steps:.3f} ms a step; saved {st['saved']} (payload "
            f"{st['payload_s']:.3f} s), reconstruction {os.path.basename(st.get('recon', ''))}; "
            f"optimizer counts {tr.g_opt.count} / {tr.d_opt.count}; loss_dict {ld}; run "
            f"{run_s:.1f} s")
        finite = all(math.isfinite(v) for k in ld for v in ld[k])
        if (steps, val_steps) != (AE_CLI_TRAIN_STEPS, AE_CLI_VAL_STEPS) or counts != expect \
                or not finite \
                or st["adv_on"] != adv_on:
            raise AssertionError(f"AE CLI {run}: {steps} / {val_steps} steps, launches {counts} "
                                 f"!= predicted {expect}, or losses {ld}")
        if not adv_on:
            if sorted(st["saved"]) != ["best_model", "last_model"] or (
                    tr.g_opt.count, tr.d_opt.count) != (AE_CLI_TRAIN_STEPS, 0):
                raise AssertionError(f"AE epoch 1 wrote {st['saved']}, counts "
                                     f"{tr.g_opt.count} / {tr.d_opt.count}")
            last = checkpoints.checkpoint_path(tr.save_dict["checkpoints"], "last_model")
            restored["payload"] = checkpoints.load_checkpoint(last)
            diff = _ae_state_diff(tr, restored["payload"])
            log(f"[ae_cli] {gpu}: last_model.pt {os.path.getsize(last):,} bytes, equal to the "
                f"trainer: {not diff}")
            if diff:
                raise AssertionError(f"AE last_model.pt differs from the trainer: {diff[:5]}")
        else:
            log(f"[ae_cli] {gpu}: resume -c: start epoch {restored.get('start')} (0-based), "
                f"restored state equal to last_model.pt: {restored.get('diff') == []}, train "
                f"loader's draws restored: {restored.get('loader')}")
            if (restored.get("start") != 1 or restored.get("diff") != []
                    or not restored.get("loader")
                    or (tr.g_opt.count, tr.d_opt.count) != (2 * AE_CLI_TRAIN_STEPS,
                                                            AE_CLI_TRAIN_STEPS)
                    or len(ld["train_rec"]) != 2 or not ld["disc"][1] > 0):
                raise AssertionError(f"AE resume failed: {restored.get('diff')}, counts "
                                     f"{tr.g_opt.count} / {tr.d_opt.count}, loss_dict {ld}")
        runs[run] = counts
        del tr
        torch.cuda.empty_cache()
    log(f"[ae_cli] {gpu}: phase {time.perf_counter() - t_phase:.1f} s")
    return runs


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


CLI_PATIENTS, CLI_VOLUME = 8, (1, 144, 160, 160)  # (C, Z, Y, X) float32 in [0, 1]
CLI_FREE_BYTES = 20e9  # two ~4.4 GB 3D and two ~1.7 GB 2D checkpoints, the datasets, samples
# phase cli's depth, cut from the CLI's own 250 / 50 steps and 50 DDIM steps
CLI_TRAIN_STEPS, CLI_VAL_STEPS, CLI_DDIM_STEPS = 100, 20, 10
# phase ae_cli's depth, cut from the loader's 250 / 50 steps
AE_CLI_TRAIN_STEPS, AE_CLI_VAL_STEPS = 100, 20


def _write_cli_dataset(root, cfg, seed=2024, task="Task099_Synth", volume=CLI_VOLUME,
                       patients=CLI_PATIENTS, key="3D"):
    """A preprocessed dataset as the planner writes it: imagesTr/*.vs (the
    port's VolStore, default (1, 1, Y, X) chunks), a properties pickle with
    class_locations a patient, and medimgen_config.yaml with ``cfg`` under
    ``key``. Returns the bytes written."""
    import numpy as np
    import yaml

    from medical_image_generation_tpu_torch.io.volstore import write_volume
    from medical_image_generation_tpu_torch.planning.preprocess import save_properties

    images = os.path.join(root, task, "imagesTr")
    os.makedirs(images)
    rng = np.random.default_rng(seed)
    _, Z, Y, X = volume
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij",
                             sparse=True)
    nbytes = 0
    for i in range(patients):
        vol = rng.normal(0.35, 0.08, volume).astype(np.float32)
        c = rng.integers([Z // 4, Y // 4, X // 4], [3 * Z // 4, 3 * Y // 4, 3 * X // 4])
        r = int(rng.integers(12, 24))
        mask = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r * r
        vol[0][mask] += 0.4
        np.clip(vol, 0.0, 1.0, out=vol)
        pid = f"synth_{i:03d}"
        path = os.path.join(images, f"{pid}.vs")
        write_volume(path, vol)
        nbytes += os.path.getsize(path)
        locs = []
        for z in range(Z):
            yx = np.argwhere(mask[z])
            if len(yx) > 50:
                yx = yx[rng.choice(len(yx), 50, replace=False)]
            locs.extend((z, int(y), int(x)) for y, x in yx)
        save_properties(images, pid, {"class_locations": {1: locs},
                                      "min_max": [(0.0, 1.0)]})
    with open(os.path.join(root, task, "medimgen_config.yaml"), "w") as f:
        yaml.safe_dump({key: cfg}, f, sort_keys=False)
    return nbytes


def _counting_reads():
    """Patch VolStore.read_bbox to add the bytes each read decodes (every
    chunk the box touches, whole) to the returned dict."""
    from medical_image_generation_tpu_torch.io import volstore

    seen = {"bytes": 0, "reads": 0}
    orig = volstore.VolStore.read_bbox

    def read_bbox(self, lbs, ubs):
        n = 1
        for lo, hi, size, ch in zip(lbs, ubs, self.shape, self.chunk_shape):
            lo, hi = max(int(lo), 0), min(int(hi), size)
            n *= max(0, (hi - 1) // ch - lo // ch + 1) if hi > lo else 0
        seen["bytes"] += n * math.prod(self.chunk_shape) * self.dtype.itemsize
        seen["reads"] += 1
        return orig(self, lbs, ubs)

    volstore.VolStore.read_bbox = read_bbox
    return seen, lambda: setattr(volstore.VolStore, "read_bbox", orig)


def _run_main(fn, argv):
    """fn(argv) with sys.stdout / sys.stderr put back afterwards (a config
    with output_mode: log redirects them)."""
    out, err = sys.stdout, sys.stderr
    try:
        return fn(argv)
    finally:
        sys.stdout, sys.stderr = out, err


def _state_equal(trainer, payload):
    """Names of the trainer states that differ, bit for bit, from a
    last/best payload."""
    bad = [k for k, v in trainer.unet.state_dict().items()
           if not torch.equal(v.detach().cpu(), payload["unet"][k])]
    opt = payload["opt_state"]
    for key in ("mu", "nu"):
        bad += [f"{key}.{n}" for n, t in zip(trainer.param_names, getattr(trainer.opt, key))
                if not torch.equal(t.cpu(), opt[key][n])]
    if trainer.opt.count != opt["count"] or trainer.step != payload["step"]:
        bad.append(f"count {trainer.opt.count} / {opt['count']}, step {trainer.step} / "
                   f"{payload['step']}")
    if not torch.equal(trainer.host_generator.get_state(), payload["generators"]["host"]):
        bad.append("host generator")
    if not torch.equal(trainer.generator.get_state(), payload["generators"]["device"]):
        bad.append("device generator")
    if "scale_factor" in payload and trainer.scale_factor != payload["scale_factor"]:
        bad.append("scale_factor")
    return bad


def _copy_times(shape):
    """Host ms to hand one loader batch to the card, pageable (the copy
    waits for the stream) and through a pinned buffer (non_blocking), with
    the device ms of each copy (CUDA events)."""
    import numpy as np

    a = np.random.default_rng(0).random(shape, dtype=np.float32)
    dev = torch.device("cuda")
    out = {}
    for name, fn in (("pageable", lambda: torch.from_numpy(a).to(dev)),
                     ("pinned", lambda: torch.from_numpy(a).pin_memory().to(dev,
                                                                            non_blocking=True))):
        host, devt = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            fn()
            e.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            devt.append(s.elapsed_time(e))
        out[name] = (statistics.median(host[1:]), statistics.median(devt[1:]))
    return out


@contextlib.contextmanager
def cli_workspace():
    """A temporary directory under build/ with a synthetic preprocessed
    dataset (``_write_cli_dataset``) and the flagship config, the
    ``medimgen_*`` environment variables pointing into it; both CLI phases
    run there, and it is deleted afterwards. Yields {root, cfg, gpu}."""
    import tempfile

    from medical_image_generation_tpu_torch.io import volstore
    from medical_image_generation_tpu_torch.ops import _build

    gpu = card()
    base = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(base, exist_ok=True)
    free = shutil.disk_usage(base).free
    log(f"[cli] {gpu}: {free / 1e9:.1f} GB free under {base} (need {CLI_FREE_BYTES / 1e9:.0f})")
    if free < CLI_FREE_BYTES:
        raise AssertionError(f"not enough disk for the CLI phases: {free / 1e9:.1f} GB free")
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=base)
    env = {k: os.environ.get(k) for k in ("medimgen_preprocessed", "medimgen_results")}
    try:
        pre, res = os.path.join(root, "preprocessed"), os.path.join(root, "results")
        os.environ["medimgen_preprocessed"], os.environ["medimgen_results"] = pre, res
        cfg = _train_config(tiny=False)
        cfg["ddpm_batch_size"] = 2  # the flagship train step's batch (phase train)
        t0 = time.perf_counter()
        ds_bytes = _write_cli_dataset(pre, cfg)
        codec = volstore.codec_in_use()
        log(f"[cli] {gpu}: codec {codec}; build error: {volstore.build_error}; dataset "
            f"{CLI_PATIENTS} x {CLI_VOLUME} float32 written in {time.perf_counter() - t0:.2f} s, "
            f"{ds_bytes / 1e6:.1f} MB on disk")
        yield {"root": root, "cfg": cfg, "gpu": gpu}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_cli(ws, train_counts, train_ms):
    """The LDM training CLI end to end (see the module docstring) on the
    autoencoder phase ae_cli trained, its epochs and interval sampling cut
    to CLI_TRAIN_STEPS / CLI_VAL_STEPS / CLI_DDIM_STEPS; returns the launch
    counts of its first epoch."""
    import functools
    from unittest import mock

    from medical_image_generation_tpu_torch.training import train_ldm

    loaders = functools.partial(train_ldm.get_data_loaders, train_steps=CLI_TRAIN_STEPS,
                                val_steps=CLI_VAL_STEPS)
    samples = functools.partialmethod(train_ldm.LDMTrainer.sample_images,
                                      num_inference_steps=CLI_DDIM_STEPS)
    with mock.patch.object(train_ldm, "get_data_loaders", loaders), \
            mock.patch.object(train_ldm.LDMTrainer, "sample_images", samples):
        return _cli_runs(ws, train_counts, train_ms)


def _cli_runs(ws, train_counts, train_ms):
    import numpy as np

    from medical_image_generation_tpu_torch.data import loader as loader_mod
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.io.nifti import load_nifti
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.training import checkpoints, sample, train_ldm

    t_phase = time.perf_counter()
    root, cfg, gpu = ws["root"], ws["cfg"], ws["gpu"]
    ae_best = os.path.join(os.environ["medimgen_results"], "Task099_Synth", "3d",
                           "autoencoder", "checkpoints", "best_model.pt")
    ae_vae = checkpoints.load_checkpoint(ae_best)["vae"]
    vae = AutoencoderKL.from_config(cfg["vae_params"], dtype=torch.float32, device="cpu")
    gn_e = sum(isinstance(m, GroupNorm) for m in vae.encoder.modules())
    attn_e = sum(isinstance(m, AttentionBlock) for m in vae.encoder.modules())
    gn_d = sum(isinstance(m, GroupNorm) for m in vae.decoder.modules())
    attn_d = sum(isinstance(m, AttentionBlock) for m in vae.decoder.modules())
    del vae

    # ---- the loader alone: one train epoch of a fresh loader
    seen, unpatch = _counting_reads()
    try:
        tl, _ = loader_mod.get_data_loaders(cfg, "099", "train-val-test",
                                            cfg["ddpm_batch_size"], "3d",
                                            cfg["ddpm_transformations"],
                                            train_steps=CLI_TRAIN_STEPS)
        t0 = time.perf_counter()
        n_b = sum(1 for _ in tl)
        load_s = time.perf_counter() - t0
    finally:
        unpatch()
    initial = tuple(compute_initial_patch_size(cfg["ddpm_transformations"]))
    log(f"[cli] {gpu}: loader alone, {n_b} train batches of (2, *{initial}, 1) with "
        f"{tl.num_threads} threads: {n_b / load_s:.2f} batches/s, "
        f"{seen['bytes'] / load_s / 1e9:.3f} GB/s decoded ({seen['reads']} bbox reads, "
        f"{seen['bytes'] / n_b / 1e6:.1f} MB decoded a batch)")
    copies = _copy_times((2, *initial, 1))
    log(f"[cli] {gpu}: one batch to the card, host ms / device ms: pageable "
        f"{copies['pageable'][0]:.3f} / {copies['pageable'][1]:.3f}, pinned + non_blocking "
        f"{copies['pinned'][0]:.3f} / {copies['pinned'][1]:.3f}")

    # ---- medimgen_torch_train_ldm: one epoch, interval sampling, last + best
    argv = ["099", "train-val-test", "3d", "--set", "val_plot_interval=1"]
    kernel_table.reset()
    t0 = time.perf_counter()
    tr = _run_main(train_ldm.run_cli, argv + ["--set", "n_epochs=1"])
    torch.cuda.synchronize()
    run1_s = time.perf_counter() - t0
    counts = kernel_table.launches()
    st = tr.epoch_stats[0]
    steps, val_steps = st["steps"], st["val_steps"]
    attn_u = sum(isinstance(m, AttentionBlock) for m in tr.unet.modules())
    gn_u = sum(isinstance(m, GroupNorm) for m in tr.unet.modules())
    ddim = CLI_DDIM_STEPS
    per_step = {k: v // 10 for k, v in train_counts.items()}
    fwd_u = {"flash_attn_fwd": attn_u, "gn_stats_fold": gn_u, "gn_affine_act": gn_u}
    fwd_e = {"flash_attn_fwd": attn_e, "gn_stats_fold": gn_e, "gn_affine_act": gn_e}
    fwd_d = {"flash_attn_fwd": attn_d, "gn_stats_fold": gn_d, "gn_affine_act": gn_d}
    expect = {k: (steps * per_step[k] + fwd_e.get(k, 0)                    # probe
                  + val_steps * (fwd_e.get(k, 0) + fwd_u.get(k, 0))      # val
                  + ddim * fwd_u.get(k, 0) + fwd_d.get(k, 0))            # samples
              for k in counts}
    log(f"[cli] {gpu}: epoch of {steps} train + {val_steps} val steps, probe, {ddim}-step "
        f"DDIM of 2 volumes: launches {counts}, predicted {expect} (per train step "
        f"{per_step}; a forward: U-Net {attn_u} attention / {gn_u} GroupNorm, encoder "
        f"{attn_e} / {gn_e}, decoder {attn_d} / {gn_d})")
    if (steps, val_steps) != (CLI_TRAIN_STEPS, CLI_VAL_STEPS) or counts != expect:
        raise AssertionError(f"CLI epoch: {steps} / {val_steps} steps, launches {counts} "
                             f"!= predicted {expect}")
    ae_same = all(torch.equal(v.cpu(), ae_vae[k].to(v.dtype))
                  for k, v in tr.vae.state_dict().items())
    log(f"[cli] {gpu}: the frozen VAE is phase ae_cli's best_model.pt (rounded to "
        f"{tr.vae.post_quant_conv.Conv_0.weight.dtype}): {ae_same}")
    if not ae_same:
        raise AssertionError("the LDM did not train on the autoencoder phase ae_cli wrote")
    cli_ms = st["train_s"] * 1e3 / steps
    log(f"[cli] {gpu}: CLI ms a train step {cli_ms:.3f} (epoch wall {st['train_s']:.3f} s "
        f"/ {steps}); phase train ms a step {train_ms:.3f}; loader "
        f"queue wait {st['wait_s'] * 1e3 / steps:.3f} ms a step; host-to-device copy "
        f"{st['copy_s'] * 1e3 / steps:.3f} ms a step (host time, pinned + non_blocking); "
        f"val {st['val_s'] * 1e3 / val_steps:.3f} ms a step; interval samples "
        f"{st['sample_s']:.3f} s -> {os.path.basename(st['samples'])}; run {run1_s:.1f} s")
    losses = tr.loss_dict
    if not (all(math.isfinite(v) for v in losses["rec_loss"] + losses["val_rec_loss"])
            and len(losses["rec_loss"]) == 1 and tr.opt.count == CLI_TRAIN_STEPS):
        raise AssertionError(f"CLI epoch: losses {losses}, AdamW count {tr.opt.count}")
    ckdir = tr.save_dict["checkpoints"]
    last = checkpoints.checkpoint_path(ckdir, "last_model")
    best = checkpoints.checkpoint_path(ckdir, "best_model")
    saved = st["saved"]
    if sorted(saved["names"]) != ["best_model", "last_model"] or not (
            os.path.exists(last) and os.path.exists(best)):
        raise AssertionError(f"epoch 1 wrote {saved['names']}, not last and best")
    nbytes = os.path.getsize(last)
    write_s = saved["write_s"] / len(saved["names"])
    t0 = time.perf_counter()
    payload = checkpoints.load_checkpoint(last)
    read_s = time.perf_counter() - t0
    diff = _state_equal(tr, payload)
    log(f"[cli] {gpu}: checkpoint {nbytes:,} bytes; device-to-host copy "
        f"{saved['payload_s']:.3f} s; write {write_s:.3f} s a file ({nbytes / write_s / 1e9:.3f}"
        f" GB/s); read {read_s:.3f} s ({nbytes / read_s / 1e9:.3f} GB/s); saved state equal "
        f"to the trainer's: {not diff}")
    if diff:
        raise AssertionError(f"last_model.pt differs from the trainer: {diff[:5]}")
    del tr
    torch.cuda.empty_cache()

    # ---- resume with -c to a second epoch
    restored = {}
    orig_restore = train_ldm.LDMTrainer._restore

    def checked_restore(self):
        orig_restore(self)
        restored["diff"] = _state_equal(self, payload)
        restored["start"] = self.start_epoch
        restored["loader"] = self.train_loader.state() == payload["train_loader"]

    train_ldm.LDMTrainer._restore = checked_restore
    try:
        t0 = time.perf_counter()
        tr = _run_main(train_ldm.run_cli, argv + ["-c", "--set", "n_epochs=2"])
        torch.cuda.synchronize()
        run2_s = time.perf_counter() - t0
    finally:
        train_ldm.LDMTrainer._restore = orig_restore
    del payload
    st2 = tr.epoch_stats[0]
    log(f"[cli] {gpu}: resume -c: start epoch {restored.get('start')} (0-based), restored "
        f"state equal to last_model.pt: {restored.get('diff') == []}, train loader's draws "
        f"restored: {restored.get('loader')}; AdamW count "
        f"{tr.opt.count}; loss_dict {tr.loss_dict}; epochs run {len(tr.epoch_stats)}; CLI ms "
        f"a train step {st2['train_s'] * 1e3 / st2['steps']:.3f}; run {run2_s:.1f} s")
    if (restored.get("start") != 1 or restored.get("diff") != [] or not restored.get("loader")
            or tr.opt.count != 2 * CLI_TRAIN_STEPS
            or len(tr.loss_dict["rec_loss"]) != 2 or len(tr.epoch_stats) != 1):
        raise AssertionError(f"resume failed: {restored}, count {tr.opt.count}, "
                             f"loss_dict {tr.loss_dict}")
    run_cfg = os.path.join(tr.save_path, "config.yaml")
    del tr
    torch.cuda.empty_cache()

    # ---- medimgen_torch_sample_ldm on best_model.pt: two .nii.gz volumes
    out = os.path.join(root, "samples")
    t0 = time.perf_counter()
    _run_main(sample.main_ldm, [run_cfg, best, "-n", "2", "--num_inference_steps", "10",
                                "-o", out])
    vol = load_nifti(os.path.join(out, "ldm_sample_000.nii.gz")).data  # NIfTI (X, Y, Z)
    ok = (vol.shape == (128, 128, 128) and bool(np.isfinite(vol).all())
          and float(vol.min()) >= 0.0 and float(vol.max()) <= 1.0
          and sorted(os.listdir(out)) == ["ldm_sample_000.nii.gz", "ldm_sample_001.nii.gz"])
    log(f"[cli] {gpu}: medimgen_torch_sample_ldm best_model.pt, 2 volumes, 10 DDIM steps: "
        f"ldm_sample_000.nii.gz {vol.shape} min {vol.min():.4f} max {vol.max():.4f} std "
        f"{vol.std():.4f} ok={ok} in {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("sampling from best_model.pt failed")
    eval3d = eval_3d_call(out)
    log(f"[cli] {gpu}: phase {time.perf_counter() - t_phase:.1f} s")
    return counts, eval3d


# ------------------------------------------------------------------------ 2D

# (M, C, groups) of the GroupNorms of each network on the 2D paths (the
# planner's 2D flagship: patch 256^2, latent 64^2 x 8) and of the eval's
# ResNet50 instance norms (one channel a group; 2D images of 256^2, 3D
# volumes of 128^3)
_GN_VAE_ENC_2D = [(65536, 64, 16), (16384, 64, 16), (16384, 128, 16), (4096, 128, 16),
                  (4096, 256, 16)]
_GN_VAE_DEC_2D = [(4096, 256, 16), (16384, 256, 16), (16384, 128, 16), (65536, 128, 16),
                  (65536, 64, 16)]
_GN_UNET_2D = [(4096, 256, 32), (4096, 512, 32), (4096, 768, 32), (1024, 256, 32),
               (1024, 512, 32), (1024, 768, 32), (1024, 1024, 32), (1024, 1280, 32),
               (256, 512, 32), (256, 768, 32), (256, 1280, 32), (256, 1536, 32)]
_GN_DISC_2D = [(4096, 128, 128), (3969, 256, 256)]
_GN_RESNET_2D = [(4096, 64, 64), (4096, 128, 128), (1024, 128, 128), (1024, 256, 256),
                 (256, 256, 256), (256, 512, 512), (64, 512, 512)]
_GN_RESNET_3D = [(32768, 64, 64), (32768, 128, 128), (4096, 128, 128), (4096, 256, 256),
                 (512, 256, 256), (512, 512, 512), (64, 512, 512)]
# phase plan's 2D probe trial: Task097's 2D config, patch 128 x 160 (the VAE
# at 128 x 160, 64 x 80, 32 x 40; the discriminator at 32 x 40 and 31 x 39)
_GN_PLAN_2D = [(20480, 64, 16), (5120, 64, 16), (5120, 128, 16), (1280, 128, 16),
               (1280, 256, 16), (5120, 256, 16), (20480, 128, 16), (1280, 128, 128),
               (1209, 256, 256)]
GN_SHAPES_2D = sorted(
    {(24, *s) for s in _GN_VAE_ENC_2D + _GN_VAE_DEC_2D + _GN_DISC_2D}        # AE step
    | {(24, *s) for s in _GN_PLAN_2D}                                        # plan's probe
    | {(48, *s) for s in _GN_VAE_ENC_2D + _GN_UNET_2D}                       # LDM step
    | {(b, *s) for b in (16, 4) for s in _GN_UNET_2D + _GN_VAE_DEC_2D}      # sampling
    | {(100, *s) for s in _GN_RESNET_2D} | {(2, *s) for s in _GN_RESNET_3D}  # eval
    | {(100, 64, 2048, 2048)})  # the widest instance norm a ResNet50 stage could need
FLASH_SHAPES_2D = [(48, 1024, 1, 512), (48, 256, 1, 768)]  # the 2D U-Net's sites, batch 48
FLASH_FWD_SHAPES_2D = [(16, 1024, 1, 512), (16, 256, 1, 768), (4, 1024, 1, 512),
                       (4, 256, 1, 768),  # sampling chunks of 16 and 4
                       (1, 4096, 1, 512), (1, 512, 1, 768)]  # phase train's one 3D volume
AE_BATCH_2D, LDM_BATCH_2D = 24, 48
# phase cli_2d's depth: epochs of 40 train / 8 val steps, DDIM 10 for the
# interval grid and the eval (the planner's 250 / 50 steps, DDIM 50 and the
# full ancestral eval trajectory)
CLI_2D_TRAIN_STEPS, CLI_2D_VAL_STEPS, CLI_2D_PATIENTS = 40, 8, 8
CLI_2D_VOLUME = (1, 48, 256, 256)


def _flash_2d_case(B, S, H, D, dt, gen, backward):
    """One flash shape against its plain versions (forward, and with
    ``backward`` the dQ and dK/dV passes, same bits twice); returns
    ({kernel: record}, log line)."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_attention(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    o_cut, lse_cut = fa.flash_attention_plain(q, k[:, FLASH_TILE:], v[:, FLASH_TILE:], scale)
    o_ok, l_ok, err, lerr = flash_close(o, lse, o_ref, lse_ref, dt)
    cut_seen = not any(flash_close(o_cut, lse_cut, o_ref, lse_ref, dt)[:2])
    ok = o_ok and l_ok and cut_seen
    timed = dt == torch.bfloat16
    fl, n, bhs = B * H * S * S * D, B * S * H * D, B * H * S
    isz = q.element_size()
    rec = {}
    line = (f"B={B} S={S} H={H} D={D} {str(dt)[6:]}: fwd max|o-plain|={err:.3e} "
            f"max|lse-plain|={lerr:.3e} one-tile-skip caught={cut_seen}")
    if timed:
        import torch.nn.functional as F

        ms = time_ms(lambda: fa.flash_attention(q, k, v, scale), 2, 5)
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale), 1, 3)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 2, 5)
        b_ = bound(4 * fl, 4 * n * isz + 4 * bhs, PEAK_BF16_FLOPS)
        rec["flash_attn_fwd"] = dict(shape=[B, S, H, D], dtype="bf16", max_abs_err=err, ms=ms,
                                     plain_ms=plain, bound_ms=b_[0], bound_by=b_[1],
                                     library_ms=lib)
        line += f" ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f} bound_ms={b_[0]:.4f}"
    if backward:
        dq, delta = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, scale)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
        r_dq, r_delta = fa.flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do, scale)
        r_dk, r_dv = fa.flash_bwd_dkdv_plain(q, k, v, do, lse_ref, r_delta, scale)
        dq2, delta2 = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, scale)
        dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
        same = all(torch.equal(a, b) for a, b in ((dq, dq2), (delta, delta2), (dk, dk2),
                                                  (dv, dv2)))
        res = {nm: within(g, r, *FLASH_BWD_TOL[dt])
               for nm, g, r in (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv))}
        d_ok, d_err, _ = within(delta, r_delta, 1e-5, 1e-5)
        ok = ok and all(x[0] for x in res.values()) and d_ok and same
        line += (" | bwd " + " ".join(f"max|{nm}-plain|={x[1]:.3e}" for nm, x in res.items())
                 + f" max|delta-plain|={d_err:.3e} bit-identical on a rerun={same}")
        if timed:
            ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, scale), 2, 5)
            ms_kv = time_ms(lambda: fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale), 2, 5)
            p_dq = time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do, scale), 1, 3)
            p_kv = time_ms(lambda: fa.flash_bwd_dkdv_plain(q, k, v, do, lse_ref, delta, scale),
                           1, 3)
            b_dq = bound(6 * fl, 6 * n * isz + 8 * bhs, PEAK_BF16_FLOPS)
            b_kv = bound(8 * fl, 6 * n * isz + 8 * bhs, PEAK_BF16_FLOPS)
            import torch.nn.functional as F

            qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            doh = do.transpose(1, 2).contiguous()

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

            lib = (time_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), 2, 5)
                   - time_ms(sdpa, 2, 5))
            for name, ms, pl, b_, e in (("flash_attn_bwd_dq", ms_dq, p_dq, b_dq, res["dq"][1]),
                                        ("flash_attn_bwd_dkdv", ms_kv, p_kv, b_kv,
                                         max(res["dk"][1], res["dv"][1]))):
                rec[name] = dict(shape=[B, S, H, D], dtype="bf16", max_abs_err=e, ms=ms,
                                 plain_ms=pl, bound_ms=b_[0], bound_by=b_[1], library_ms=lib)
            line += (f" dq ms={ms_dq:.4f} plain_ms={p_dq:.4f} bound_ms={b_dq[0]:.4f} | dkdv "
                     f"ms={ms_kv:.4f} plain_ms={p_kv:.4f} bound_ms={b_kv[0]:.4f} | SDPA backward "
                     f"ms={lib:.4f}")
    if not ok:
        raise AssertionError(f"[kernels_2d] flash kernels disagree with their plain versions: "
                             f"{line}")
    return rec, line


def phase_kernels_2d():
    """Every port kernel against its plain version at the 2D paths' shapes:
    flash forward and backward at batch 48 (the 2D U-Net's two attention
    sites) and forward at the sampling chunks of 16 and 4; the four
    GroupNorm kernels at every ``GN_SHAPES_2D`` shape, bf16 and fp32.
    Returns {kernel: [record at each 2D flash shape]} and {kernel: the
    largest ms / bound over the GroupNorm shapes}."""
    gpu = card()
    gen = torch.Generator(device="cuda").manual_seed(29)
    recs = {}
    t0 = time.perf_counter()
    for shape in FLASH_SHAPES_2D + FLASH_FWD_SHAPES_2D:
        for dt in (torch.bfloat16, torch.float32):
            rec, line = _flash_2d_case(*shape, dt, gen, backward=shape in FLASH_SHAPES_2D)
            log(f"[kernels_2d] {gpu}: flash {line} OK")
            for name, r in rec.items():
                recs.setdefault(name, []).append(r)
    worst = {}
    for shape in GN_SHAPES_2D:
        for dt in (torch.bfloat16, torch.float32):
            times, line = _gn_case(*shape, dt, gen, "kernels_2d")
            log(f"[kernels_2d] {gpu}: groupnorm {line} OK")
            for name, (ms, b_ms) in times.items():
                if ms / b_ms > worst.get(name, (0, None))[0]:
                    worst[name] = (ms / b_ms, list(shape))
        torch.cuda.empty_cache()
    log(f"[kernels_2d] {gpu}: {len(GN_SHAPES_2D)} GroupNorm shapes and "
        f"{len(FLASH_SHAPES_2D + FLASH_FWD_SHAPES_2D)} flash shapes agree; largest ms / bound "
        f"(per-call medians with the wrapper's host time) {worst}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return recs, worst


def gn_seen(nets, fn):
    """Run fn with hooks on every GroupNorm of ``nets``: returns ({kernel:
    least ms of the GroupNorm launches fn made, forward and backward}, the
    set of (B, M, C, groups) they saw). Every call counts as differentiated
    when ``torch.is_grad_enabled``."""
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm

    seen = []

    def hook(mod, args):
        x = args[0]
        seen.append((tuple(x.shape), x.element_size(), mod.num_groups,
                     torch.is_grad_enabled() and x.requires_grad))

    handles = [m.register_forward_pre_hook(hook) for net in nets for m in net.modules()
               if isinstance(m, GroupNorm)]
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    ms = dict.fromkeys(kernel_table.KERNELS, 0.0)
    for shape, isz, _, grad in seen:
        for k, v in gn_bounds_ms(shape, isz, grad).items():
            ms[k] += v
    return ms, {(sh[0], math.prod(sh[2:]), sh[1], g) for sh, _, g, _ in seen}


def _check_gn_listed(label, shapes):
    missing = set(shapes) - set(GN_SHAPES_2D)
    if missing:
        raise AssertionError(f"[{label}] GroupNorm shapes not held by phase kernels_2d (add "
                             f"them to GN_SHAPES_2D): {sorted(missing)}")


def _timed_steps(step, warmup, steps):
    """(ms a step, peak GiB, launch counts, outputs) of ``steps`` calls of
    step() after ``warmup``."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_table.reset()
    t0 = time.perf_counter()
    outs = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    copies, scalar = kernel_table.total("input_copies"), _scalar_launches()
    if copies or any(scalar.values()):
        raise AssertionError(f"flash inputs copied {copies}, scalar GroupNorm launches {scalar}")
    return ms, torch.cuda.max_memory_allocated() / 2**30, kernel_table.launches(), outs


def phase_train_2d(warmup=2, steps=10):
    """The planner's 2D flagship at full width: the stage-1 step at batch 24
    (without, then with the adversarial loss) and the LDM step at batch 48;
    each 2 + 10 steps with ms a step, peak memory, launches held to the
    prediction, every GroupNorm shape held by phase kernels_2d, a profile
    (device busy, idle share, each kernel's device ms beside its summed
    bound) and the parts alone. Returns {"ae": .., "ldm": ..} with the
    launches a step and the kernels' device ms / bound a step."""
    from medical_image_generation_tpu_torch.data.augment import augment_batch
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.models.discriminator import least_squares_gan_loss
    from medical_image_generation_tpu_torch.training import common
    from medical_image_generation_tpu_torch.training.train_autoencoder import (
        METRICS,
        AutoEncoderTrainer,
    )
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    torch.backends.cudnn.allow_tf32 = True
    dev, gpu = torch.device("cuda"), card()
    cfg = _train_config(False, spatial_dims=2)
    out = {}

    # ---- stage 1, batch 24
    tr = AutoEncoderTrainer.from_config(cfg, "vae", device=dev, dtype=torch.bfloat16, seed=0)
    randomize_(tr.model, 6321)
    randomize_(tr.discriminator, 6322)
    n_g, n_d = sum(p.numel() for p in tr.g_params), sum(p.numel() for p in tr.d_params)
    initial = tuple(compute_initial_patch_size(cfg["ae_transformations"]))
    B = int(cfg["ae_batch_size"])
    gen = torch.Generator(device=dev).manual_seed(19)
    batch = torch.rand((B, *initial, 1), generator=gen, device=dev)
    log(f"[train_2d] {gpu}: 2D KL-VAE {cfg['vae_params']['num_channels']} params={n_g:,} "
        f"(fp32 masters, bf16), PatchDiscriminator params={n_d:,}, 2D VGG16 perceptual loss; "
        f"batch {tuple(batch.shape)} -> crop {tr.aug_cfg.crop_to}; perc {tr.perc_weight} kl "
        f"{tr.kl_weight} adv {tr.adv_weight}")
    if (B, n_g, tr.perc_weight, tr.kl_weight) != (AE_BATCH_2D, 7_063_457, 0.5, 1e-6):
        raise AssertionError(f"not the planner's 2D stage-1 config: batch {B}, params {n_g}")
    for adv_on in (False, True):
        per_step = ae_per_step(tr, adv_on)
        ms, peak, counts, ms_ = _timed_steps(lambda: tr.train_step(batch, adv_on), warmup, steps)
        losses = {k: [float(m[k]) for m in ms_] for k in METRICS}
        expect = {k: v * steps for k, v in per_step.items()}
        bounds, shapes = gn_seen([tr.model, tr.discriminator],
                                 lambda: tr.train_step(batch, adv_on))
        bounds.update(opt_bounds(*ae_opts(tr, adv_on)))
        _check_gn_listed("train_2d", shapes)
        busy, shares = profile_breakdown(f"2D AE step adv_on={adv_on}",
                                         lambda: tr.train_step(batch, adv_on))
        prof = profile_breakdown.last
        log(f"[train_2d] {gpu}: AE adv_on={adv_on}: {ms:.3f} ms a step, device busy "
            f"{busy:.3f} ms, idle share {prof['idle_share']:.3f} (profiler), host enqueue "
            f"{prof['host_ms']:.3f} ms, peak memory {peak:.2f} GiB; launches {counts}, predicted "
            f"{expect}; losses (first, last) "
            f"{({k: (round(v[0], 5), round(v[-1], 5)) for k, v in losses.items()})}")
        for name in per_step:
            if per_step[name]:
                log(f"[train_2d] {gpu}: AE adv_on={adv_on} per step: {name} device ms="
                    f"{shares[name]:.4f} bound ms={bounds[name]:.4f} ({per_step[name]} launches)")
        if counts != expect or not all(math.isfinite(v) for vs in losses.values() for v in vs):
            raise AssertionError(f"2D AE step: launches {counts} != {expect}, or losses {losses}")
        out[f"ae_{int(adv_on)}"] = dict(ms=ms, busy=busy, idle=prof["idle_share"], peak=peak,
                                        per_step=per_step,
                                        step={k: (shares[k], bounds[k]) for k in bounds})
    draws = tr.make_draws(batch)
    imgs = augment_batch(batch, draws.augment, tr.aug_cfg)
    with torch.no_grad():
        recon = tr.model(imgs, draws.eps)[0]
    r = recon.detach().requires_grad_()
    D = tr.discriminator

    def vae_fwd_bwd():
        rc, mu, sigma = tr.model(imgs, draws.eps)
        return torch.autograd.grad(common.l1_loss(rc, imgs)
                                   + common.kl_loss(mu, sigma) * tr.kl_weight, tr.g_params)

    parts = {"augment (per-sample loop, batch 24)": lambda: augment_batch(
                 batch, draws.augment, tr.aug_cfg),
             "VAE forward+backward": vae_fwd_bwd,
             "perceptual forward+backward": lambda: torch.autograd.grad(
                 tr.perceptual(r, imgs) * tr.perc_weight, r),
             "discriminator on the reconstruction": lambda: torch.autograd.grad(
                 least_squares_gan_loss(logits_fake=D(r)) * tr.adv_weight, r),
             "discriminator update's passes": lambda: torch.autograd.grad(
                 least_squares_gan_loss(logits_real=D(imgs), logits_fake=D(recon))
                 * tr.adv_weight, tr.d_params)}
    times = {k: time_ms(fn, 1, 3) for k, fn in parts.items()}
    g_grads = list(vae_fwd_bwd())
    times["generator clip+Adam"] = time_ms(lambda: tr.g_opt.step(g_grads), 1, 3)
    log(f"[train_2d] {gpu}: AE parts alone, ms: "
        + "; ".join(f"{k}={v:.3f}" for k, v in times.items()))
    out["ae_parts"] = times
    del tr, imgs, recon, r, g_grads, D
    torch.cuda.empty_cache()

    # ---- LDM, batch 48
    vae_f32 = AutoencoderKL.from_config(cfg["vae_params"], dtype=torch.float32, device=dev)
    randomize_(vae_f32, 6323)
    tr = LDMTrainer.from_config(cfg, vae_f32.state_dict(), device=dev, dtype=torch.bfloat16,
                                seed=0)
    del vae_f32
    randomize_(tr.unet, 6324)
    n_u = sum(p.numel() for p in tr.params)
    initial = tuple(compute_initial_patch_size(cfg["ddpm_transformations"]))
    B = int(cfg["ddpm_batch_size"])
    batch = torch.rand((B, *initial, 1), generator=gen, device=dev)
    scale, latent = tr.probe_latent(batch)

    def count(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    attn_u, gn_u, gn_e = (count(tr.unet, AttentionBlock), count(tr.unet, GroupNorm),
                          count(tr.vae.encoder, GroupNorm))
    per_step = launches(flash_attn_fwd=attn_u, flash_attn_bwd_dq=attn_u,
                        flash_attn_bwd_dkdv=attn_u, gn_stats_fold=gn_u + gn_e,
                        gn_affine_act=gn_u + gn_e, gn_bwd_stats=gn_u, gn_bwd_apply=gn_u,
                        **opt_launches(tr.opt))
    log(f"[train_2d] {gpu}: 2D U-Net {cfg['ddpm_params']['num_channels']} params={n_u:,}; "
        f"batch {tuple(batch.shape)} -> crop {tr.aug_cfg.crop_to} -> latent {latent}; "
        f"scale_factor {scale:.5f}; U-Net {attn_u} attention / {gn_u} GroupNorm, encoder "
        f"{gn_e} GroupNorm")
    if (B, n_u, latent[1:]) != (LDM_BATCH_2D, 171_277_832, (64, 64, 8)):
        raise AssertionError(f"not the planner's 2D LDM config: batch {B}, params {n_u}, "
                             f"latent {latent}")
    ms, peak, counts, losses = _timed_steps(lambda: tr.train_step(batch), warmup, steps)
    opt_copies = kernel_table.read("adamw_update.grad_copies")
    losses = [float(v) for v in losses]
    expect = {k: v * steps for k, v in per_step.items()}
    _check_gn_listed("train_2d", gn_seen([tr.unet, tr.vae.encoder],
                                         lambda: tr.train_step(batch))[1])
    bounds = step_bounds(tr, batch)
    busy, shares = profile_breakdown("2D LDM step", lambda: tr.train_step(batch))
    prof = profile_breakdown.last
    log(f"[train_2d] {gpu}: LDM: {ms:.3f} ms a step, device busy {busy:.3f} ms, idle share "
        f"{prof['idle_share']:.3f} (profiler), host enqueue {prof['host_ms']:.3f} ms, peak "
        f"memory {peak:.2f} GiB; launches {counts}, predicted {expect}; losses {losses}")
    for name in per_step:
        log(f"[train_2d] {gpu}: LDM per step: {name} device ms={shares[name]:.4f} bound ms="
            f"{bounds[name]:.4f} ({per_step[name]} launches)")
    if counts != expect or opt_copies or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"2D LDM step: launches {counts} != {expect}, or {opt_copies} "
                             f"gradients the optimizer copied, or losses {losses}")
    out["ldm"] = dict(ms=ms, busy=busy, idle=prof["idle_share"], peak=peak, per_step=per_step,
                      step={k: (shares[k], bounds[k]) for k in bounds})
    z = torch.randn(latent, generator=gen, device=dev)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev)

    def fwd_bwd():
        for p in tr.params:
            p.grad = None
        torch.mean((tr.unet(z, t).float() - z) ** 2).backward()

    draws = tr.make_draws(batch)
    imgs = augment_batch(batch, draws.augment, tr.aug_cfg)
    times = {"augment (per-sample loop, batch 48)": time_ms(
        lambda: augment_batch(batch, draws.augment, tr.aug_cfg), 1, 3)}
    with torch.no_grad():
        times["frozen encode"] = time_ms(lambda: tr.vae.encode_stage_2_inputs(imgs, draws.eps),
                                         1, 3)
    times["U-Net forward+backward"] = time_ms(fwd_bwd, 1, 3)
    grads = [p.grad for p in tr.params]
    times["clip+AdamW"] = time_ms(lambda: tr.opt.step(grads), 1, 3)
    log(f"[train_2d] {gpu}: LDM parts alone, ms: "
        + "; ".join(f"{k}={v:.3f}" for k, v in times.items()))
    out["ldm_parts"] = times
    out["opt"] = opt_check("train_2d", tr.opt, grads)
    del tr, grads, imgs
    torch.cuda.empty_cache()
    return out


def _eval_prediction(tr, n, steps):
    """Launches of one ``evaluate_generation`` of n samples at ``steps``
    trajectory steps: each chunk's U-Net forwards and decode, then the
    ResNet50 over the real and the generated images."""
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm

    def count(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    chunks = -(-n // 16)
    gn = (chunks * (steps * count(tr.unet, GroupNorm) + count(tr.vae.decoder, GroupNorm))
          + 2 * count(tr.feature_extractor.module, GroupNorm))
    out = dict.fromkeys(kernel_table.KERNELS, 0)
    out.update(flash_attn_fwd=chunks * steps * count(tr.unet, AttentionBlock),
               gn_stats_fold=gn, gn_affine_act=gn)
    return out


def phase_cli_2d(ws):
    """The three CLIs at the planner's 2D flagship on a synthetic 2D task
    (see the module docstring). Returns the launches of one eval."""
    import functools
    from unittest import mock

    import numpy as np

    from medical_image_generation_tpu_torch.data import loader as loader_mod
    from medical_image_generation_tpu_torch.io import png
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.training import sample, train_autoencoder, train_ldm

    t_phase = time.perf_counter()
    gpu = ws["gpu"]
    cfg = _train_config(False, spatial_dims=2)
    nbytes = _write_cli_dataset(os.environ["medimgen_preprocessed"], cfg, task="Task098_Synth2D",
                                volume=CLI_2D_VOLUME, patients=CLI_2D_PATIENTS, key="2D")
    log(f"[cli_2d] {gpu}: dataset {CLI_2D_PATIENTS} x {CLI_2D_VOLUME} float32, "
        f"{nbytes / 1e6:.1f} MB on disk")
    argv = ["098", "train-val-test", "2d", "--set", "n_epochs=1", "--set", "val_plot_interval=1"]
    loaders = functools.partial(loader_mod.get_data_loaders, train_steps=CLI_2D_TRAIN_STEPS,
                                val_steps=CLI_2D_VAL_STEPS)
    samples = functools.partialmethod(train_ldm.LDMTrainer.sample_images,
                                      num_inference_steps=CLI_DDIM_STEPS)
    evals = []
    orig_eval = train_ldm.LDMTrainer.evaluate_generation

    def counted_eval(self, *a, **k):
        extractor = self.feature_extractor  # built before the hooks go on
        c0, res = kernel_table.launches(), []
        t0 = time.perf_counter()
        bounds, shapes = gn_seen([self.unet, self.vae.decoder, extractor.module],
                                 lambda: res.append(orig_eval(self, *a, **k)))
        evals.append(dict(metrics=res[0], secs=time.perf_counter() - t0, bounds=bounds,
                          shapes=shapes,
                          counts={n: c - c0[n] for n, c in kernel_table.launches().items()},
                          expect=_eval_prediction(self, 100, CLI_DDIM_STEPS)))
        return res[0]

    with mock.patch.object(train_autoencoder, "get_data_loaders", loaders), \
            mock.patch.object(train_ldm, "get_data_loaders", loaders), \
            mock.patch.object(train_ldm.LDMTrainer, "sample_images", samples), \
            mock.patch.object(train_ldm.LDMTrainer, "evaluate_generation", counted_eval):
        # ---- medimgen_torch_train_autoencoder ... 2d
        t0 = time.perf_counter()
        ae = _run_main(train_autoencoder.run_cli, argv)
        torch.cuda.synchronize()
        st = ae.epoch_stats[0]
        rec = png.read_png(st["recon"])
        log(f"[cli_2d] {gpu}: medimgen_torch_train_autoencoder 2d: {st['steps']} train + "
            f"{st['val_steps']} val steps at batch {ae.config['ae_batch_size']}, CLI ms a train "
            f"step {st['train_s'] * 1e3 / st['steps']:.3f}, val {st['val_s'] * 1e3 / st['val_steps']:.3f}"
            f" ms a step, loader wait {st['wait_s'] * 1e3 / st['steps']:.3f} ms a step; saved "
            f"{st['saved']}; reconstruction {os.path.basename(st['recon'])} {rec.shape}; run "
            f"{time.perf_counter() - t0:.1f} s")
        if (st["steps"] != CLI_2D_TRAIN_STEPS or rec.shape != (256, 2 * 256 + 2)
                or sorted(st["saved"]) != ["best_model", "last_model"]):
            raise AssertionError(f"2D AE CLI: {st}")
        del ae
        torch.cuda.empty_cache()

        # ---- medimgen_torch_train_ldm ... 2d with the default generative eval
        t0 = time.perf_counter()
        tr = _run_main(train_ldm.run_cli, argv + [
            "--set", "eval_sampler=ddim", "--set", f"eval_num_inference_steps={CLI_DDIM_STEPS}",
            "--set", "eval_mmd=true"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    st = tr.epoch_stats[0]
    grid = png.read_png(st["samples"])
    ev = evals[0]
    m = ev["metrics"]
    log(f"[cli_2d] {gpu}: medimgen_torch_train_ldm 2d: {st['steps']} train + {st['val_steps']} "
        f"val steps at batch {tr.config['ddpm_batch_size']}, CLI ms a train step "
        f"{st['train_s'] * 1e3 / st['steps']:.3f}, val {st['val_s'] * 1e3 / st['val_steps']:.3f} "
        f"ms a step, loader wait {st['wait_s'] * 1e3 / st['steps']:.3f} ms and copy "
        f"{st['copy_s'] * 1e3 / st['steps']:.3f} ms a step; interval grid "
        f"{os.path.basename(st['samples'])} {grid.shape} in {st['sample_s']:.3f} s; run "
        f"{run_s:.1f} s")
    log(f"[cli_2d] {gpu}: evaluate_generation (n=100, DDIM {CLI_DDIM_STEPS}, eval_mmd): FID "
        f"{m['fid']:.4f} SSIM {m['ssim']:.4f} +- {m['ssim_std']:.4f} MS-SSIM {m['ms_ssim']:.4f} "
        f"+- {m['ms_ssim_std']:.4f} MMD {m['mmd']:.6f} over {m['n_pairs']} pairs; seconds "
        f"{({k: round(v, 3) for k, v in m['seconds'].items()})} ({ev['secs']:.3f} s in all); "
        f"launches {ev['counts']}, predicted {ev['expect']}; GroupNorm shapes "
        f"{sorted(ev['shapes'])}; summed bound ms {({k: round(v, 4) for k, v in ev['bounds'].items() if v})}")
    finite = all(math.isfinite(m[k]) for k in ("fid", "ssim", "ms_ssim", "mmd"))
    if (m["n_pairs"] != 4950 or not finite or ev["counts"] != ev["expect"]
            or grid.shape != (4 * 256 + 6,) * 2 or st["steps"] != CLI_2D_TRAIN_STEPS):
        raise AssertionError(f"2D LDM CLI / eval: {m}, launches {ev['counts']} != "
                             f"{ev['expect']}, grid {grid.shape}")
    _check_gn_listed("cli_2d", ev["shapes"])

    # ---- one 16-sample chunk over the full 1000-step ancestral trajectory
    attn_u = sum(isinstance(x, AttentionBlock) for x in tr.unet.modules())
    gn_ud = (1000 * sum(isinstance(x, GroupNorm) for x in tr.unet.modules())
             + sum(isinstance(x, GroupNorm) for x in tr.vae.decoder.modules()))
    kernel_table.reset()
    t0 = time.perf_counter()
    chunk = tr.sample_images(16, sampler="ddpm",
                             generator=torch.Generator(device="cuda").manual_seed(777))
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    counts = kernel_table.launches()
    nonsample = sum(v for k, v in m["seconds"].items() if k != "sampling")
    log(f"[cli_2d] {gpu}: one 16-sample chunk of the full 1000-step DDPM trajectory: "
        f"{chunk_s:.2f} s ({chunk_s:.4f} ms a step x1000), images {chunk.shape} finite "
        f"{bool(np.isfinite(chunk).all())}; launches {counts}; the full protocol (7 chunks, "
        f"the last of 4 samples, + features, FID, pairwise, MMD) projects to at most "
        f"{7 * chunk_s + nonsample:.1f} s an eval")
    if (chunk.shape != (16, 256, 256, 1) or not np.isfinite(chunk).all()
            or counts["flash_attn_fwd"] != 1000 * attn_u or counts["gn_stats_fold"] != gn_ud):
        raise AssertionError(f"full-trajectory chunk: {chunk.shape}, launches {counts}")
    run_cfg = os.path.join(tr.save_path, "config.yaml")
    best = os.path.join(tr.save_dict["checkpoints"], "best_model.pt")
    del tr, chunk
    torch.cuda.empty_cache()

    # ---- medimgen_torch_sample_ldm: PNGs, read back
    out = os.path.join(ws["root"], "samples_2d")
    t0 = time.perf_counter()
    _run_main(sample.main_ldm, [run_cfg, best, "-n", "4", "--num_inference_steps",
                                str(CLI_DDIM_STEPS), "-o", out])
    names = sorted(os.listdir(out))
    imgs = [png.read_png(os.path.join(out, f)) for f in names]
    ok = (names == [f"ldm_sample_{i:03d}.png" for i in range(4)] + ["ldm_sample_grid.png"]
          and all(i.shape == (256, 256) for i in imgs[:4]) and imgs[4].shape == (256, 4 * 256 + 6))
    log(f"[cli_2d] {gpu}: medimgen_torch_sample_ldm 2d, 4 samples, {CLI_DDIM_STEPS} DDIM steps: "
        f"{names} shapes {[i.shape for i in imgs]} ok={ok} in {time.perf_counter() - t0:.1f} s; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        raise AssertionError(f"2D sampling CLI wrote {names}")
    return ev["counts"]


def eval_3d_call(out_dir):
    """The 3D eval's features (``FeatureExtractor(spatial_dims=3)``,
    random-feature ResNet50, bf16) on the two volumes the 3D sampling CLI
    wrote, read back from their ``.nii.gz``; returns its launches."""
    import numpy as np

    from medical_image_generation_tpu_torch.eval.features import FeatureExtractor
    from medical_image_generation_tpu_torch.io.nifti import load_nifti
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm

    gpu = card()
    vols = np.stack([np.transpose(load_nifti(os.path.join(out_dir, f"ldm_sample_{i:03d}.nii.gz"))
                                  .data, (2, 1, 0))[..., None] for i in range(2)])
    fe = FeatureExtractor(spatial_dims=3)
    fe(vols)  # warm-up
    torch.cuda.synchronize()
    kernel_table.reset()
    t0 = time.perf_counter()
    feats = fe(vols)
    secs = time.perf_counter() - t0
    counts = kernel_table.launches()
    bounds, shapes = gn_seen([fe.module], lambda: fe(vols))
    _check_gn_listed("eval_3d", shapes)
    n_gn = sum(isinstance(x, GroupNorm) for x in fe.module.modules())
    log(f"[eval_3d] {gpu}: FeatureExtractor(spatial_dims=3) on the sampling CLI's volumes "
        f"{vols.shape} read back from .nii.gz: features {feats.shape} finite "
        f"{bool(np.isfinite(feats).all())} in {secs * 1e3:.1f} ms; launches {counts}; "
        f"GroupNorm shapes {sorted(shapes)}; summed bound ms "
        f"{({k: round(v, 4) for k, v in bounds.items() if v})}")
    if (feats.shape != (2, 2048) or not np.isfinite(feats).all()
            or counts["gn_stats_fold"] != n_gn or fe.dtype != torch.bfloat16):
        raise AssertionError(f"3D eval call: features {feats.shape}, launches {counts}")
    return counts


# phase plan's raw task: each patient's inner (nonzero) extent in NIfTI (X, Y,
# Z) order and its X spacing. The cropped median is (128, 128, 128), the 3D
# flagship's; plan_001, plan_002 and plan_006 are wider than it in X, so
# their (1, 1, 128, 128) chunks split the last axis; plan_006 and plan_007
# are resampled (1.25 -> 1.0 in X) and have no zero border (the cubic zoom
# leaves no exact zeros to crop), the others a border of PLAN_BORDER voxels
PLAN_RAW = [((128, 128, 128), 1.0), ((150, 126, 130), 1.0), ((136, 132, 126), 1.0),
            ((124, 128, 128), 1.0), ((128, 124, 132), 1.0), ((120, 130, 124), 1.0),
            ((112, 128, 128), 1.25), ((96, 124, 132), 1.25)]
PLAN_BORDER = 6
PLAN_TRAIN_STEPS, PLAN_VAL_STEPS = 20, 4  # the cut epoch of the AE CLI on the plan
# remat vs no remat, one bf16 AE step from the same weights and draws, per
# gradient tensor: |g - g_ref| <= tol |g_ref| + tol max|g_ref| (one bf16 ulp,
# as GN_BWD_TOL's rtol: cuDNN's weight-gradient kernels may sum in another
# order from one call to the next); losses relative 1e-6
PLAN_GRAD_TOL, PLAN_LOSS_TOL = 2**-7, 1e-6
REMAT_RUNGS = {"none": (False, "acts"), "acts": (True, "acts"), "full": (True, "full")}


def _write_raw_task(root, seed=97):
    """Task097_Plan: imagesTr/ + labelsTr/ .nii.gz of PLAN_RAW, written with
    the port's save_nifti (noisy images with two labelled spheres). Returns
    (its path, bytes written)."""
    import numpy as np

    from medical_image_generation_tpu_torch.io.nifti import save_nifti

    rng = np.random.default_rng(seed)
    ds = os.path.join(root, "Task097_Plan")
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub))
    nbytes = 0
    for i, (inner, sx) in enumerate(PLAN_RAW):
        b = PLAN_BORDER if sx == 1.0 else 0
        box = tuple(slice(b, b + n) for n in inner)
        img = np.zeros(tuple(n + 2 * b for n in inner), np.float32)
        img[box] = rng.normal(300.0, 40.0, inner).clip(1.0, None)
        lbl = np.zeros(img.shape, np.uint8)
        grid = np.meshgrid(*(np.arange(n) for n in inner), indexing="ij", sparse=True)
        for cls in (1, 2):
            c = [int(rng.integers(n // 3, 2 * n // 3)) for n in inner]
            r = int(rng.integers(10, 20))
            m = sum((g - cg) ** 2 for g, cg in zip(grid, c)) <= r * r
            img[box][m] += 150.0 * cls
            lbl[box][m] = cls
        affine = np.diag([sx, 1.0, 1.0, 1.0])
        for sub, arr in (("imagesTr", img), ("labelsTr", lbl)):
            path = os.path.join(ds, sub, f"plan_{i:03d}.nii.gz")
            save_nifti(path, arr, affine)
            nbytes += os.path.getsize(path)
    return ds, nbytes


def _reference_patient(ds, pid, spacing):
    """(image, label) that process_patient computes for one raw patient:
    resample, crop to the image's nonzero box, (C, Z, Y, X) / (Z, Y, X),
    z-score -> min-max. The written .vs must read back to these bit for
    bit."""
    import numpy as np

    from medical_image_generation_tpu_torch.io.nifti import load_nifti
    from medical_image_generation_tpu_torch.planning import preprocess as pre

    nii = load_nifti(os.path.join(ds, "imagesTr", pid + ".nii.gz"))
    lab = load_nifti(os.path.join(ds, "labelsTr", pid + ".nii.gz")).get_fdata()
    img = pre.resample_image(nii.get_fdata(), nii.spacing, spacing)
    lab = pre.resample_label(lab.astype(np.int32), nii.spacing, spacing)
    _, _, (lo, hi) = pre.crop_to_nonzero(img)
    sl = tuple(slice(int(a), int(b) + 1) for a, b in zip(lo, hi))
    image, _ = pre.normalize_zscore_then_minmax(pre.to_canonical_axes(img[sl]).astype(np.float32))
    return image, np.transpose(lab[sl], (2, 1, 0)).astype(np.uint8)


def ae_launches(cfg, adv_on, remat):
    """Launches of each port kernel the code predicts for one AE train step
    of a config (the models built on the CPU to count their GroupNorms), as
    ``ae_per_step``; under remat each Encoder / Decoder ResBlock runs its
    two GroupNorm forwards once more in the backward (the recompute), for
    both policies; the optimizers' launches as ``ae_per_step``'s."""
    from types import SimpleNamespace

    from medical_image_generation_tpu_torch.models.blocks import GroupNorm, ResBlock
    from medical_image_generation_tpu_torch.models.discriminator import PatchDiscriminator
    from medical_image_generation_tpu_torch.training import common

    def n(mod):
        return sum(isinstance(m, GroupNorm) for m in mod.modules())

    def opt(net):  # what opt_launches reads of the trainer's AdamW over net
        return SimpleNamespace(params=[p for p in net.parameters() if p.requires_grad],
                               clip=float(cfg.get("grad_clip_max_norm", 1.0)))

    g = common.build_generator(cfg, "vae", torch.float32, device="cpu")
    gn, opts = n(g.encoder) + n(g.decoder), [opt(g)]
    if adv_on:
        d = PatchDiscriminator.from_config(cfg["discriminator_params"], device="cpu")
        gn += 3 * n(d)
        opts.append(opt(d))
    extra = sum(n(b) for b in g.modules() if isinstance(b, ResBlock)) if remat else 0
    return launches(gn_stats_fold=gn + extra, gn_affine_act=gn + extra, gn_bwd_stats=gn,
                    gn_bwd_apply=gn, **opt_launches(*opts))


def phase_plan(ws):
    """medimgen_torch_plan_and_preprocess on a raw task with the memory
    probe, the forced remat ladder at the 3D flagship, remat against no
    remat at full width, and the AE CLI on the plan under remat (see the
    module docstring), every GroupNorm call's (B, M, C, groups) recorded
    and held to the shapes the kernel phases check. Returns {rung: {kernel:
    launches in one trial step}}."""
    from unittest import mock

    from medical_image_generation_tpu_torch.models.blocks import GroupNorm

    seen, forward = set(), GroupNorm.forward

    def recording_forward(mod, x, *a, **k):
        seen.add((x.shape[0], math.prod(x.shape[2:]), x.shape[1], mod.num_groups))
        return forward(mod, x, *a, **k)

    with mock.patch.object(GroupNorm, "forward", recording_forward):
        per_rung = _plan_run(ws)
    held = set(GN_SHAPES_2D) | {(2, *s) for s in GN_SHAPES}  # phases 11; 3 and 4 at batch 2
    log(f"[plan] {ws['gpu']}: GroupNorm shapes (B, M, C, groups) of the phase {sorted(seen)}")
    if seen - held:
        raise AssertionError(f"[plan] GroupNorm shapes not held by the kernel phases (add them "
                             f"to _GN_PLAN_2D or GN_SHAPES): {sorted(seen - held)}")
    return per_rung


def _plan_run(ws):
    import functools
    from unittest import mock

    import numpy as np
    import yaml

    from medical_image_generation_tpu_torch.data import loader as loader_mod
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.io.volstore import VolStore
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm
    from medical_image_generation_tpu_torch.planning import cli, memory
    from medical_image_generation_tpu_torch.planning.planner import flagship_configs
    from medical_image_generation_tpu_torch.training import train_autoencoder
    from medical_image_generation_tpu_torch.training.train_autoencoder import (
        METRICS,
        AutoEncoderTrainer,
    )

    t_phase = time.perf_counter()
    gpu = ws["gpu"]
    t0 = time.perf_counter()
    raw, nbytes = _write_raw_task(os.path.join(ws["root"], "raw"))
    log(f"[plan] {gpu}: raw task {len(PLAN_RAW)} patients (NIfTI X, Y, Z inner extents "
        f"{[r[0] for r in PLAN_RAW]}, X spacings {[r[1] for r in PLAN_RAW]}), "
        f"{nbytes / 1e6:.1f} MB of .nii.gz written in {time.perf_counter() - t0:.1f} s")

    # ---- medimgen_torch_plan_and_preprocess with the probe, its parts timed
    marks, trials = {}, []

    def timed(name, fn):
        def wrapped(*a, **k):
            marks.setdefault(name, [time.perf_counter(), None])
            out = fn(*a, **k)
            marks[name][1] = time.perf_counter()
            return out
        return wrapped

    orig_trial = memory.trial_ae_step

    def recorded_trial(config, batch_size, use_checkpointing=False, remat_policy="acts",
                       device="cuda"):
        c0 = kernel_table.launches()
        out = orig_trial(config, batch_size, use_checkpointing, remat_policy, device)
        trials.append(dict(out, cfg=config, batch=batch_size, remat=use_checkpointing,
                           counts={k: v - c0[k] for k, v in kernel_table.launches().items()}))
        return out

    t0 = time.perf_counter()
    with mock.patch.object(cli, "calculate_median_spacing",
                           timed("spacing", cli.calculate_median_spacing)), \
            mock.patch.object(cli, "calculate_dataset_fingerprint",
                              timed("fingerprint", cli.calculate_dataset_fingerprint)), \
            mock.patch.object(memory, "auto_select_hyperparams",
                              timed("probe", memory.auto_select_hyperparams)), \
            mock.patch.object(memory, "trial_ae_step", recorded_trial):
        _run_main(cli.main, [raw])
    cli_s = time.perf_counter() - t0
    fp_s = sum(marks[k][1] - marks[k][0] for k in ("spacing", "fingerprint"))
    pre_s = marks["probe"][0] - marks["fingerprint"][1]
    probe_s = marks["probe"][1] - marks["probe"][0]
    out = os.path.join(os.environ["medimgen_preprocessed"], "Task097_Plan")
    with open(os.path.join(out, "dataset.json")) as f:
        dataset = json.load(f)
    with open(os.path.join(out, "medimgen_config.yaml")) as f:
        plan = yaml.safe_load(f)
    budget = memory.device_memory_budget()
    log(f"[plan] {gpu}: medimgen_torch_plan_and_preprocess in {cli_s:.1f} s: fingerprint "
        f"{fp_s:.2f} s, preprocessing {pre_s:.2f} s, probe {probe_s:.2f} s; dataset "
        f"{({k: dataset[k] for k in ('median_shape', 'max_shape', 'median_spacing', 'n_patients', 'class_labels')})}")
    for t in trials:
        sd = t["cfg"]["vae_params"]["spatial_dims"]
        expect = {k: v * memory.TRIAL_STEPS
                  for k, v in ae_launches(t["cfg"], True, t["remat"]).items()}
        log(f"[plan] {gpu}: probe trial {sd}D batch {t['batch']} remat {t['remat']}: peak "
            f"reserved {t['reserved'] / 2**30:.3f} GiB, allocated {t['allocated'] / 2**30:.3f} "
            f"GiB (budget {budget / 2**30:.3f} GiB = {memory.SAFETY_FRACTION} x the card), "
            f"{t['ms']:.2f} ms a step; {memory.TRIAL_STEPS} steps launched {t['counts']}, predicted "
            f"{expect}")
        if t["counts"] != expect:
            raise AssertionError(f"probe trial launches {t['counts']} != predicted {expect}")
    chosen = {k: (c["ae_batch_size"], c["grad_accumulate_step"],
                  c["vae_params"]["use_checkpointing"], c["vae_params"]["remat_policy"],
                  c["ddpm_batch_size"]) for k, c in plan.items()}
    log(f"[plan] {gpu}: plan (ae batch, grad accumulation, remat, policy, ddpm batch) {chosen}")
    vae_ref = json.loads(json.dumps(flagship_configs(spatial_dims=3)[0]))
    vae3 = {k: v for k, v in plan["3D"]["vae_params"].items() if k != "remat_policy"}
    if (dataset["median_shape"] != [128, 128, 128] or dataset["n_patients"] != len(PLAN_RAW)
            or vae3 != vae_ref or chosen["3D"] != (2, 1, False, "acts", 4)
            or chosen["2D"] != (24, 1, False, "acts", 24) or len(trials) != 2):
        raise AssertionError(f"plan: {dataset}, {chosen}, 3D vae_params {vae3} vs flagship "
                             f"{vae_ref}, {len(trials)} probe trials")

    # ---- every .vs read back against what process_patient computes
    t0 = time.perf_counter()
    wider = []
    for i in range(len(PLAN_RAW)):
        pid = f"plan_{i:03d}"
        image, label = _reference_patient(raw, pid, dataset["median_spacing"])
        vi = VolStore(os.path.join(out, "imagesTr", pid + ".vs"))
        vl = VolStore(os.path.join(out, "labelsTr", pid + ".vs"))
        if not (np.array_equal(vi.read_full(), image) and np.array_equal(vl.read_full(), label)):
            raise AssertionError(f"{pid}: the preprocessed volume differs from process_patient's")
        if vi.shape[-1] > vi.chunk_shape[-1]:
            wider.append((pid, vi.shape, vi.chunk_shape))
    log(f"[plan] {gpu}: all {len(PLAN_RAW)} images and labels read back bit for bit equal to "
        f"process_patient's arrays ({time.perf_counter() - t0:.1f} s), the chunks of "
        f"{len(wider)} split the last axis: {wider}")
    if len(wider) < 3:
        raise AssertionError(f"fewer than 3 patients wider than the median: {wider}")

    # ---- the forced ladder at the 3D flagship, batch 2: each rung measured
    # by the probe's own trial (ms a step over its last two steps)
    cfg3 = copy.deepcopy(plan["3D"])
    n = memory.TRIAL_STEPS
    meas = {}
    for rung, (remat, policy) in REMAT_RUNGS.items():
        kernel_table.reset()
        t = memory.trial_ae_step(cfg3, 2, remat, policy)
        counts = kernel_table.launches()
        per = ae_launches(cfg3, True, remat)
        meas[rung] = dict(t, per_step={k: v // n for k, v in counts.items()})
        log(f"[plan] {gpu}: 3D AE step, batch 2, adversarial loss, remat {rung}: peak reserved "
            f"{t['reserved'] / 2**30:.3f} GiB, allocated {t['allocated'] / 2**30:.3f} GiB, "
            f"{t['ms']:.3f} ms a step; launches a step {meas[rung]['per_step']}, predicted "
            f"{per}")
        if counts != {k: v * n for k, v in per.items()}:
            raise AssertionError(f"remat {rung}: launches {counts} != {n} x {per}")
    peak = {r: m["reserved"] for r, m in meas.items()}
    acts_saves = peak["none"] - peak["acts"] > 0.02 * peak["none"]
    if not peak["full"] < 0.98 * min(peak["none"], peak["acts"]):
        raise AssertionError(f"full remat saves nothing: {peak}")
    policy = "acts" if acts_saves else "full"
    picks = []
    if acts_saves:
        picks.append(((peak["none"] + peak["acts"]) // 2, (2, 1, True, "acts")))
    else:
        log(f"[plan] {gpu}: remat 'acts' saves {(peak['none'] - peak['acts']) / 2**30:.3f} GiB "
            f"of {peak['none'] / 2**30:.3f}: less than 2%, so only 'full' is held")
    picks.append(((peak["full"] + min(peak["none"], peak["acts"])) // 2, (2, 1, True, "full")))
    for b, want in picks:
        got = tuple(memory.auto_select_hyperparams(cfg3, "3d", init_batch_size=2, budget_bytes=b))
        log(f"[plan] {gpu}: ladder at a budget of {b / 2**30:.3f} GiB picks {got} (want {want})")
        if got != want:
            raise AssertionError(f"ladder at {b} bytes picked {got}, want {want}")

    # ---- remat against no remat: one step from the same weights and draws
    dev = torch.device("cuda")
    initial = compute_initial_patch_size(cfg3["ae_transformations"])
    x = torch.rand((2, *initial, 1), generator=torch.Generator(device=dev).manual_seed(41),
                   device=dev)
    draws, runs = None, []
    for rung in ("none", "none", "acts", "full"):  # no remat twice: the noise floor
        remat, pol = REMAT_RUNGS[rung]
        c = copy.deepcopy(cfg3)
        c["vae_params"].update(use_checkpointing=remat, remat_policy=pol)
        tr = AutoEncoderTrainer.from_config(c, "vae", device=dev, dtype=torch.bfloat16, seed=0)
        randomize_(tr.model, 5321)
        randomize_(tr.discriminator, 5322)
        if draws is None:
            draws = tr.make_draws(x, generator=torch.Generator(device=dev).manual_seed(42),
                                  host_generator=torch.Generator().manual_seed(43))
        grads = {}
        _capture_grads(tr.g_opt, grads, "g")
        _capture_grads(tr.d_opt, grads, "d")
        m = tr.train_step(x, True, draws=draws)
        runs.append((rung, {k: m[k].item() for k in METRICS}, grads))
        del tr, grads, m
        torch.cuda.empty_cache()
    _, ref_l, ref_g = runs[0]
    for rung, losses, grads in runs[1:]:
        l_err = max(abs(losses[k] - ref_l[k]) / max(abs(ref_l[k]), 1e-30) for k in METRICS)
        ok, worst = l_err <= PLAN_LOSS_TOL, {}
        for net in ("g", "d"):
            errs = [within(a, b, PLAN_GRAD_TOL, PLAN_GRAD_TOL) for a, b in zip(grads[net],
                                                                              ref_g[net])]
            ok &= all(e[0] for e in errs) and len(errs) == len(ref_g[net])
            worst[net] = max(_err(a, b) / max(b.abs().max().item(), 1e-30)
                             for a, b in zip(grads[net], ref_g[net]))
        log(f"[plan] {gpu}: one flagship AE step, remat {rung} vs no remat: losses "
            f"{({k: round(v, 6) for k, v in losses.items()})} max rel_err {l_err:.3e} (tol "
            f"{PLAN_LOSS_TOL:g}); max |g - g_ref| / max|g_ref| generator {worst['g']:.3e}, "
            f"discriminator {worst['d']:.3e} (elementwise tol {PLAN_GRAD_TOL:g} |g_ref| + "
            f"{PLAN_GRAD_TOL:g} max|g_ref|)")
        if not ok:
            raise AssertionError(f"remat {rung}: losses or gradients differ from no remat")
    del runs, ref_g, x
    torch.cuda.empty_cache()

    # ---- medimgen_torch_train_autoencoder on the plan, under remat
    argv = ["097", "train-val-test", "3d", "--set", "n_epochs=1", "--set",
            "autoencoder_warm_up_epochs=0", "--set", "vae_params.use_checkpointing=true",
            "--set", f"vae_params.remat_policy={policy}"]
    loaders = functools.partial(loader_mod.get_data_loaders, train_steps=PLAN_TRAIN_STEPS,
                                val_steps=PLAN_VAL_STEPS)
    kernel_table.reset()
    t0 = time.perf_counter()
    with mock.patch.object(train_autoencoder, "get_data_loaders", loaders):
        tr = _run_main(train_autoencoder.run_cli, argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, st, ld = kernel_table.launches(), tr.epoch_stats[0], tr.loss_dict
    n_fwd = sum(isinstance(m, GroupNorm) for m in tr.model.modules())
    per = ae_launches(cfg3, True, True)
    expect = {k: st["steps"] * v + st["val_steps"] * (n_fwd if k in ("gn_stats_fold",
                                                                     "gn_affine_act") else 0)
              for k, v in per.items()}
    log(f"[plan] {gpu}: medimgen_torch_train_autoencoder 097 3d on the plan, "
        f"use_checkpointing true, remat_policy {policy}: {st['steps']} train + "
        f"{st['val_steps']} val steps at batch {tr.config['ae_batch_size']}, CLI ms a train "
        f"step {st['train_s'] * 1e3 / st['steps']:.3f}, launches {counts}, predicted {expect}; "
        f"loss_dict {ld}; saved {st['saved']}; run {run_s:.1f} s")
    finite = all(math.isfinite(v) for k in ld for v in ld[k])
    if (counts != expect or not finite or tr.model.encoder.remat != policy
            or (st["steps"], st["val_steps"]) != (PLAN_TRAIN_STEPS, PLAN_VAL_STEPS)
            or sorted(st["saved"]) != ["best_model", "last_model"] or not ld["disc"][0] > 0):
        raise AssertionError(f"AE CLI on the plan: launches {counts} != {expect}, or {st}")
    del tr
    torch.cuda.empty_cache()
    log(f"[plan] {gpu}: phase {time.perf_counter() - t_phase:.1f} s")
    return {r: m["per_step"] for r, m in meas.items()}


# ------------------------------------------------------------------ slice 11

FLASH_SEEN = set()     # ("fwd" | "bwd", q's (B, Sq, H, D), Sk) of every flash call on the card
FLASH_CHECKED = set()  # the same, for the shapes a phase held against the plain versions
_FLASH_CAPTURES = []   # open flash_capture sets


def install_flash_recorder():
    """Record q's (B, Sq, H, D) and the keys' length Sk of every flash
    forward and backward that runs on the card, in FLASH_SEEN (and in any
    open ``flash_capture`` set): a context of another length counts as a
    shape of its own."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    fwd, bwd = fa._fwd, fa.flash_attention_bwd

    def note(kind, q, k):
        if q.is_cuda:
            for s in [FLASH_SEEN, *_FLASH_CAPTURES]:
                s.add((kind, tuple(q.shape), k.shape[1]))

    def rec_fwd(q, k, v, scale):
        note("fwd", q, k)
        return fwd(q, k, v, scale)

    def rec_bwd(q, k, v, o, lse, do, scale):
        note("bwd", q, k)
        return bwd(q, k, v, o, lse, do, scale)

    fa._fwd, fa.flash_attention_bwd = rec_fwd, rec_bwd


@contextlib.contextmanager
def flash_capture():
    """Yields the set of flash (kind, q shape, Sk) that run on the card inside."""
    seen = set()
    _FLASH_CAPTURES.append(seen)
    try:
        yield seen
    finally:
        _FLASH_CAPTURES.remove(seen)


def flash_checked(kind, shapes, sk=None):
    """Mark q shapes as held against the plain versions, with keys of Sk
    tokens (default: each shape's own length)."""
    FLASH_CHECKED.update((kind, tuple(s), s[1] if sk is None else sk) for s in shapes)


def check_flash_listed():
    """Raise if a flash forward or backward ran at a shape that no kernel
    phase held against its plain version."""
    missing = FLASH_SEEN - FLASH_CHECKED
    if missing:
        raise AssertionError(f"flash calls at shapes no kernel phase checked: {sorted(missing)}")
    log(f"[env] every flash call ran at a checked shape: {len(FLASH_SEEN)} (kind, q shape, "
        f"Sk) seen, {len(FLASH_CHECKED)} checked")


@contextlib.contextmanager
def gn_recorder():
    """Yields the set of (B, M, C, groups) of every port GroupNorm call
    inside (a global forward pre-hook; a rematerialised call counts again)."""
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm

    seen = set()

    def hook(mod, args):
        if isinstance(mod, GroupNorm):
            x = args[0]
            seen.add((x.shape[0], math.prod(x.shape[2:]), x.shape[1], mod.num_groups))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


DDPM_STEPS = {3: 2, 2: 4}  # timed steps after the ladder's step at the chosen batch
DDPM_SAMPLE_BATCHES = {3: (1,), 2: (16, 4)}  # the interval samples, the sampling CLI's -n 4
DDPM_CLI_STEPS = {3: (2, 1), 2: (6, 2)}  # train / val steps of the DDPM CLI epochs
DDPM_CLI_DDIM = 10  # DDIM steps of the 2D sampling CLI (the 3D one takes 2)
DDPM_F32_MAX = 2**31  # elements: the fp32 checks of larger GroupNorms are left out
GN_REF_CHUNK = 2**27  # elements a chunk of the GroupNorm plain references (_gn_case)


def _oom_bytes(msg):
    """The bytes an out-of-memory error says it tried to allocate."""
    import re

    m = re.search(r"Tried to allocate ([0-9.]+) (GiB|MiB|KiB|B)", msg)
    if not m:
        return None
    return float(m.group(1)) * {"GiB": 2**30, "MiB": 2**20, "KiB": 2**10, "B": 1}[m.group(2)]


def _ddpm_trial(tr, batch, remat):
    """One DDPM train step at ``batch`` with the U-Net's remat on or off:
    {fits, ms, peak allocated / reserved GiB} or, on out of memory, {fits:
    False, asked bytes, allocated GiB at the failure}. Nothing else is
    caught."""
    import gc

    tr.unet.remat = "full" if remat else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"batch": int(batch.shape[0]), "remat": bool(remat)}
    try:
        loss = tr.train_step(batch)
        torch.cuda.synchronize()
        out.update(fits=True, ms=(time.perf_counter() - t0) * 1e3, loss=float(loss),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
    except torch.cuda.OutOfMemoryError as e:
        out.update(fits=False, asked=_oom_bytes(str(e)),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   secs=time.perf_counter() - t0)
    for p in tr.params:
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    return out


def module_bounds(nets, fn):
    """fn() with hooks on the GroupNorms and attention blocks of ``nets``:
    returns {kernel: summed bound ms} of the launches fn makes (a forward
    kernel's bound a call, so a recomputed GroupNorm counts twice; a
    backward kernel's once a module that ran under autograd) and the
    GroupNorm (B, M, C, groups) it met."""
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.models.diffusion_unet import CrossAttention

    seen, grads = [], {}

    def hook(mod, args):
        x = args[0]
        # attention as (B, C, tokens...): a CrossAttention's x is (B, S, C)
        shape = (x.shape[0], x.shape[2], x.shape[1]) if isinstance(mod, CrossAttention) \
            else tuple(x.shape)
        seen.append((mod, shape, x.element_size()))
        if torch.is_grad_enabled() and x.requires_grad:
            grads[id(mod)] = (mod, shape, x.element_size())

    handles = [m.register_forward_pre_hook(hook) for net in nets for m in net.modules()
               if isinstance(m, (GroupNorm, AttentionBlock, CrossAttention))]
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    ms = dict.fromkeys(kernel_table.KERNELS, 0.0)
    for calls, grad in ((seen, False), (grads.values(), True)):
        for mod, shape, isz in calls:
            B, C, M = shape[0], shape[1], math.prod(shape[2:])
            if isinstance(mod, GroupNorm):
                for k, v in gn_bounds_ms(shape, isz, grad).items():
                    if grad == k.startswith("gn_bwd"):
                        ms[k] += v
            else:
                fl, n, bhs = B * mod.num_heads * M * M * mod.head_dim, B * M * C, B * M
                dt = torch.bfloat16 if isz == 2 else torch.float32
                nar = "_narrow" if fa.takes_narrow(dt, mod.head_dim) else ""  # the design run
                if not grad:
                    ms["flash_attn_fwd" + nar] += bound(4 * fl, 4 * n * isz + 4 * bhs,
                                                        PEAK_BF16_FLOPS)[0]
                else:
                    ms["flash_attn_bwd_dq" + nar] += bound(6 * fl, 6 * n * isz + 8 * bhs,
                                                           PEAK_BF16_FLOPS)[0]
                    ms["flash_attn_bwd_dkdv" + nar] += bound(8 * fl, 6 * n * isz + 8 * bhs,
                                                             PEAK_BF16_FLOPS)[0]
    shapes = {(sh[0], math.prod(sh[2:]), sh[1], m.num_groups) for m, sh, _ in seen
              if isinstance(m, GroupNorm)}
    return ms, shapes


def _conv_kernels(conv, x):
    """The device kernels of one forward + backward of ``conv`` on ``x``
    (input and weight gradients): [(ms, name)] by time, and their sum."""
    from torch.profiler import ProfilerActivity, profile

    x = x.detach().requires_grad_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = conv(x)
        torch.autograd.grad(y, [x, *conv.parameters()], torch.ones_like(y))
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(((ms, n[:80]) for n, ms in by.items()), reverse=True)
    return top[:4], sum(by.values())


def phase_ddpm_train():
    """The pixel-space DDPM step at the planner's 3D and 2D flagship widths
    (see the module docstring). Returns {3: .., 2: ..} with the planner's
    trials, the batch and remat that ran, ms a step, launches a step and a
    sampling forward, each kernel's device ms / bound a step, and the flash
    and GroupNorm shapes the step and the sampling forwards met."""
    from medical_image_generation_tpu_torch.config.run import filter_config_by_mode
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.blocks import (
        AttentionBlock,
        GroupNorm,
        ResBlock,
        to_internal,
    )
    from medical_image_generation_tpu_torch.training.train_ddpm import DDPMTrainer

    torch.backends.cudnn.allow_tf32 = True
    dev, gpu = torch.device("cuda"), card()
    out = {}
    for sd in (3, 2):
        t_dim = time.perf_counter()
        cfg = filter_config_by_mode(_train_config(False, spatial_dims=sd), "train_ddpm")
        cfg["ddpm_params"]["use_checkpointing"] = False
        tr = DDPMTrainer.from_config(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        randomize_(tr.unet, 7100 + sd)
        n_u = sum(p.numel() for p in tr.params)
        initial = tuple(compute_initial_patch_size(cfg["ddpm_transformations"]))
        plan_b = int(cfg["ddpm_batch_size"])
        gen = torch.Generator(device=dev).manual_seed(7200 + sd)

        def count(cls):
            return sum(isinstance(m, cls) for m in tr.unet.modules())

        attn, gn_u, n_res = count(AttentionBlock), count(GroupNorm), count(ResBlock)
        log(f"[ddpm_train] {gpu}: {sd}D pixel DDPM U-Net {cfg['ddpm_params']['num_channels']} "
            f"strides {cfg['ddpm_params']['strides']} in/out channels 1, params={n_u:,} (fp32 "
            f"masters, bf16); {attn} attention, {gn_u} GroupNorm, {n_res} ResBlocks; schedule "
            f"{cfg['time_scheduler_params']['schedule']} {cfg['time_scheduler_params']['beta_start']}"
            f" -> {cfg['time_scheduler_params']['beta_end']}; loader patch {initial} -> crop "
            f"{tr.aug_cfg.crop_to}; planner batch {plan_b}")
        trials = []
        with flash_capture() as flash_t:  # the attention a trial ran before running out
            for remat in (False, True):  # the planner's batch, without and with remat
                trials.append(_ddpm_trial(tr, torch.rand((plan_b, *initial, 1), generator=gen,
                                                         device=dev), remat))
            chosen = next((t for t in trials if t["fits"]), None)
            b = plan_b // 2
            while chosen is None and b >= 1:
                for remat in (False, True):
                    trials.append(_ddpm_trial(tr, torch.rand((b, *initial, 1), generator=gen,
                                                             device=dev), remat))
                    if trials[-1]["fits"]:
                        chosen = trials[-1]
                        break
                b //= 2
        for t in trials:
            what = (f"fits: {t['ms']:.1f} ms, peak allocated {t['peak_gib']:.2f} GiB (reserved "
                    f"{t['reserved_gib']:.2f})" if t["fits"] else
                    f"out of memory asking {t['asked'] / 2**30:.2f} GiB with "
                    f"{t['peak_gib']:.2f} GiB allocated (after {t['secs']:.1f} s)")
            log(f"[ddpm_train] {gpu}: {sd}D batch {t['batch']} "
                f"{'with' if t['remat'] else 'without'} use_checkpointing: {what}")
        if chosen is None:
            raise AssertionError(f"{sd}D DDPM: no batch fits: {trials}")
        B, remat = chosen["batch"], chosen["remat"]
        tr.unet.remat = "full" if remat else None
        batch = torch.rand((B, *initial, 1), generator=gen, device=dev)
        steps = DDPM_STEPS[sd]
        per_step = launches(flash_attn_fwd=attn, flash_attn_bwd_dq=attn,
                            flash_attn_bwd_dkdv=attn,
                            gn_stats_fold=gn_u + (2 * n_res if remat else 0),
                            gn_affine_act=gn_u + (2 * n_res if remat else 0),
                            gn_bwd_stats=gn_u, gn_bwd_apply=gn_u, **opt_launches(tr.opt))
        with flash_capture() as flash:
            ms, peak, counts, losses = _timed_steps(lambda: tr.train_step(batch), 0, steps)
            losses = [float(v) for v in losses]
            expect = {k: v * steps for k, v in per_step.items()}
            if counts != expect or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{sd}D DDPM step: launches {counts} != {expect}, or "
                                     f"losses {losses}")
            res = []
            busy, shares = profile_breakdown(
                f"{sd}D DDPM step, batch {B}, remat {remat}",
                lambda: res.append(module_bounds([tr.unet], lambda: tr.train_step(batch))),
                time_host=False)
            prof = profile_breakdown.last
            bounds, gn_shapes = res[0]
            bounds.update(opt_bounds(tr.opt))
        log(f"[ddpm_train] {gpu}: {sd}D step at batch {B} (the largest that fits; "
            f"use_checkpointing {remat}): {ms:.1f} ms a step over {steps} steps, device busy "
            f"{busy:.1f} ms, idle share {prof['idle_share']:.4f} (profiler), peak allocated "
            f"{peak:.2f} GiB; launches {counts}, predicted {expect}; losses {losses}")
        for name in per_step:
            log(f"[ddpm_train] {gpu}: {sd}D per step: {name} device ms={shares[name]:.3f} "
                f"bound ms={bounds[name]:.3f} ({per_step[name]} launches)")
        x_in = to_internal(torch.rand((B, *tr.image_shape), generator=gen, device=dev)
                           .to(torch.bfloat16))
        h_in = torch.randn((B, tr.unet.ConvND_1.Conv_0.in_channels, *tr.image_shape[:-1]),
                           generator=gen, device=dev, dtype=torch.bfloat16).contiguous(
                               memory_format=torch.channels_last_3d if sd == 3
                               else torch.channels_last)
        convs = {}
        for name, conv, inp in (("ConvND_0 (1 -> 256)", tr.unet.ConvND_0, x_in),
                                ("ConvND_1 (256 -> 1)", tr.unet.ConvND_1, h_in)):
            top, total = _conv_kernels(conv, inp)
            convs[name] = total
            log(f"[ddpm_train] {gpu}: {sd}D {name} forward + backward at batch {B}: "
                f"{total:.3f} device ms; kernels " + "; ".join(f"{n} {t:.3f} ms" for t, n in top))
        del x_in, h_in
        samples = {}
        with flash_capture() as flash_s, gn_recorder() as gn_s, torch.no_grad(), \
                tr.sampling_weights() as unet:
            for n in DDPM_SAMPLE_BATCHES[sd]:
                x = torch.randn((n, *tr.image_shape), generator=gen, device=dev)
                t = torch.full((n,), 500, device=dev, dtype=torch.long)
                unet(x, t)
                kernel_table.reset()
                fwd_ms = time_ms(lambda: unet(x, t), 0, 1)
                samples[n] = {"ms": fwd_ms, "counts": kernel_table.launches()}
                log(f"[ddpm_train] {gpu}: {sd}D sampling forward at batch {n}: {fwd_ms:.1f} ms "
                    f"(a 50-step DDIM trajectory ~{50 * fwd_ms / 1e3:.1f} s); launches "
                    f"{samples[n]['counts']}")
                if samples[n]["counts"]["flash_attn_fwd"] != attn or \
                        samples[n]["counts"]["gn_stats_fold"] != gn_u:
                    raise AssertionError(f"{sd}D sampling forward launches {samples[n]}")
        out[sd] = dict(n_params=n_u, plan_batch=plan_b, trials=trials, batch=B, remat=remat,
                       ms=ms, busy=busy, idle=prof["idle_share"], peak=peak, per_step=per_step,
                       step={k: (shares[k], bounds[k]) for k in bounds}, samples=samples,
                       flash=flash | flash_s, flash_trials=flash_t - flash - flash_s,
                       gn=gn_shapes | gn_s, convs=convs, losses=losses)
        log(f"[ddpm_train] {gpu}: {sd}D done in {time.perf_counter() - t_dim:.1f} s")
        del tr, batch, unet, x
        torch.cuda.empty_cache()
    return out


def _ref_tiles(S, gen, tile=64):
    """Index rows of the first, middle and last ``tile`` rows of S, and of
    one seeded tile."""
    starts = {0, (S // 2 // tile) * tile, S - tile,
              int(torch.randint(0, S // tile, (1,), generator=gen)) * tile}
    return torch.cat([torch.arange(s, s + tile) for s in sorted(starts)]).cuda()


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION")  # no S x S math


def sdpa_ms(q, k, v, scale, iters, do=None):
    """ms of PyTorch's SDPA on BSHD q, k, v (its memory-efficient, flash or
    cuDNN backend), forward alone, or with ``do`` forward + backward; None
    where no such backend takes the shape. The library yardstick: the port
    never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    grad = do is not None
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(grad) for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous() if grad else None

    def call():
        o = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        return torch.autograd.grad(o, (qh, kh, vh), doh) if grad else o

    try:
        with sdpa_kernel([getattr(SDPBackend, b) for b in SDPA_BACKENDS]):
            return time_ms(call, *iters)
    except RuntimeError as e:  # no memory-efficient backend takes the shape
        log(f"[sdpa] no library call at {tuple(q.shape)} Sk={k.shape[1]}"
            f"{' (backward)' if grad else ''}: {str(e)[:120]}")
        return None


def _flash_ddpm_case(B, S, H, D, dt, gen, cpu_gen, backward, timed=True,
                     label="kernels_ddpm"):
    """One DDPM flash shape against the chunked plain references: the lse
    over every query and key, o and dQ at four query tiles, dK / dV at four
    key tiles summed over every query, delta over every row; same bits
    twice. With ``timed``, bf16 ms and SDPA's beside them (its backward as
    fwd+bwd minus fwd; one warm and one timed call at 262144 tokens).
    Returns ({kernel: record} in bf16, log line)."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    scale = D ** -0.5
    rows, keys = _ref_tiles(S, cpu_gen), _ref_tiles(S, cpu_gen)
    o, lse = fa.flash_attention(q, k, v, scale)
    o2, lse2 = fa.flash_attention(q, k, v, scale)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    del o2, lse2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lse_ref = fa.flash_lse_plain_chunked(q, k, scale)
    o_ref, lse_ref_r = fa.flash_attention_plain(q[:, rows], k, v, scale)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    o_ok, l_ok, err, lerr = flash_close(o[:, rows], lse, o_ref, lse_ref, dt)
    # a dropped 32-key tile moves the lse by ~32 / S: held only where that is over LSE_TOL
    o_cut, lse_cut = fa.flash_attention_plain(q[:, rows], k[:, FLASH_TILE:], v[:, FLASH_TILE:],
                                              scale)
    cut_seen = not any(flash_close(o_cut, lse_cut, o_ref, lse_ref_r, dt)[:2])
    cut_held = FLASH_TILE / S > 2 * LSE_TOL
    ok = o_ok and l_ok and same and (cut_seen or not cut_held)
    fl, n, bhs = B * H * S * S * D, B * S * H * D, B * H * S
    isz = q.element_size()
    line = (f"B={B} S={S} H={H} D={D} {str(dt)[6:]}: fwd max|o-plain|={err:.3e} (4 query "
            f"tiles) max|lse-plain|={lerr:.3e} (every row; mean lse {lse.mean().item():.3f}) "
            f"bit-identical on a rerun={same} one-tile-skip caught={cut_seen}"
            f"{'' if cut_held else ' (not held: under LSE_TOL at this length)'}; chunked "
            f"plain reference {plain_s:.1f} s")
    rec = {}
    big = fl > 1e13
    iters = (0, 1) if big else (1, 3)
    timed = timed and dt == torch.bfloat16
    if timed:
        ms = time_ms(lambda: fa.flash_attention(q, k, v, scale), *iters)
        lib = sdpa_ms(q, k, v, scale, iters)
        b_ = bound(4 * fl, 4 * n * isz + 4 * bhs, PEAK_BF16_FLOPS)
        rec["flash_attn_fwd"] = dict(shape=[B, S, H, D], dtype="bf16", max_abs_err=err, ms=ms,
                                     plain_ms=plain_s * 1e3, bound_ms=b_[0], bound_by=b_[1],
                                     library_ms=lib)
        line += (f" | ms={ms:.3f} bound_ms={b_[0]:.3f} ({b_[1]}) SDPA (memory-efficient) "
                 f"ms={'no library call at this shape' if lib is None else f'{lib:.3f}'}")
    if backward:
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse_ref, do, scale)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
        dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, lse_ref, do, scale)
        dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
        same_b = all(torch.equal(a, b) for a, b in ((dq, dq2), (delta, delta2), (dk, dk2),
                                                   (dv, dv2)))
        del dq2, delta2, dk2, dv2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, S)
        lse_rows = lse_ref.reshape(B, H, S)[:, :, rows].reshape(B * H, len(rows))
        r_dq, _ = fa.flash_bwd_dq_plain(q[:, rows], k, v, o[:, rows], lse_rows, do[:, rows],
                                        scale)
        r_dk, r_dv = fa.flash_bwd_dkdv_plain_chunked(q, k, v, do, lse_ref, r_delta, scale, keys)
        torch.cuda.synchronize()
        plain_b = time.perf_counter() - t0
        res = {nm: within(g, r, *FLASH_BWD_TOL[dt])
               for nm, g, r in (("dq", dq[:, rows], r_dq), ("dk", dk[:, keys], r_dk),
                                ("dv", dv[:, keys], r_dv))}
        d_ok, d_err, _ = within(delta, r_delta, 1e-5, 1e-5)
        ok = ok and all(x[0] for x in res.values()) and d_ok and same_b
        line += (" | bwd " + " ".join(f"max|{nm}-plain|={x[1]:.3e}" for nm, x in res.items())
                 + f" (4 query / key tiles) max|delta-plain|={d_err:.3e} bit-identical on a "
                 f"rerun={same_b}; chunked plain reference {plain_b:.1f} s")
        if timed:
            ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse_ref, do, scale), *iters)
            ms_kv = time_ms(lambda: fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale),
                            *iters)
            b_dq = bound(6 * fl, 6 * n * isz + 8 * bhs, PEAK_BF16_FLOPS)
            b_kv = bound(8 * fl, 6 * n * isz + 8 * bhs, PEAK_BF16_FLOPS)
            both = None if lib is None else sdpa_ms(q, k, v, scale, (1, 1) if big else (1, 3),
                                                    do)
            lib_b = None if both is None else both - lib
            for name, t_ms, b_, e in (("flash_attn_bwd_dq", ms_dq, b_dq, res["dq"][1]),
                                      ("flash_attn_bwd_dkdv", ms_kv, b_kv,
                                       max(res["dk"][1], res["dv"][1]))):
                rec[name] = dict(shape=[B, S, H, D], dtype="bf16", max_abs_err=e, ms=t_ms,
                                 plain_ms=plain_b * 1e3, bound_ms=b_[0], bound_by=b_[1],
                                 library_ms=lib_b)
            line += (f" | dq ms={ms_dq:.3f} bound_ms={b_dq[0]:.3f} | dkdv ms={ms_kv:.3f} "
                     f"bound_ms={b_kv[0]:.3f} | SDPA backward ms="
                     + ("no library call at this shape" if lib_b is None else
                        f"{lib_b:.3f} (fwd+bwd {both:.3f} minus fwd {lib:.3f})")
                     + (" (one timed call after one warm call)" if big else ""))
    if not ok:
        raise AssertionError(f"[{label}] flash kernels disagree with their plain versions: "
                             f"{line}")
    return rec, line


def _rows_max(fn, M, rows):
    """max over row chunks [r, r + rows) of fn(slice) (a tuple of floats,
    each maxed)."""
    acc = None
    for r in range(0, M, rows):
        v = fn(slice(r, r + rows))
        acc = v if acc is None else tuple(max(a, b) for a, b in zip(acc, v))
    return acc


def _gn_case(B, M, C, G, dt, gen, label):
    """The four GroupNorm kernels at one (B, M, C, groups) against their
    plain versions computed a chunk of rows at a time (the same math; the
    whole fp32 copies of a (2, 2097152, 768) activation would not fit beside
    it): 16-byte loads, same bits twice. Returns ({kernel: (ms, bound ms)}
    in bf16, log line)."""
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    x = torch.randn((B, M, C), generator=gen, device="cuda", dtype=dt) * 1.3 + 0.7
    g = torch.randn((B, M, C), generator=gen, device="cuda", dtype=dt)
    w = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    b = 0.1 * torch.randn(C, generator=gen, device="cuda")
    rows = max(1, GN_REF_CHUNK // (B * C))
    vec0 = _vector_launches()
    st, A, bb = gn.stats_fold(x, w, b, G, 1e-6)
    same = all(torch.equal(u, v) for u, v in zip((st, A, bb), gn.stats_fold(x, w, b, G, 1e-6)))
    st_ref = sum(gn.channel_stats_plain(x[:, r:r + rows]) for r in range(0, M, rows))
    rA, rbb = gn.fold_affine_plain(st_ref, w, b, G, M, 1e-6)
    srel = _err(st, st_ref) / st_ref.abs().max().item()
    ferr = max(_err(A, rA) / rA.abs().max().item(), _err(bb, rbb) / rbb.abs().max().item())
    ok = srel <= STATS_REL_TOL and ferr <= FOLD_REL_TOL
    rtol, atol = AFFINE_TOL[dt]
    aerr, xerr, prel = 0.0, 0.0, 0.0
    for silu in (False, True):
        y = gn.affine_act(x, A, bb, silu)

        def affine_cmp(sl):
            r = gn.affine_act_plain(x[:, sl], A, bb, silu).float()
            d = (y[:, sl].float() - r).abs()
            return d.max().item(), (d - (atol + rtol * r.abs())).max().item()

        e, over = _rows_max(affine_cmp, M, rows)
        aerr = max(aerr, e)
        ok = ok and over <= 0
        del y
        coef, ds, db = gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, silu)
        dx = gn.gn_bwd_apply(x, g, A, bb, coef, silu)
        again = gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, silu)
        same = same and all(torch.equal(u, v) for u, v in zip((coef, ds, db), again))
        same = same and torch.equal(dx, gn.gn_bwd_apply(x, g, A, bb, again[0], silu))
        sums = [gn.gn_bwd_sums_plain(x[:, r:r + rows], g[:, r:r + rows], A, bb, silu)
                for r in range(0, M, rows)]
        r_coef, r_ds, r_db = gn.gn_bwd_fold_plain(sum(s[0] for s in sums),
                                                  sum(s[1] for s in sums), st, w, G, 1e-6, M)
        rt, at = GN_BWD_TOL[dt]

        def dx_cmp(sl):
            r = gn.gn_bwd_apply_plain(x[:, sl], g[:, sl], A, bb, r_coef, silu).float()
            d = (dx[:, sl].float() - r).abs()
            return d.max().item(), (d - rt * r.abs()).max().item(), r.abs().max().item()

        e, over, rmax = _rows_max(dx_cmp, M, rows)
        xerr = max(xerr, e)
        p = max(_err(t_, r_) / r_.abs().max().item()
                for t_, r_ in ((coef, r_coef), (ds, r_ds), (db, r_db)))
        prel = max(prel, p)
        ok = ok and over <= at * rmax and p <= GN_PARAM_GRAD_TOL
        del dx
    vec = [n - vec0[k] for k, n in _vector_launches().items()]
    vec_ok = vec == [2, 4, 4]
    torch.cuda.synchronize()
    line = (f"B={B} M={M} C={C} G={G} {str(dt)[6:]}: stats rel_err={srel:.3e} A/b rel_err="
            f"{ferr:.3e} affine max_abs_err={aerr:.3e} bwd dx max_abs_err={xerr:.3e} "
            f"coef/dscale/dbias rel_err={prel:.3e} 16-byte loads={vec_ok} bit-identical on a "
            f"rerun={same}")
    if not (ok and same and vec_ok):
        raise AssertionError(f"[{label}] GroupNorm kernels disagree: {line}")
    times = {}
    if dt == torch.bfloat16:
        bounds = gn_bounds_ms((B, C, M), x.element_size(), True)
        times = {
            "gn_stats_fold": time_ms(lambda: gn.stats_fold(x, w, b, G, 1e-6), 1, 3),
            "gn_affine_act": time_ms(lambda: gn.affine_act(x, A, bb, True), 1, 3),
            "gn_bwd_stats": time_ms(lambda: gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, True),
                                    1, 3),
            "gn_bwd_apply": time_ms(lambda: gn.gn_bwd_apply(x, g, A, bb, coef, True), 1, 3)}
        times = {k: (v, bounds[k]) for k, v in times.items()}
        line += " | ms / bound ms " + " ".join(f"{k[3:]}={v[0]:.4f}/{v[1]:.4f}"
                                                 for k, v in times.items())
    return times, line


def phase_kernels_ddpm(ddpm):
    """Every port kernel against its plain version at every flash and
    GroupNorm shape phase ddpm_train's steps and sampling forwards met (the
    DDPM CLIs run the same batches): bf16 and fp32, same bits twice, but no
    fp32 flash at 262144 tokens (the parity path's scalar fp32 kernels run
    at a fiftieth of the bf16 rate: minutes a pass there) and no fp32
    GroupNorm over DDPM_F32_MAX elements. Returns {kernel: [{shape, ms,
    bound_ms}]} (bf16)."""
    gpu = card()
    gen = torch.Generator(device="cuda").manual_seed(31)
    cpu_gen = torch.Generator().manual_seed(32)
    out = {}
    t0 = time.perf_counter()
    path = set().union(*(d["flash"] for d in ddpm.values()))
    flash = path | set().union(*(d["flash_trials"] for d in ddpm.values()))
    if any(sk != s[1] for _, s, sk in flash):
        raise AssertionError(f"[kernels_ddpm] a DDPM attention with a context: {flash}")
    shapes = sorted({s for _, s, _ in flash}, key=lambda s: -s[0] * s[1] * s[1] * s[3])
    for shape in shapes:
        backward = ("bwd", shape, shape[1]) in flash
        on_path = ("fwd", shape, shape[1]) in path
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and (shape[1] > 65536 or not on_path):
                log(f"[kernels_ddpm] {gpu}: flash {shape} fp32 not checked ("
                    + ("scalar fp32 kernels: see the fp32 ms at 32768 tokens)" if on_path else
                       "met only by a bf16 trial that ran out of memory)"))
                continue
            t1 = time.perf_counter()
            rec, line = _flash_ddpm_case(*shape, dt, gen, cpu_gen, backward, on_path)
            log(f"[kernels_ddpm] {gpu}: flash {line} OK ({time.perf_counter() - t1:.1f} s)")
            for name, r in rec.items():
                out.setdefault(name, []).append(r)
            torch.cuda.empty_cache()
        flash_checked("fwd", [shape])
        if backward:
            flash_checked("bwd", [shape])
    gn_shapes = sorted(set().union(*(d["gn"] for d in ddpm.values())),
                       key=lambda s: -s[0] * s[1] * s[2])
    for shape in gn_shapes:
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and shape[0] * shape[1] * shape[2] > DDPM_F32_MAX:
                log(f"[kernels_ddpm] {gpu}: groupnorm {shape} fp32 not checked (over "
                    f"{DDPM_F32_MAX} elements)")
                continue
            times, line = _gn_case(*shape, dt, gen, "kernels_ddpm")
            log(f"[kernels_ddpm] {gpu}: groupnorm {line} OK")
            for name, (ms, b_ms) in times.items():
                out.setdefault(name, []).append(dict(shape=list(shape), ms=ms, bound_ms=b_ms))
            torch.cuda.empty_cache()
    DDPM_GN_CHECKED.update(gn_shapes)
    log(f"[kernels_ddpm] {gpu}: {len(shapes)} flash shapes and {len(gn_shapes)} GroupNorm "
        f"shapes agree; phase {time.perf_counter() - t0:.1f} s")
    return out


DDPM_GN_CHECKED = set()  # (B, M, C, groups) phase kernels_ddpm held


def _ddpm_yaml(root, task, key, remat):
    """Write ``use_checkpointing: remat`` into a dataset's ddpm_params (the
    port's --set refuses a key the planner's dict lacks)."""
    import yaml

    path = os.path.join(root, task, "medimgen_config.yaml")
    with open(path) as f:
        doc = yaml.safe_load(f)
    doc[key]["ddpm_params"]["use_checkpointing"] = bool(remat)
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)


def _ddpm_cli_prediction(info, steps, val_steps, samples):
    """Launches of one DDPM CLI epoch: ``steps`` train steps, ``val_steps``
    validation forwards and ``samples`` sampling forwards."""
    fwd = dict.fromkeys(kernel_table.KERNELS, 0)
    fwd.update(flash_attn_fwd=info["per_step"]["flash_attn_fwd"],
               gn_stats_fold=info["per_step"]["gn_bwd_stats"],
               gn_affine_act=info["per_step"]["gn_bwd_stats"])
    return {k: steps * info["per_step"][k] + (val_steps + samples) * fwd[k] for k in fwd}


def phase_ddpm_cli(ws, ddpm):
    """medimgen_torch_train_ddpm and medimgen_torch_sample_ddpm at the
    planner's 2D and 3D flagship widths (see the module docstring), at the
    batch and remat phase ddpm_train chose. Returns the launches of the 2D
    CLI's first epoch."""
    import functools
    from unittest import mock

    import numpy as np

    from medical_image_generation_tpu_torch.io import png
    from medical_image_generation_tpu_torch.io.nifti import load_nifti
    from medical_image_generation_tpu_torch.training import checkpoints as ckpt
    from medical_image_generation_tpu_torch.training import sample, train_ddpm

    t_phase = time.perf_counter()
    gpu = ws["gpu"]
    pre, res = os.environ["medimgen_preprocessed"], os.environ["medimgen_results"]
    shutil.rmtree(res, ignore_errors=True)  # the earlier CLI phases' runs are done
    log(f"[ddpm_cli] {gpu}: {shutil.disk_usage(pre).free / 1e9:.1f} GB free")
    out = {}
    for sd, task, dsid in ((2, "Task098_Synth2D", "098"), (3, "Task099_Synth", "099")):
        info = ddpm[sd]
        B, remat = info["batch"], info["remat"]
        steps, val_steps = DDPM_CLI_STEPS[sd]
        _ddpm_yaml(pre, task, f"{sd}D", remat)
        argv = [dsid, "train-val-test", f"{sd}d", "--set", f"ddpm_batch_size={B}"]
        first = ["--set", "n_epochs=1", "--set", f"val_plot_interval={1 if sd == 2 else 2}"]
        loaders = functools.partial(train_ddpm.get_data_loaders, train_steps=steps,
                                    val_steps=val_steps)
        with mock.patch.object(train_ddpm, "get_data_loaders", loaders), \
                gn_recorder() as gn_seen_cli:
            kernel_table.reset()
            t0 = time.perf_counter()
            tr = _run_main(train_ddpm.run_cli, argv + first)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = kernel_table.launches()
            st = tr.epoch_stats[0]
            n_samples = 50 if sd == 2 else 0
            expect = _ddpm_cli_prediction(info, steps, val_steps, n_samples)
            saved = sorted(st["saved"]["names"])
            log(f"[ddpm_cli] {gpu}: medimgen_torch_train_ddpm {sd}d at batch {B} "
                f"(use_checkpointing {remat}): {st['steps']} train + {st['val_steps']} val steps, "
                f"CLI ms a train step {st['train_s'] * 1e3 / st['steps']:.1f} (phase ddpm_train "
                f"{info['ms']:.1f}), val {st['val_s'] * 1e3 / st['val_steps']:.1f} ms a step, "
                f"loader wait {st['wait_s'] * 1e3 / st['steps']:.1f} ms a step; saved {saved} "
                f"(write {st['saved']['write_s']:.1f} s); run {run_s:.1f} s; launches {counts}, "
                f"predicted {expect}")
            if counts != expect or st["steps"] != steps or saved != ["best_model", "last_model"]:
                raise AssertionError(f"{sd}D DDPM CLI: launches {counts} != {expect}, or {st}")
            if sd == 2:
                grid = png.read_png(st["samples"])
                log(f"[ddpm_cli] {gpu}: interval grid {os.path.basename(st['samples'])} "
                    f"{grid.shape}: 16 samples at DDIM 50 in {st['sample_s']:.1f} s")
                if grid.shape != (4 * 256 + 6,) * 2:
                    raise AssertionError(f"2D DDPM interval grid {grid.shape}")
            ckdir, run_cfg = tr.save_dict["checkpoints"], os.path.join(tr.save_path,
                                                                        "config.yaml")
            best = os.path.join(ckdir, "best_model.pt")
            size = os.path.getsize(best)
            count1 = tr.opt.count
            del tr
            torch.cuda.empty_cache()

            if sd == 2:  # ---- -c to a second epoch
                payload = ckpt.load_checkpoint(os.path.join(ckdir, "last_model.pt"))
                restored = {}
                orig_restore = train_ddpm.DDPMTrainer._restore

                def checked_restore(self):
                    orig_restore(self)
                    restored["diff"] = _state_equal(self, payload)
                    restored["start"] = self.start_epoch
                    restored["loader"] = self.train_loader.state() == payload["train_loader"]

                train_ddpm.DDPMTrainer._restore = checked_restore
                try:
                    tr = _run_main(train_ddpm.run_cli, argv + [
                        "-c", "--set", "n_epochs=2", "--set", "val_plot_interval=3"])
                finally:
                    train_ddpm.DDPMTrainer._restore = orig_restore
                log(f"[ddpm_cli] {gpu}: resume -c: start epoch {restored.get('start')} "
                    f"(0-based), restored state equal to last_model.pt: "
                    f"{restored.get('diff') == []}, train loader's draws restored: "
                    f"{restored.get('loader')}; AdamW count {count1} -> {tr.opt.count}; "
                    f"loss_dict {tr.loss_dict}")
                if (restored.get("start") != 1 or restored.get("diff") != []
                        or not restored.get("loader") or tr.opt.count != 2 * count1
                        or len(tr.loss_dict["rec_loss"]) != 2):
                    raise AssertionError(f"DDPM resume failed: {restored}, count {tr.opt.count}")
                del tr, payload
                torch.cuda.empty_cache()

            # ---- medimgen_torch_sample_ddpm, read back
            smp = os.path.join(ws["root"], f"ddpm_samples_{sd}d")
            n = 4 if sd == 2 else 1
            ddim = DDPM_CLI_DDIM if sd == 2 else 2
            t0 = time.perf_counter()
            _run_main(sample.main_ddpm, [run_cfg, best, "-n", str(n), "--num_inference_steps",
                                         str(ddim), "-o", smp])
            names = sorted(os.listdir(smp))
            if sd == 2:
                imgs = [png.read_png(os.path.join(smp, f)) for f in names]
                ok = (names == [f"ddpm_sample_{i:03d}.png" for i in range(4)]
                      + ["ddpm_sample_grid.png"]
                      and all(i.shape == (256, 256) for i in imgs[:4])
                      and imgs[4].shape == (256, 4 * 256 + 6))
                shapes = [i.shape for i in imgs]
            else:
                vol = load_nifti(os.path.join(smp, names[0])).data
                ok = (names == ["ddpm_sample_000.nii.gz"] and vol.shape == (128, 128, 128)
                      and bool(np.isfinite(vol).all()) and vol.min() >= 0 and vol.max() <= 1)
                shapes = [vol.shape]
            log(f"[ddpm_cli] {gpu}: medimgen_torch_sample_ddpm {sd}d, {n} samples, {ddim} DDIM "
                f"steps from best_model.pt ({size / 1e9:.2f} GB): {names} {shapes} ok={ok} in "
                f"{time.perf_counter() - t0:.1f} s")
            if not ok:
                raise AssertionError(f"{sd}D DDPM sampling CLI wrote {names} {shapes}")
        out[sd] = counts
        missing = gn_seen_cli - DDPM_GN_CHECKED
        if missing:
            raise AssertionError(f"[ddpm_cli] GroupNorm shapes phase kernels_ddpm did not "
                                 f"check: {sorted(missing)}")
        shutil.rmtree(os.path.join(res, task), ignore_errors=True)
    log(f"[ddpm_cli] {gpu}: phase {time.perf_counter() - t_phase:.1f} s")
    return out


AUG_ALL = dict(aug_preset="nnunet", gaussian_noise=True, gaussian_blur=True,
               low_resolution=True, elastic=True)
AUG_COND_STEPS = (2, 10)  # warm-up and timed steps of each of the phase's two trainers
AUG_COND_LOADER_STEPS = 16  # batches of the loader alone at the nnunet AE patch
COND_UNET_PARAMS = 528_892_424  # the flagship U-Net with a SpatialTransformer at each site


def aug_cond_config(tiny):
    """The planner's config with the nnunet preset and the four optional
    augmentations on for both stages, the KL-VAE's transposed-conv
    upsample, and the U-Net's ``with_conditioning`` (keys a user writes into
    medimgen_config.yaml)."""
    cfg = _train_config(tiny=tiny)
    for key in ("ae_transformations", "ddpm_transformations"):
        cfg[key] = dict(cfg[key], **AUG_ALL)
    cfg["vae_params"] = dict(cfg["vae_params"], use_convtranspose=True)
    cfg["ddpm_params"] = dict(cfg["ddpm_params"], with_conditioning=True)
    return cfg


def _forced(draws, coin):
    """``draws`` with every coin off but ``coin`` (its channel coins on)."""
    off = {k: torch.zeros_like(v) for k, v in draws._asdict().items()
           if k.endswith("_on") and v is not None}
    off["flips"] = torch.zeros_like(draws.flips)
    if coin == "rotate+scale":
        off.update(rot_on=torch.ones_like(draws.rot_on), scale_on=torch.ones_like(draws.scale_on))
    elif coin == "mirror":
        off["flips"] = torch.ones_like(draws.flips)
    elif coin != "crop only":
        off[f"{coin}_on"] = torch.ones_like(off[f"{coin}_on"])
        if coin == "lowres":
            off["lowres_chan_on"] = torch.ones_like(draws.lowres_chan_on)
    return draws._replace(**off)


AUG_COINS = ["crop only", "rotate+scale", "mirror", "noise", "elastic", "blur", "lowres",
             "bright", "contrast", "gamma"]


def _aug_alone(label, batch, draws, cfg, gpu):
    """ms a batch of augment_batch with each transform's coin forced on, one
    at a time (CUDA events, median of 5)."""
    from medical_image_generation_tpu_torch.data.augment import augment_batch

    times = {c: time_ms(lambda c=c: augment_batch(batch, _forced(draws, c), cfg), 1, 5)
             for c in AUG_COINS}
    log(f"[aug_cond] {gpu}: {label} augmentation alone, ms a batch of "
        f"{tuple(batch.shape)} with one coin forced on: "
        + "; ".join(f"{k}={v:.3f}" for k, v in times.items()))
    return times


def cond_per_step(unet, encoder):
    """Launches of each port kernel a conditioned LDM step makes: two flash
    calls a transformer layer (self-attention, then attention to the
    missing context, its own tokens) forward and backward, every GroupNorm
    of the U-Net (its transformers' too) forward and backward, and the
    frozen encoder's GroupNorms forward."""
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.models.diffusion_unet import CrossAttention

    def n(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    fl = n(unet, CrossAttention) + n(unet, AttentionBlock)
    gn_u, gn_e = n(unet, GroupNorm), n(encoder, GroupNorm)
    return launches(flash_attn_fwd=fl + n(encoder, AttentionBlock), flash_attn_bwd_dq=fl,
                    flash_attn_bwd_dkdv=fl, gn_stats_fold=gn_u + gn_e, gn_affine_act=gn_u + gn_e,
                    gn_bwd_stats=gn_u, gn_bwd_apply=gn_u)


def phase_aug_cond(ws):
    """The nnunet preset with every optional augmentation, the transposed-
    conv KL-VAE, and the conditioned U-Net at the 3D flagship's width (see
    the module docstring). Returns {"ae": ..., "ldm": ...} records."""
    try:
        return _aug_cond(ws)
    finally:
        torch.cuda.empty_cache()


def _aug_cond(ws):
    from medical_image_generation_tpu_torch.data import loader as loader_mod
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.diffusion_unet import SpatialTransformer
    from medical_image_generation_tpu_torch.training.train_autoencoder import (
        METRICS,
        AutoEncoderTrainer,
    )
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    torch.backends.cudnn.allow_tf32 = True
    dev, gpu = torch.device("cuda"), ws["gpu"]
    cfg = aug_cond_config(tiny=False)
    warmup, steps = AUG_COND_STEPS
    out = {}

    # ---- the AE step: nnunet + every augmentation, transposed-conv decoder
    tr = AutoEncoderTrainer.from_config(cfg, "vae", device=dev, dtype=torch.bfloat16, seed=3)
    randomize_(tr.model, 6321)
    randomize_(tr.discriminator, 6322)
    initial = tuple(compute_initial_patch_size(cfg["ae_transformations"]))
    B = int(cfg["ae_batch_size"])
    ups = [m for m in tr.model.decoder.modules() if hasattr(m, "ConvTranspose_0")]
    log(f"[aug_cond] {gpu}: AE under aug_preset nnunet with noise, elastic, blur and low "
        f"resolution: initial patch {initial} -> crop {tr.aug_cfg.crop_to}, rot_3d "
        f"{tr.aug_cfg.rot_3d} (+-{tr.aug_cfg.rot_range:.4f} rad), scale "
        f"{tr.aug_cfg.scale_range}, mirror axes {tr.aug_cfg.mirror_axes}; decoder "
        f"upsamples by transposed conv: {len(ups)}; batch {B}")
    if initial != (310, 315, 309) or not tr.aug_cfg.rot_3d or len(ups) != 2:
        raise AssertionError(f"not the nnunet AE config: patch {initial}, rot_3d "
                             f"{tr.aug_cfg.rot_3d}, {len(ups)} transposed-conv upsamples")
    gen = torch.Generator(device=dev).manual_seed(31)
    batch = torch.rand((B, *initial, 1), generator=gen, device=dev)
    batch_bytes = batch.numel() * batch.element_size()
    per_step = ae_per_step(tr, True)
    ms_step, peak, counts, ms = _timed_steps(lambda: tr.train_step(batch, True), warmup, steps)
    expect = {k: v * steps for k, v in per_step.items()}
    losses = {k: [float(m[k]) for m in ms] for k in METRICS}
    log(f"[aug_cond] {gpu}: AE step with the adversarial loss: {ms_step:.3f} ms per step = "
        f"{1e3 / ms_step:.3f} steps/s; peak memory {peak:.2f} GiB; losses (first, last) "
        f"{({k: (round(v[0], 5), round(v[-1], 5)) for k, v in losses.items()})}; launches "
        f"per step predicted {per_step}, {steps} steps counted {counts}")
    with torch.no_grad():
        imgs = batch[:, :128, :128, :128].contiguous()
        recon = tr.model(imgs, torch.zeros(tr.latent_shape_of(imgs), device=dev))[0]
    if recon.shape != (B, 128, 128, 128, 1):
        raise AssertionError(f"transposed-conv decoder gave {tuple(recon.shape)}")
    del recon, imgs
    if counts != expect or not all(math.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError(f"AE launches {counts} != {expect}, or non-finite losses")
    bounds, shapes = gn_seen([tr.model, tr.discriminator], lambda: tr.train_step(batch, True))
    bounds.update(opt_bounds(*ae_opts(tr, True)))
    missing = {s[1:] for s in shapes} - set(GN_SHAPES)
    if missing:
        raise AssertionError(f"[aug_cond] AE GroupNorm shapes not held by the kernel phases: "
                             f"{sorted(missing)}")
    busy, shares = profile_breakdown("aug_cond AE step", lambda: tr.train_step(batch, True))
    prof = profile_breakdown.last
    log(f"[aug_cond] {gpu}: AE step device busy {busy:.3f} ms, idle share "
        f"{prof['idle_share']:.3f} (profiler); per step device ms / summed bound: "
        + "; ".join(f"{k} {shares[k]:.4f} / {bounds[k]:.4f}" for k in bounds if per_step[k]))
    draws = tr.make_draws(batch)
    aug = _aug_alone("AE", batch, draws.augment, tr.aug_cfg, gpu)
    del tr, draws
    torch.cuda.empty_cache()

    # the host side of that batch: one copy to the card, and the loader alone
    copies = _copy_times((B, *initial, 1))
    tl, _ = loader_mod.get_data_loaders(cfg, "099", "train-val-test", B, "3d",
                                        cfg["ae_transformations"],
                                        train_steps=AUG_COND_LOADER_STEPS)
    t0 = time.perf_counter()
    n_b = sum(1 for _ in tl)
    load_s = time.perf_counter() - t0
    rate = n_b / load_s
    bound_by = "the loader" if rate < 1e3 / ms_step else "the step"
    log(f"[aug_cond] {gpu}: one AE batch (2, *{initial}, 1) float32 = {batch_bytes} bytes "
        f"({batch_bytes / 1e6:.1f} MB); to the card host ms / device ms: pageable "
        f"{copies['pageable'][0]:.3f} / {copies['pageable'][1]:.3f}, pinned + non_blocking "
        f"{copies['pinned'][0]:.3f} / {copies['pinned'][1]:.3f}; the loader alone "
        f"({tl.num_threads} threads, {n_b} batches): {rate:.2f} batches/s against "
        f"{1e3 / ms_step:.3f} steps/s: {bound_by} bounds the AE CLI at this patch")
    out["ae"] = dict(ms_step=ms_step, busy_ms=busy, idle_share=prof["idle_share"],
                     peak_gb=peak, counts=counts, per_step=per_step, aug_ms=aug,
                     batch_bytes=batch_bytes, loader_batches_s=rate, copies=copies,
                     step={k: (shares[k], bounds[k]) for k in bounds})

    # ---- the conditioned LDM step, the same augmentations
    vae_f32 = AutoencoderKL.from_config(cfg["vae_params"], dtype=torch.float32, device=dev)
    randomize_(vae_f32, 6331)
    tr = LDMTrainer.from_config(cfg, vae_f32.state_dict(), device=dev, dtype=torch.bfloat16,
                                seed=4)
    del vae_f32
    randomize_(tr.unet, 6332)
    n_params = sum(p.numel() for p in tr.params)
    sts = [m for m in tr.unet.modules() if isinstance(m, SpatialTransformer)]
    initial = tuple(compute_initial_patch_size(cfg["ddpm_transformations"]))
    batch = torch.rand((2, *initial, 1), generator=gen, device=dev)
    _, latent_shape = tr.probe_latent(batch)
    heads = sorted({b.TransformerBlock_0.CrossAttention_0.num_heads for b in sts})
    log(f"[aug_cond] {gpu}: conditioned U-Net params={n_params:,} ({len(sts)} "
        f"SpatialTransformers, heads {heads}); "
        f"batch {tuple(batch.shape)} -> crop {tr.aug_cfg.crop_to} (rot_3d "
        f"{tr.aug_cfg.rot_3d}, rotation {tr.aug_cfg.rotation}) -> latent {latent_shape}")
    if n_params != COND_UNET_PARAMS or len(sts) != 11 or initial != (183, 183, 183):
        raise AssertionError(f"not the conditioned flagship: params {n_params}, {len(sts)} "
                             f"transformers, patch {initial}")
    per_step = {**cond_per_step(tr.unet, tr.vae.encoder), **opt_launches(tr.opt)}
    ms_step, peak, counts, losses = _timed_steps(lambda: tr.train_step(batch), warmup, steps)
    losses = [float(v) for v in losses]
    expect = {k: v * steps for k, v in per_step.items()}
    log(f"[aug_cond] {gpu}: conditioned LDM step: {ms_step:.3f} ms per step = "
        f"{1e3 / ms_step:.3f} steps/s; peak memory {peak:.2f} GiB; losses "
        f"{['%.5f' % v for v in losses]}; launches per step predicted {per_step}, {steps} "
        f"steps counted {counts}")
    if counts != expect or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"conditioned LDM launches {counts} != {expect}, or non-finite "
                             f"losses {losses}")
    bounds, shapes = module_bounds([tr.unet, tr.vae.encoder], lambda: tr.train_step(batch))
    bounds.update(opt_bounds(tr.opt))
    missing = {s[1:] for s in shapes} - set(GN_SHAPES)
    if missing:
        raise AssertionError(f"[aug_cond] LDM GroupNorm shapes not held by the kernel phases: "
                             f"{sorted(missing)}")
    busy, shares = profile_breakdown("aug_cond conditioned LDM step",
                                     lambda: tr.train_step(batch))
    prof = profile_breakdown.last
    for name, b_ms in bounds.items():
        if not b_ms:  # a kernel the step does not run (the narrow flash kernels here)
            continue
        log(f"[aug_cond] {gpu}: conditioned LDM per step: {name} device ms={shares[name]:.4f} "
            f"bound ms (summed over the step's {per_step[name]} launches)={b_ms:.4f} ratio="
            f"{shares[name] / b_ms:.2f}")
    log(f"[aug_cond] {gpu}: conditioned LDM step device busy {busy:.3f} ms, idle share "
        f"{prof['idle_share']:.3f}, host enqueue {prof['host_ms']:.3f} ms (profiler)")
    draws = tr.make_draws(batch)
    aug = _aug_alone("LDM", batch, draws.augment, tr.aug_cfg, gpu)
    out["ldm"] = dict(ms_step=ms_step, busy_ms=busy, idle_share=prof["idle_share"],
                      peak_gb=peak, counts=counts, per_step=per_step, aug_ms=aug,
                      n_params=n_params, step={k: (shares[k], bounds[k]) for k in bounds})
    del tr, draws, batch
    torch.cuda.empty_cache()

    # ---- the card against the CPU, and the flagship-width calls
    with flash_capture() as parity_shapes:  # held against the CPU's plain versions
        out["parity"] = _cond_parity(gpu)
    FLASH_CHECKED.update(parity_shapes)
    _cond_flagship(gpu)
    out["context"] = _cond_context(gpu)
    return out


def _cond_parity(gpu):
    """The tiny config (fp32, TF32 off) on the CPU (plain versions) and on
    the card (kernels): a DiffusionEncoder forward and backward, and a
    conditioned U-Net forward with ControlNet residuals."""
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.planning.planner import (
        compute_output_size,
        flagship_configs,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vae_p, ddpm_p, image = flagship_configs(tiny=True)
        latent = compute_output_size(image, vae_p["downsample_parameters"])
        g = torch.Generator().manual_seed(41)
        x = torch.randn((2, *latent, ddpm_p["in_channels"]), generator=g)
        t = torch.tensor([17, 901])
        errs, launches = {}, {}
        # the encoder: logits and every gradient
        enc = _encoder_of(ddpm_p, 3, device="cpu")
        randomize_(enc, 42)
        enc_g = copy.deepcopy(enc).cuda()
        cot = torch.randn((2, 3), generator=g)
        res = {}
        for name, net, dv in (("cpu", enc, "cpu"), ("gpu", enc_g, "cuda")):
            xi = x.detach().to(dv, copy=True).requires_grad_()
            kernel_table.reset()
            logits = net(xi, t.to(dv))
            (logits * cot.to(dv)).sum().backward()
            torch.cuda.synchronize()
            launches[f"encoder_{name}"] = kernel_table.launches()
            res[name] = [logits.detach().cpu(), xi.grad.cpu()] + [
                p.grad.cpu() for p in net.parameters()]
        errs["encoder"] = max(_err(a, b) / max(b.abs().max().item(), 1e-30)
                              for a, b in zip(res["gpu"], res["cpu"]))
        # the conditioned U-Net forward with ControlNet residuals
        cfg = dict(ddpm_p, with_conditioning=True)
        unet = DiffusionUNet.from_config(cfg, dtype=torch.float32, device="cpu").eval()
        randomize_(unet, 43)
        unet_g = copy.deepcopy(unet).cuda()
        # the residuals' shapes: one per collected skip (ConvND_0, each down
        # ResBlock / transformer, each Downsample) and the mid block's output
        shapes = _skip_shapes(latent, cfg, 2)
        down = [torch.randn(s, generator=g) * 0.5 for s in shapes[0]]
        mid = torch.randn(shapes[1], generator=g) * 0.5
        with torch.no_grad():
            ref = unet(x, t, down_block_additional_residuals=down,
                       mid_block_additional_residual=mid)
            plain = unet(x, t)
            kernel_table.reset()
            got = unet_g(x.cuda(), t.cuda(),
                         down_block_additional_residuals=[r.cuda() for r in down],
                         mid_block_additional_residual=mid.cuda())
            torch.cuda.synchronize()
        launches["unet_gpu"] = kernel_table.launches()
        errs["unet_controlnet"] = _err(got.cpu(), ref) / max(1.0, ref.abs().max().item())
        moved = _err(plain, ref)
        tol = 1e-4  # fp32 everywhere (TF32 off); summation order only
        log(f"[aug_cond] {gpu}: tiny fp32, CPU plain vs GPU kernels: DiffusionEncoder forward "
            f"+ backward max err / max|ref| {errs['encoder']:.3e}, conditioned U-Net forward "
            f"with ControlNet residuals {errs['unet_controlnet']:.3e} (tol {tol:g}; the "
            f"residuals move the output by {moved:.3e}); GPU launches {launches}")
        if not (errs["encoder"] <= PARITY_GRAD_TOL and errs["unet_controlnet"] <= tol
                and moved > 1e-2):
            raise AssertionError("tiny encoder / ControlNet CPU-GPU parity failed")
        if not (launches["encoder_gpu"]["flash_attn_bwd_dkdv"] > 0
                and launches["unet_gpu"]["flash_attn_fwd"] > 0):
            raise AssertionError(f"the flash kernels did not run: {launches}")
        return errs
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True


def _encoder_of(ddpm_p, num_classes, **kw):
    """A DiffusionEncoder of the U-Net's geometry (ddpm_params)."""
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionEncoder

    return DiffusionEncoder(
        ddpm_p["spatial_dims"], ddpm_p["in_channels"], num_classes, ddpm_p["num_channels"],
        ddpm_p["attention_levels"], ddpm_p["num_head_channels"],
        ddpm_p.get("num_res_blocks", 2), ddpm_p.get("norm_num_groups", 32), ddpm_p["strides"],
        ddpm_p["kernel_sizes"], ddpm_p["paddings"], **kw)


def _skip_shapes(latent, ddpm_p, batch):
    """Public shapes of the U-Net's collected skips, and of its mid block."""
    spatial, chs = list(latent), ddpm_p["num_channels"]
    nrb = ddpm_p.get("num_res_blocks", 2)
    out = [(batch, *spatial, chs[0])]
    for level, ch in enumerate(chs):
        out += [(batch, *spatial, ch)] * (nrb if isinstance(nrb, int) else nrb[level])
        if level != len(chs) - 1:
            spatial = [s // st for s, st in zip(spatial, ddpm_p["strides"][level + 1])]
            out.append((batch, *spatial, ch))
    return out, (batch, *spatial, chs[-1])


def _cond_flagship(gpu):
    """At the flagship's width, bf16, batch 2: one DiffusionEncoder forward
    and backward and one conditioned U-Net forward with ControlNet
    residuals, timed, finite, launches as the code predicts."""
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.models.diffusion_unet import (
        CrossAttention,
        DiffusionUNet,
    )
    from medical_image_generation_tpu_torch.planning.planner import flagship_configs

    dev = torch.device("cuda")
    _, ddpm_p, _ = flagship_configs()
    latent = (32, 32, 32)
    gen = torch.Generator(device=dev).manual_seed(44)
    x = torch.randn((2, *latent, ddpm_p["in_channels"]), generator=gen, device=dev)
    t = torch.tensor([17, 901], device=dev)

    def n(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    enc = _encoder_of(ddpm_p, 2, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev)
    randomize_(enc, 45)

    def enc_step():
        for p in enc.parameters():
            p.grad = None
        enc(x, t).float().square().sum().backward()

    enc_ms = time_ms(enc_step, 1, 3)
    kernel_table.reset()
    shapes = gn_seen([enc], enc_step)[1]
    enc_counts = kernel_table.launches()
    a_e, g_e = n(enc, AttentionBlock), n(enc, GroupNorm)
    enc_expect = launches(flash_attn_fwd=a_e, flash_attn_bwd_dq=a_e, flash_attn_bwd_dkdv=a_e,
                          gn_stats_fold=g_e, gn_affine_act=g_e, gn_bwd_stats=g_e,
                          gn_bwd_apply=g_e)
    finite = all(torch.isfinite(p.grad).all() for p in enc.parameters())
    del enc
    unet = DiffusionUNet.from_config(dict(ddpm_p, with_conditioning=True), dtype=torch.bfloat16,
                                     device=dev).eval()
    randomize_(unet, 46)
    res_shapes = _skip_shapes(latent, ddpm_p, 2)
    down = [torch.randn(s, generator=gen, device=dev) * 0.5 for s in res_shapes[0]]
    mid = torch.randn(res_shapes[1], generator=gen, device=dev) * 0.5
    with torch.no_grad():
        fwd = lambda: unet(x, t, down_block_additional_residuals=down,  # noqa: E731
                           mid_block_additional_residual=mid)
        u_ms = time_ms(fwd, 1, 3)
        kernel_table.reset()
        shapes |= gn_seen([unet], fwd)[1]
        u_counts = kernel_table.launches()
        y = fwd()
    c_u, g_u = n(unet, CrossAttention), n(unet, GroupNorm)
    u_expect = {k: 0 for k in u_counts}
    u_expect.update(flash_attn_fwd=c_u, gn_stats_fold=g_u, gn_affine_act=g_u)
    ok = finite and bool(torch.isfinite(y).all()) and y.shape == (2, *latent, 8)
    log(f"[aug_cond] {gpu}: flagship width bf16 batch 2: DiffusionEncoder forward + backward "
        f"{enc_ms:.3f} ms (launches {enc_counts}, predicted {enc_expect}); conditioned U-Net "
        f"forward with ControlNet residuals {u_ms:.3f} ms (launches {u_counts}, predicted "
        f"{u_expect}); finite and shaped: {ok}")
    del unet, down, mid, y
    if enc_counts != enc_expect or u_counts != u_expect or not ok:
        raise AssertionError("flagship-width encoder / ControlNet calls failed")
    missing = {s[1:] for s in shapes} - set(GN_SHAPES)
    if missing:
        raise AssertionError(f"[aug_cond] encoder / U-Net GroupNorm shapes not held by the "
                             f"kernel phases: {sorted(missing)}")


# (q shape (B, Sq, H, D), Sk): a context of 1 and 77 tokens at the 3D U-Net's
# two sites and 77 at the 2D level-1 site, keys longer than the queries at
# the D = 768 cluster site, and ragged pairs (no length a multiple of a tile)
# of three heads, of one head at D = 256 and of two at D = 200
CONTEXT_PAIRS = [((2, 4096, 1, 512), 1), ((2, 4096, 1, 512), 77), ((2, 512, 1, 768), 1),
                 ((2, 512, 1, 768), 77), ((2, 512, 1, 768), 4096), ((48, 1024, 1, 512), 77),
                 ((2, 1000, 3, 96), 200), ((2, 1000, 1, 256), 333), ((3, 77, 2, 200), 1000)]
CONTEXT_F32 = [((2, 4096, 1, 512), 77), ((2, 1000, 3, 96), 200)]  # also checked in fp32
CONTEXT_WIDTH = 768  # a text encoder's embedding width (77 tokens) or covariates (1)


def context_bounds(B, Sq, Sk, H, D, isz):
    """{kernel: (least ms, "operations" or "bytes")} of the forward, dQ and
    dK/dV with keys of Sk tokens: 4, 6 and 8 B H Sq Sk D FLOP (2 and 3 and 4
    products of Sq x Sk x D) at the bf16 peak, against each pass's bytes:
    forward q, k, v, o and the lse; dQ q, k, v, o, dO, dq, lse and delta;
    dK/dV q, k, v, dO, dk, dv, lse and delta, each once."""
    qs, ks, rows = B * Sq * H * D * isz, B * Sk * H * D * isz, B * H * Sq * 4
    fl = B * H * Sq * Sk * D
    return {"flash_attn_fwd": bound(4 * fl, 2 * qs + 2 * ks + rows, PEAK_BF16_FLOPS),
            "flash_attn_bwd_dq": bound(6 * fl, 4 * qs + 2 * ks + 2 * rows, PEAK_BF16_FLOPS),
            "flash_attn_bwd_dkdv": bound(8 * fl, 2 * qs + 4 * ks + 2 * rows, PEAK_BF16_FLOPS)}


def single_key_bounds(q, k, v, do, scale):
    """Bounds on |dq| and |dk| with one key (Sk = 1), elementwise. The
    softmax over one key is 1, so dq and dk vanish: the kernels and the
    plain versions return the fp32 rounding of dP - delta (dO's dot products
    with v and with o = v, D terms each), times k or, summed over the
    queries, q. With gamma_D = D u / (1 - D u), u = 2^-24 (fp32 sums), that
    is at most scale * 2 gamma_D sum_d |dO_d v_d| |k| for dq and the same
    summed against |q| over the queries for dk."""
    D = q.shape[-1]
    gamma = D * 2.0 ** -24 / (1 - D * 2.0 ** -24)
    c = scale * 2 * gamma * (do.float().abs() * v.float().abs()).sum(-1, keepdim=True)
    return c * k.float().abs(), (c * q.float().abs()).sum(1, keepdim=True)


def p_rounding_bound(q, k, v, scale):
    """Elementwise bound on what the bf16 forward's rounding of P to bf16
    before P V (unit roundoff u = 2^-8) moves o: u (P |V|), P the softmax,
    from the plain math in fp32. FLASH_TOL's 2^-10 stands for that term
    where many keys average its random signs away (self-attention, and
    contexts of 200 and 4096 keys: 0.33-0.80 of FLASH_TOL); against 77
    keys a few elements of o near 0 exceed FLASH_TOL alone (1.07-1.48x on
    an NVIDIA H100 80GB HBM3 at 700 W). The backward passes stay within
    FLASH_BWD_TOL."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, -1)
    return (2.0 ** -8 * (p @ vf.abs())).permute(0, 2, 1, 3)


def held(got, ref, allowed, extra):
    """(every element within allowed + extra, max abs error, largest error /
    (allowed + extra), the same over ``allowed`` alone)."""
    d = (got.float() - ref.float()).abs()
    return (bool((d <= allowed + extra).all()), d.max().item(),
            (d / (allowed + extra)).max().item(), (d / allowed).max().item())


def _context_case(shape, Sk, dt, gen):
    """The three flash kernels at q of ``shape`` against keys and values of Sk
    tokens, against their plain versions: o within FLASH_TOL plus, in bf16,
    the bound of rounding P to bf16 (``p_rounding_bound``), the backward
    within FLASH_BWD_TOL, and with one key dq and dk, which vanish, within
    their fp32 rounding bound of 0 (``single_key_bounds``). Also the lse (LSE_TOL), delta, launches,
    a skipped key tile caught, and dq, delta, dk and dv the same bits on a
    second launch. With ms, bound, plain ms and SDPA's forward and forward +
    backward ms in bf16. Returns ({kernel: record}, log line)."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    B, Sq, H, D = shape
    q, do = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(2))
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device="cuda").to(dt) for _ in range(2))
    scale = D ** -0.5
    n0 = kernel_table.launches()
    o, lse = fa.flash_attention(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    dq, delta = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, scale)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
    r_dq, r_delta = fa.flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do, scale)
    r_dk, r_dv = fa.flash_bwd_dkdv_plain(q, k, v, do, lse_ref, r_delta, scale)
    torch.cuda.synchronize()
    launched = {k_: n - n0[k_] for k_, n in kernel_table.launches().items()}
    dq2, delta2 = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, scale)
    dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
    same = all(torch.equal(a_, b_) for a_, b_ in
               ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    p_bound = p_rounding_bound(q, k, v, scale) if dt == torch.bfloat16 else 0.0
    rtol, atol = FLASH_TOL[dt]
    res = {"o": held(o, o_ref, atol + rtol * o_ref.float().abs(), p_bound)}
    rt, at = FLASH_BWD_TOL[dt]
    for nm, g, r in (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv)):
        res[nm] = held(g, r, rt * r.float().abs() + at * r.float().abs().max(), 0.0)
    if Sk == 1:  # dq and dk vanish: each side within its rounding bound of 0
        for nm, g, r, b in zip(("dq", "dk"), (dq, dk), (r_dq, r_dk),
                               single_key_bounds(q, k, v, do, scale)):
            res[nm] = held(g, r, 2 * b, 0.0)
    lerr = _err(lse, lse_ref)
    # a kernel that skips one key tile must fail the forward's tolerance, where there is one
    o_cut, lse_cut = fa.flash_attention_plain(q, k[:, FLASH_TILE:], v[:, FLASH_TILE:], scale)
    cut_seen = Sk <= FLASH_TILE or not (
        held(o_cut, o_ref, atol + rtol * o_ref.float().abs(), p_bound)[0]
        and _err(lse_cut, lse_ref) <= LSE_TOL)
    d_ok, d_err, _ = within(delta, r_delta, 1e-5, 1e-5)
    shapes_ok = dk.shape == dv.shape == k.shape and dq.shape == q.shape
    ok = (all(x[0] for x in res.values()) and lerr <= LSE_TOL and cut_seen and d_ok
          and same and shapes_ok and launched["flash_attn_fwd"] == launched["flash_attn_bwd_dq"]
          == launched["flash_attn_bwd_dkdv"] == 1)
    line = (f"q {shape} Sk={Sk} {str(dt)[6:]}: "
            + " ".join(f"max|{nm}-plain|={x[1]:.3e} ({x[2]:.3f} of its allowance"
                       + ("; twice the rounding bound of 0)" if Sk == 1 and nm in ("dq", "dk")
                          else f"; {x[3]:.3f} of FLASH_TOL alone)" if nm == "o" else ")")
                       for nm, x in res.items())
            + f" max|lse-plain|={lerr:.3e} max|delta-plain|={d_err:.3e} one-tile-skip "
            f"caught={cut_seen}{' (no tile to skip)' if Sk <= FLASH_TILE else ''}; backward "
            f"bit-identical on a rerun={same}; launches "
            f"{ {k_: n for k_, n in launched.items() if n} }")
    err = res["o"][1]
    rec = {}
    if dt == torch.bfloat16:
        bounds = context_bounds(B, Sq, Sk, H, D, q.element_size())
        times = {
            "flash_attn_fwd": (time_ms(lambda: fa.flash_attention(q, k, v, scale), 2, 5),
                               time_ms(lambda: fa.flash_attention_plain(q, k, v, scale), 1, 3),
                               err),
            "flash_attn_bwd_dq": (
                time_ms(lambda: fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, scale), 2, 5),
                time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do, scale), 1, 3),
                res["dq"][1]),
            "flash_attn_bwd_dkdv": (
                time_ms(lambda: fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale), 2, 5),
                time_ms(lambda: fa.flash_bwd_dkdv_plain(q, k, v, do, lse_ref, delta, scale),
                        1, 3),
                max(res["dk"][1], res["dv"][1]))}
        lib_f = sdpa_ms(q, k, v, scale, (2, 5))
        lib_b = sdpa_ms(q, k, v, scale, (2, 5), do)
        lib_bwd = None if lib_f is None or lib_b is None else lib_b - lib_f
        for name, (ms, plain, e) in times.items():
            b_ = bounds[name]
            rec[name] = dict(shape=list(shape), Sk=Sk, dtype="bf16", max_abs_err=e, ms=ms,
                             plain_ms=plain, bound_ms=b_[0], bound_by=b_[1],
                             library_ms=lib_f if name == "flash_attn_fwd" else lib_bwd)
            line += (f" | {name} ms={ms:.4f} bound_ms={b_[0]:.4f} ({b_[1]}) plain_ms="
                     f"{plain:.4f}")
        line += " | SDPA ms forward={} forward+backward={}".format(
            *("no library call" if m is None else f"{m:.4f}" for m in (lib_f, lib_b)))
    if not ok:
        raise AssertionError(f"[aug_cond] flash kernels with a context disagree with their "
                             f"plain versions: {line}")
    return rec, line


def _cond_context(gpu):
    """The conditioned U-Net attending to a context on the card: the three
    flash kernels at every CONTEXT_PAIRS entry against their plain versions;
    the tiny fp32 U-Net with a context, CPU against GPU, forward and
    backward; the flagship-width U-Net built with ``context_dim`` 768,
    forward and backward with contexts of 77 and 1 tokens. Returns
    {"kernels": {kernel: [record]}, "launches": {kernel: launches of one
    forward + backward with the 77-token context}}."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    recs = {}
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in full fp32
    try:
        for shape, Sk in CONTEXT_PAIRS:
            dts = ((torch.bfloat16, torch.float32) if (shape, Sk) in CONTEXT_F32
                   else (torch.bfloat16,))
            for dt in dts:
                rec, line = _context_case(shape, Sk, dt, gen)
                log(f"[aug_cond] {gpu}: context flash {line} OK")
                for name, r in rec.items():
                    recs.setdefault(name, []).append(r)
            flash_checked("fwd", [shape], Sk)
            flash_checked("bwd", [shape], Sk)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[aug_cond] {gpu}: {len(CONTEXT_PAIRS)} context pairs agree "
        f"({time.perf_counter() - t0:.1f} s)")
    with flash_capture() as parity_shapes:  # held against the CPU's plain versions
        _cond_context_parity(gpu)
    FLASH_CHECKED.update(parity_shapes)
    return {"kernels": recs, "launches": _cond_context_flagship(gpu)}


def _cond_context_parity(gpu):
    """The tiny conditioned U-Net built with ``context_dim`` 12 (fp32, TF32
    off) on the CPU (plain versions) and on the card (kernels): forward with
    a (2, 7, 12) context and backward, output and the gradients of x, the
    context and every parameter, each within 1e-4 of its largest value."""
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.planning.planner import (
        compute_output_size,
        flagship_configs,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vae_p, ddpm_p, image = flagship_configs(tiny=True)
        latent = compute_output_size(image, vae_p["downsample_parameters"])
        g = torch.Generator().manual_seed(48)
        x = torch.randn((2, *latent, ddpm_p["in_channels"]), generator=g)
        ctx = torch.randn((2, 7, 12), generator=g)
        t = torch.tensor([17, 901])
        cot = torch.randn((2, *latent, ddpm_p["out_channels"]), generator=g)
        unet = DiffusionUNet.from_config(dict(ddpm_p, with_conditioning=True),
                                         dtype=torch.float32, device="cpu", context_dim=12)
        randomize_(unet, 49)
        res, launches = {}, {}
        for name, net, dv in (("cpu", unet, "cpu"), ("gpu", copy.deepcopy(unet).cuda(), "cuda")):
            xi, ci = (a.to(dv, copy=True).requires_grad_() for a in (x, ctx))
            kernel_table.reset()
            out = net(xi, t.to(dv), context=ci)
            (out * cot.to(dv)).sum().backward()
            torch.cuda.synchronize()
            launches[name] = kernel_table.launches()
            res[name] = [out.detach().cpu(), xi.grad.cpu(), ci.grad.cpu()] + [
                p.grad.cpu() for p in net.parameters()]
        err = max(_err(a, b) / max(b.abs().max().item(), 1e-30)
                  for a, b in zip(res["gpu"], res["cpu"]))
        tol = 1e-4  # fp32 everywhere (TF32 off); summation order only
        log(f"[aug_cond] {gpu}: tiny fp32 conditioned U-Net with a (2, 7, 12) context, CPU "
            f"plain vs GPU kernels, forward + backward (output, x, context and every "
            f"parameter's gradient): max err / max|ref| {err:.3e} (tol {tol:g}); GPU launches "
            f"{launches['gpu']}")
        if not err <= tol:
            raise AssertionError("tiny conditioned U-Net with a context: CPU-GPU parity failed")
        if not all(launches["gpu"][k] > 0 for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                                    "flash_attn_bwd_dkdv")):
            raise AssertionError(f"the flash kernels did not run: {launches}")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True


def _cond_context_flagship(gpu):
    """The conditioned U-Net at the 3D flagship's width (aug_cond_config's
    ddpm_params, ``context_dim`` 768, seeded bf16 weights) on batch 2 of the
    32^3 x 8 latent: forward and backward with a context of 77 tokens, then
    of 1. Each pass: ms forward and backward (CUDA events), launches (22 of
    each flash kernel: 11 self-attentions at Sk = Sq, 11 attentions to the
    context), no plain attention on the card, every flash and GroupNorm
    shape one a kernel phase held, peak memory, and a profile (device busy,
    idle share). Returns the launches of the 77-token pass."""
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm
    from medical_image_generation_tpu_torch.models.diffusion_unet import (
        CrossAttention,
        DiffusionUNet,
    )
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    ddpm_p = aug_cond_config(tiny=False)["ddpm_params"]
    unet = DiffusionUNet.from_config(ddpm_p, dtype=torch.bfloat16, device=dev,
                                     context_dim=CONTEXT_WIDTH)
    randomize_(unet, 50)
    n_ca = sum(isinstance(m, CrossAttention) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNorm) for m in unet.modules())
    gen = torch.Generator(device=dev).manual_seed(51)
    x = torch.randn((2, 32, 32, 32, ddpm_p["in_channels"]), generator=gen, device=dev)
    cot = torch.randn((2, 32, 32, 32, ddpm_p["out_channels"]), generator=gen, device=dev)
    t = torch.tensor([17, 901], device=dev)
    expect = launches(flash_attn_fwd=n_ca, flash_attn_bwd_dq=n_ca, flash_attn_bwd_dkdv=n_ca,
                      gn_stats_fold=n_gn, gn_affine_act=n_gn, gn_bwd_stats=n_gn,
                      gn_bwd_apply=n_gn)
    plain_calls = []
    originals = {nm: getattr(fa, nm) for nm in ("flash_attention_plain", "flash_bwd_dq_plain",
                                                "flash_bwd_dkdv_plain")}

    def counting(nm, fn):
        def call(q, *a):
            if q.is_cuda:
                plain_calls.append(nm)
            return fn(q, *a)
        return call

    out = None
    try:
        for nm, fn in originals.items():
            setattr(fa, nm, counting(nm, fn))
        for Sk in (77, 1):
            ctx = torch.randn((2, Sk, CONTEXT_WIDTH), generator=gen, device=dev)
            xi, ci = x.clone().requires_grad_(), ctx.requires_grad_()

            def step():
                unet.zero_grad(set_to_none=True)
                xi.grad = ci.grad = None
                y = unet(xi, t, context=ci)
                (y.float() * cot).sum().backward()
                return y

            step()  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with flash_capture() as seen, gn_recorder() as gns:
                kernel_table.reset()
                y = step()
                torch.cuda.synchronize()
                counts = kernel_table.launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            fwd_t, bwd_t = [], []
            for _ in range(3):
                unet.zero_grad(set_to_none=True)
                e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                e[0].record()
                yy = unet(xi, t, context=ci)
                e[1].record()
                (yy.float() * cot).sum().backward()
                e[2].record()
                torch.cuda.synchronize()
                fwd_t.append(e[0].elapsed_time(e[1]))
                bwd_t.append(e[1].elapsed_time(e[2]))
            del yy
            busy, _ = profile_breakdown(f"aug_cond context Sk={Sk} forward + backward", step)
            idle = profile_breakdown.last["idle_share"]
            finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(ci.grad).all()) and \
                all(torch.isfinite(p.grad).all() for p in unet.parameters())
            cross = sorted({(k_, s, sk) for k_, s, sk in seen if sk == Sk})
            expect_seen = {(k_, s, sk) for k_ in ("fwd", "bwd") for s in FLAGSHIP_FLASH
                           for sk in (s[1], Sk)}
            missing = seen - FLASH_CHECKED
            gn_missing = {s[1:] for s in gns} - set(GN_SHAPES)
            log(f"[aug_cond] {gpu}: flagship conditioned U-Net (context_dim {CONTEXT_WIDTH}, "
                f"bf16, batch 2 of 32^3 x 8) with a (2, {Sk}, {CONTEXT_WIDTH}) context: forward "
                f"{statistics.median(fwd_t):.3f} ms, backward {statistics.median(bwd_t):.3f} ms "
                f"(CUDA events, median of 3); device busy {busy:.3f} ms, idle share {idle:.3f}; "
                f"peak {peak:.2f} GiB; launches {counts} (predicted {expect}); flash calls to "
                f"the context {cross}; plain attention calls on the card {len(plain_calls)}; "
                f"finite: {finite}; output {tuple(y.shape)}")
            if counts != expect or plain_calls or not finite or y.shape != (2, 32, 32, 32, 8):
                raise AssertionError(f"[aug_cond] flagship U-Net with a {Sk}-token context "
                                     "failed")
            if seen != expect_seen or missing or gn_missing:
                raise AssertionError(f"[aug_cond] flash calls {sorted(seen)} (unchecked "
                                     f"{sorted(missing)}), GroupNorm shapes not held "
                                     f"{sorted(gn_missing)}")
            if out is None:
                out = counts
            del y, ctx, xi, ci
    finally:
        for nm, fn in originals.items():
            setattr(fa, nm, fn)
        del unet
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------------ dist

DIST_RING_CASES = [((1, 262144, 1, 512), 4), ((2, 32768, 1, 768), 2)]  # ((B, S, H, D), n)
DIST_STEPS, DIST_BATCH = 3, 2  # flagship LDM steps under torchrun, global batch
# (c) data = 2 against the one-process steps at the same global batch, on top
# of twice the spread of two one-process runs (0 on the H100): each rank's
# bf16 convolutions run at batch 1 (cuDNN may take other algorithms than at
# batch 2) and the fp32 losses and gradients are averaged in another order.
# Measured on H100s: up to 1.3e-4 of the value; a rank's own gradient norm
# (a step without the mean) lies 1.7e-2 to 5.8e-2 off the averaged one.
DIST_DP_RTOL = 1e-3
DIST_DP_SUM_RTOL = 1e-4  # the parameter sums (measured: 1.8e-6)


def _ring_label(shape, n):
    return f"{shape[1]}x{shape[3]}_n{n}"


def _ring_case(shape, n, gen):
    """The ring's per-step block math (``ring_forward`` / ``ring_backward``)
    over n in-process blocks of a bf16 (B, S, H, D) input, against the
    whole-sequence flash kernels on the same input: o and dQ / dK / dV at
    ``RING_TOL`` / ``RING_BWD_TOL``, the lse at LSE_TOL. Returns (record,
    log line)."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import ring_attention as ra

    dt = torch.bfloat16
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(4))
    B, S, H, D = shape
    scale = D ** -0.5
    qs, ks, vs, dos = (list(t.chunk(n, 1)) for t in (q, k, v, do))

    def timed(fn):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        return out, s.elapsed_time(e)

    def ring_fwd():
        return ra.ring_forward(qs, ks, vs, scale, n, ra.list_rotate)

    def ring_bwd():
        return ra.ring_backward(qs, ks, vs, [o for o, _ in fwd], [lse for _, lse in fwd], dos,
                                scale, n, ra.list_rotate)

    def whole_fwd():
        with torch.no_grad():
            return fa.flash_attention(q, k, v, scale)

    def whole_bwd():
        return fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, scale)

    # in turns, whole / ring / ring / whole, each pass once a turn; the counts
    # are of the first ring forward and backward
    (o_ref, lse_ref), w1 = timed(whole_fwd)
    kernel_table.reset()
    fwd, r1 = timed(ring_fwd)
    bwd, rb1 = timed(ring_bwd)
    launches = kernel_table.launches()
    del bwd
    fwd, r2 = timed(ring_fwd)
    _, w2 = timed(whole_fwd)
    ref, wb1 = timed(whole_bwd)
    bwd, rb2 = timed(ring_bwd)
    ref, wb2 = timed(whole_bwd)
    ring_fwd_ms, ring_bwd_ms, whole_fwd_ms, whole_bwd_ms = [r1, r2], [rb1, rb2], [w1, w2], \
        [wb1, wb2]
    o = torch.cat([o for o, _ in fwd], 1)
    lse = torch.cat([lse.reshape(B, H, -1) for _, lse in fwd], 2).reshape(B * H, S)
    grads = [torch.cat([g[i] for g in bwd], 1) for i in range(3)]
    del fwd, bwd
    rtol, atol = ra.RING_TOL[dt]
    o_ok, o_err, o_ratio = within(o, o_ref, rtol, atol / o_ref.float().abs().max().item())
    lse_err = _err(lse, lse_ref)
    res = {nm: within(g, r, *ra.RING_BWD_TOL[dt])
           for nm, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    want = {"flash_attn_fwd": n * n, "flash_attn_bwd_dq": n * n, "flash_attn_bwd_dkdv": n * n}
    ok = (o_ok and lse_err <= LSE_TOL and all(x[0] for x in res.values())
          and all(launches[k] == c for k, c in want.items()))
    line = (f"ring {shape} n={n} bf16: max|o-whole|={o_err:.3e} (err/allowed {o_ratio:.3f}) "
            f"max|lse-whole|={lse_err:.3e} "
            + " ".join(f"max|{nm}-whole|={x[1]:.3e} ({x[2]:.3f})" for nm, x in res.items())
            + f"; tolerance o {rtol:.4g}|o| + {atol:.4g}, grads {ra.RING_BWD_TOL[dt][0]:.4g}|g| "
            f"+ {ra.RING_BWD_TOL[dt][1]:.4g} max|g|; launches {launches} (want {want}); ms in "
            f"turns (whole, ring, ring, whole): fwd {w1:.1f} {r1:.1f} {r2:.1f} {w2:.1f}, bwd "
            f"{wb1:.1f} {rb1:.1f} {rb2:.1f} {wb2:.1f}")
    if not ok:
        raise AssertionError(f"[dist] the ring disagrees with the whole-sequence kernels: {line}")
    return dict(shape=list(shape), n=n, launches=launches, ring_fwd_ms=ring_fwd_ms,
                ring_bwd_ms=ring_bwd_ms, whole_fwd_ms=whole_fwd_ms, whole_bwd_ms=whole_bwd_ms,
                err_over_allowed={"o": o_ratio, **{k: x[2] for k, x in res.items()}}), line


def _torchrun(nproc, args, timeout=900):
    """``python -m torch.distributed.run --standalone`` of ``bench/dist_steps.py``
    from the checkout's root; returns rank 0's JSON record."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "medical_image_generation_tpu_torch.bench.dist_steps",
           *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"[dist] {' '.join(cmd[1:])} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    recs = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if len(recs) != 1:
        raise AssertionError(f"[dist] expected one JSON record from rank 0: {proc.stdout[-3000:]}")
    recs[0]["wall_s"] = time.perf_counter() - t0
    return recs[0]


def _steps_close(got, ref, spread, label, rtol=2.0 ** -20, sum_rtol=None):
    """Per-step losses, per-step gradient norms and the parameter sums of two
    runs: each within twice the spread of two runs without torchrun, and at
    least ``rtol`` of the value (by default a few fp32 ulps; ``sum_rtol``
    for the sums, by default ``rtol``). Returns (ok, line)."""
    pairs = ([("loss", a, b, s) for a, b, s in zip(got["losses"], ref["losses"],
                                                    spread["losses"])]
             + [("norm", a, b, s) for a, b, s in zip(got["norms"], ref["norms"], spread["norms"])]
             + [(k, got[k], ref[k], spread[k]) for k in ("checksum", "abs_checksum")])
    worst, ok = [], True
    for name, a, b, s in pairs:
        r = sum_rtol if sum_rtol is not None and name.endswith("checksum") else rtol
        tol = max(2 * s, r * abs(b))
        ok = ok and abs(a - b) <= tol
        worst.append(f"{name} {a:.9g} vs {b:.9g} (|d| {abs(a - b):.3g}, tol {tol:.3g})")
    return ok, f"{label}: " + "; ".join(worst)


def _dist_ring(gpu):
    """(a): the ring's block math in one process, and the block and whole
    shapes against the plain versions. Returns {label: record}."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    cpu_gen = torch.Generator().manual_seed(42)
    out = {}
    for shape, n in DIST_RING_CASES:
        rec, line = _ring_case(shape, n, gen)
        out[_ring_label(shape, n)] = rec
        log(f"[dist] {gpu}: {line} OK")
        torch.cuda.empty_cache()
        # the whole-sequence passes ran here too: a shape no earlier phase
        # held (the backward at batch 1) is held against the plain versions
        if not {("fwd", shape, shape[1]), ("bwd", shape, shape[1])} <= FLASH_CHECKED:
            _, line = _flash_ddpm_case(*shape, torch.bfloat16, gen, cpu_gen, True, timed=False)
            log(f"[dist] {gpu}: whole-sequence flash {line} OK")
            flash_checked("fwd", [shape])
            flash_checked("bwd", [shape])
            torch.cuda.empty_cache()
        block = (shape[0], shape[1] // n, *shape[2:])
        _, line = _flash_ddpm_case(*block, torch.bfloat16, gen, cpu_gen, True, timed=False)
        log(f"[dist] {gpu}: ring block flash {line} OK")
        flash_checked("fwd", [block])
        flash_checked("bwd", [block])
        torch.cuda.empty_cache()
    return out


def _dist_torchrun(gpu, args):
    """(b): the flagship LDM steps under torchrun at one NCCL rank against
    two runs of the same steps without it. Returns (the torchrun record,
    the first run without it, the spread of the two)."""
    from medical_image_generation_tpu_torch.bench import dist_steps

    torch.cuda.empty_cache()  # the child shares the card
    step = _torchrun(1, args)
    if step["world"] != 1 or step["backend"] != "nccl":
        raise AssertionError(f"[dist] the torchrun run did not go through NCCL: {step}")
    log(f"[dist] {gpu}: torchrun nproc 1 ({step['backend']}, mesh {step['mesh']}): losses "
        f"{step['losses']} ms a step {[round(x, 1) for x in step['ms']]} (wall "
        f"{step['wall_s']:.1f} s) launches a step {step['launches']}")
    plain = []
    for _ in range(2):
        plain.append(dist_steps.run_ldm(DIST_STEPS, DIST_BATCH))
        torch.cuda.empty_cache()
    spread = {"losses": [abs(a - b) for a, b in zip(plain[0]["losses"], plain[1]["losses"])],
              "norms": [abs(a - b) for a, b in zip(plain[0]["norms"], plain[1]["norms"])],
              **{k: abs(plain[0][k] - plain[1][k]) for k in ("checksum", "abs_checksum")}}
    ok, line = _steps_close(step, plain[0], spread, "torchrun vs one process")
    log(f"[dist] {gpu}: {line}; spread of the two runs without torchrun {spread}; ms a step "
        f"without torchrun {[round(x, 1) for x in plain[0]['ms']]}")
    if not ok or plain[0]["launches"] != step["launches"]:
        raise AssertionError(f"[dist] the torchrun steps differ from the one-process steps: "
                             f"{line}; launches {step['launches']} vs {plain[0]['launches']}")
    return step, plain[0], spread


def _dist_two_ranks(gpu, args, ref, spread):
    """(c), two cards: the LDM steps on 2 NCCL ranks (data = 2, a row a
    rank) against the one-process steps at the same global batch, every
    rank's parameter sums equal; and the ring over a model axis of 2 at
    (1, 262144, 1, 512) against the whole-sequence kernels."""
    dp = _torchrun(2, args)
    sums = dp["rank_checksums"]
    same = len(sums) == 2 and all(x == sums[0] for x in sums)
    ok, line = _steps_close(dp, ref, spread, "data = 2 vs one process", DIST_DP_RTOL,
                            DIST_DP_SUM_RTOL)
    alone = [abs(a - b) / b for a, b in zip(dp["local_norms"], dp["norms"])]
    log(f"[dist] {gpu}: torchrun nproc 2, data = 2: {line}; each rank's parameter sums "
        f"{sums} (equal: {same}); rank 0's gradient norm before the mean {dp['local_norms']} "
        f"(|d| / the averaged norm {[f'{x:.3g}' for x in alone]}: what a step without the "
        f"mean would clip); ms a step {[round(x, 1) for x in dp['ms']]}")
    if not ok or not same:
        raise AssertionError("[dist] the data = 2 steps differ from the one-process steps")
    ring = _torchrun(2, ["--ring", ",".join(map(str, DIST_RING_CASES[0][0]))])
    ms = {k: [round(x, 1) for x in v] for k, v in ring.items() if k.endswith("_ms")}
    log(f"[dist] {gpu}: torchrun nproc 2, model = 2 ring at {ring['shape']}: err/allowed "
        f"{ring['err_over_allowed']}; ms in turns (whole, ring, ring, whole; the first ring "
        f"pass sets up NCCL's connections) {ms}")
    if not ring["ok"]:
        raise AssertionError("[dist] the 2-rank ring disagrees with the whole-sequence kernels")
    return {"dp": dp, "ring": ring}


def phase_dist():
    """(a) the ring's block math at the 3D pixel DDPM's and the 2D-latent
    widths against the whole-sequence kernels; the block shapes against the
    plain versions; (b) the flagship LDM steps under torchrun with NCCL
    against the same steps without it; (c) 2 NCCL ranks when two cards are
    visible. Returns {"ring": {label: record}, "step": the torchrun
    record}."""
    gpu = card()
    t0 = time.perf_counter()
    out = {"ring": _dist_ring(gpu)}
    log(f"[dist] {gpu}: ring phase (a) {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    args = ["--steps", str(DIST_STEPS), "--batch", str(DIST_BATCH)]
    out["step"], ref, spread = _dist_torchrun(gpu, args)
    log(f"[dist] {gpu}: phase (b) {time.perf_counter() - t1:.1f} s")
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"dist: multi-rank NCCL not run: {cards} card visible")
    else:
        out["multi"] = _dist_two_ranks(gpu, args, ref, spread)
    log(f"[dist] {gpu}: phase dist {time.perf_counter() - t0:.1f} s")
    return out


MAISI_FLASH = [(1, 32768, 8, 32), (1, 4096, 16, 32)]  # MAISI's sites at a 128^3 latent
PEAK_EXP = 3.9e12  # exponentials a second on the special-function units (16 a clock an SM)
MAISI_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
                            "maisi_ct3d.json")
PLAIN_CHUNK = 4096  # query rows a chunk of the plain versions timed at MAISI's sites


def _plain_ms(q, k, v, do, scale):
    """ms of the plain forward and of the plain backward (dQ pass, then the
    dK/dV pass over every key) over every query row, PLAIN_CHUNK rows at a
    time: the whole fp32 scores of (1, 32768, 8, 32) would take 34 GB."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    B, S, H, _ = q.shape
    o, lse = fa.flash_attention(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, S)
    keys = torch.arange(S, device=q.device)

    def fwd():
        for i in range(0, S, PLAIN_CHUNK):
            fa.flash_attention_plain(q[:, i:i + PLAIN_CHUNK], k, v, scale)

    def bwd():
        for i in range(0, S, PLAIN_CHUNK):
            rows = slice(i, i + PLAIN_CHUNK)
            lse_rows = lse.reshape(B, H, S)[:, :, rows].reshape(B * H, -1)
            fa.flash_bwd_dq_plain(q[:, rows], k, v, o[:, rows], lse_rows, do[:, rows], scale)
        fa.flash_bwd_dkdv_plain_chunked(q, k, v, do, lse, delta, scale, keys, PLAIN_CHUNK)

    return time_ms(fwd, 1, 3), time_ms(bwd, 1, 3)


def phase_maisi():
    """MAISI's flash sites (the narrow kernels) against the plain versions,
    beside SDPA, the tensor-core bound and the exponentials' bound, then one
    LDM step on precomputed latents at its published widths; returns
    {"kernels": {kernel: [record]}, "per_step": {kernel: launches}, "step_ms",
    "peak_gib"}."""
    import torch.nn.functional as F

    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    gpu = card()
    gen = torch.Generator(device="cuda").manual_seed(41)
    cpu_gen = torch.Generator().manual_seed(42)
    t_phase = time.perf_counter()
    kernels = {}
    for shape in MAISI_FLASH:
        for dt in (torch.bfloat16, torch.float32):
            before = kernel_table.launches()
            rec, line = _flash_ddpm_case(*shape, dt, gen, cpu_gen, True, label="maisi")
            ran = {k: n - before[k] for k, n in kernel_table.launches().items()
                   if k.startswith("flash") and n > before[k]}
            narrow = fa.takes_narrow(dt, shape[3])
            design = {k + ("_narrow" if narrow else "") for k in ("flash_attn_fwd",
                                                                  "flash_attn_bwd_dq",
                                                                  "flash_attn_bwd_dkdv")}
            if set(ran) != design:
                raise AssertionError(f"[maisi] {shape} {dt}: launches {ran}, expected of "
                                     f"{sorted(design)} alone")
            if narrow:  # the records are the narrow kernels'
                exp_ms = shape[0] * shape[2] * shape[1] ** 2 / PEAK_EXP * 1e3
                rec = {f"{k}_narrow": dict(r, exp_bound_ms=exp_ms) for k, r in rec.items()}
                line += f" | exp bound ms={exp_ms:.3f} a pass; launches {ran}"
            if dt == torch.bfloat16:
                q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                               for _ in range(4))
                fwd_ms, bwd_ms = _plain_ms(q, k, v, do, shape[3] ** -0.5)
                del q, k, v, do
                rec["flash_attn_fwd_narrow"]["plain_ms"] = fwd_ms
                for name in ("flash_attn_bwd_dq_narrow", "flash_attn_bwd_dkdv_narrow"):
                    rec[name]["plain_ms"] = bwd_ms  # the two plain passes together
                line += (f" | plain (fp32, {PLAIN_CHUNK} query rows a chunk, every row) fwd "
                         f"ms={fwd_ms:.3f} bwd (dQ + dK/dV) ms={bwd_ms:.3f}")
            log(f"[maisi] {gpu}: flash {line} OK")
            for name, r in rec.items():
                kernels.setdefault(name, []).append(r)
            torch.cuda.empty_cache()
    flash_checked("fwd", MAISI_FLASH)
    flash_checked("bwd", MAISI_FLASH)

    with open(MAISI_CONFIG) as f:
        cfg = json.load(f)["config"]
    dev = torch.device("cuda")
    trainer = LDMTrainer.from_config(cfg, None, device=dev, dtype=torch.bfloat16, seed=0,
                                     latent_space_type="precomputed")
    randomize_(trainer.unet, 4331)  # every layer, the zero-initialised output conv too
    unet = trainer.unet
    z = torch.randn((1, 128, 128, 128, 4), generator=gen, device=dev)
    scale_factor, _ = trainer.probe_latent(z)
    cond = {"top_region_index_tensor": F.one_hot(torch.tensor([1]), 4).float(),
            "bottom_region_index_tensor": F.one_hot(torch.tensor([2]), 4).float(),
            "spacing_tensor": torch.tensor([[0.8, 0.8, 2.5]])}
    attn = sum(isinstance(m, AttentionBlock) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNorm) for m in unet.modules())
    per_step = {"flash_attn_fwd_narrow": attn, "flash_attn_bwd_dq_narrow": attn,
                "flash_attn_bwd_dkdv_narrow": attn, "gn_stats_fold": n_gn, "gn_affine_act": n_gn,
                "gn_bwd_stats": n_gn, "gn_bwd_apply": n_gn, **opt_launches(trainer.opt)}
    expect = launches(**per_step)
    n_params = sum(p.numel() for p in trainer.params)
    trainer.train_step(z, cond=cond)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with flash_capture() as seen, gn_recorder() as gns:
        kernel_table.reset()
        loss = trainer.train_step(z, cond=cond)
        torch.cuda.synchronize()
        counts = kernel_table.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    copies = (kernel_table.total("input_copies"), kernel_table.read("gn_bwd_apply.grad_copies"),
              kernel_table.read("adamw_update.grad_copies"))
    scalar = _scalar_launches()
    step_ms = time_ms(lambda: trainer.train_step(z, cond=cond), 1, 3)
    expect_seen = {(kind, s, s[1]) for kind in ("fwd", "bwd") for s in MAISI_FLASH}
    missing = seen - FLASH_CHECKED
    gn_missing = {s[1:] for s in gns} - set(GN_SHAPES)
    finite = math.isfinite(float(loss))
    log(f"[maisi] {gpu}: LDMTrainer on precomputed latents, U-Net "
        f"{cfg['ddpm_params']['num_channels']} with heads of 32 ({n_params:,} params, bf16, "
        f"seeded weights), batch 1 of (128, 128, 128, 4), scale_factor {scale_factor:.5f}: "
        f"loss {float(loss):.5f}; one step's launches {counts} (predicted {expect}: "
        f"{attn} attention, each pass on the narrow kernels, {n_gn} GroupNorm); flash calls "
        f"{sorted(seen)} (unchecked {sorted(missing)}); GroupNorm shapes {len(gns)} (not in "
        f"GN_SHAPES {sorted(gn_missing)}); copies (flash inputs, GroupNorm gradients, optimizer "
        f"gradients) {copies}; GroupNorm launches without 16-byte loads {scalar}; "
        f"{step_ms:.3f} ms a step (CUDA events, median of 3); peak "
        f"{peak:.3f} GiB")
    if (counts != expect or attn != 11 or n_gn != 56 or seen != expect_seen or missing
            or gn_missing or any(copies) or any(scalar.values()) or not finite):
        raise AssertionError("[maisi] the step's launches, flash or GroupNorm shapes, copies "
                             "or loss are not as predicted (see the line above)")
    del trainer, unet, z
    torch.cuda.empty_cache()
    log(f"[maisi] {gpu}: phase {time.perf_counter() - t_phase:.1f} s")
    return {"kernels": kernels, "per_step": expect, "step_ms": step_ms, "peak_gib": peak}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def done(name):
        log(f"[env] phase {name} done at {time.perf_counter() - t0:.1f} s")

    install_flash_recorder()
    phase_build()
    rec = phase_kernels()
    flash_checked("fwd", FLASH_SHAPES)
    rec.update(phase_kernels_bwd())
    flash_checked("bwd", FLASH_SHAPES + BWD_SHAPES)
    if "--maisi" in sys.argv[1:]:
        maisi = phase_maisi()
        check_flash_listed()
        log(f"[env] total {time.perf_counter() - t0:.1f} s")
        print(card())
        print(json.dumps({"maisi": maisi}))
        return 0
    rec_2d, worst_2d = phase_kernels_2d()
    flash_checked("fwd", FLASH_SHAPES_2D + FLASH_FWD_SHAPES_2D)
    flash_checked("bwd", FLASH_SHAPES_2D)
    done("kernels_2d")
    with flash_capture() as parity_shapes:  # kernels held to the CPU's plain versions
        phase_parity()
        phase_parity_train()
    FLASH_CHECKED.update(parity_shapes)
    phase_slice()
    counts, per_step, train_ms, opt_3d = phase_train()
    done("train")
    with flash_capture() as parity_shapes:
        phase_ae_parity()
    FLASH_CHECKED.update(parity_shapes)
    ae, ae_per = phase_ae_train()
    t2d = phase_train_2d()
    done("train_2d")
    maisi = phase_maisi()
    done("maisi")
    ddpm = phase_ddpm_train()
    done("ddpm_train")
    rec_ddpm = phase_kernels_ddpm(ddpm)
    done("kernels_ddpm")
    dist = phase_dist()
    done("dist")
    with cli_workspace() as ws:
        phase_ae_cli(ws, ae_per)
        done("ae_cli")
        aug_cond = phase_aug_cond(ws)
        done("aug_cond")
        cli_counts, eval3d = phase_cli(ws, counts, train_ms)
        done("cli")
        eval2d = phase_cli_2d(ws)
        done("cli_2d")
        plan = phase_plan(ws)
        done("plan")
        ddpm_cli = phase_ddpm_cli(ws, ddpm)
        done("ddpm_cli")
    check_flash_listed()
    log(f"[env] total {time.perf_counter() - t0:.1f} s")
    print(card())
    src = "medical_image_generation_tpu_torch/csrc/"
    jax_ops = "medical_image_generation_tpu/ops/"
    meta = {
        "flash_attn_fwd": (src + "flash_attn_fwd.cu", jax_ops + "pallas_attention.py:153"),
        "flash_attn_bwd_dq": (src + "flash_attn_bwd.cu", jax_ops + "pallas_attention.py:326"),
        "flash_attn_bwd_dkdv": (src + "flash_attn_bwd.cu", jax_ops + "pallas_attention.py:326"),
        "gn_stats_fold": (src + "groupnorm.cu", jax_ops + "pallas_groupnorm.py:107 + "
                          + jax_ops + "pallas_groupnorm.py:226"),
        "gn_affine_act": (src + "groupnorm.cu", jax_ops + "pallas_groupnorm.py:204"),
        "gn_bwd_stats": (src + "groupnorm_bwd.cu", jax_ops + "pallas_groupnorm.py:372"),
        "gn_bwd_apply": (src + "groupnorm_bwd.cu", jax_ops + "pallas_groupnorm.py:372"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        ae_ms, ae_bound = ae[True][f"{name}_step"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], **rec[name], **per_step[name],
                        "cli_launches": cli_counts[name], "ae_launches": ae[True]["counts"][name],
                        "ae_step_ms": ae_ms, "ae_step_bound_ms": ae_bound,
                        "launches_2d": {"ldm_step": t2d["ldm"]["per_step"][name],
                                        "ae_step": t2d["ae_1"]["per_step"][name],
                                        "eval": eval2d[name], "eval_3d": eval3d[name]},
                        "step_ms_2d": {"ldm": t2d["ldm"]["step"][name],
                                       "ae": t2d["ae_1"]["step"][name]},
                        "shapes_2d": [{k: r[k] for k in ("shape", "ms", "bound_ms")}
                                      for r in rec_2d.get(name, [])],
                        "launches_plan": {rung: plan[rung][name] for rung in REMAT_RUNGS},
                        "worst_ms_over_bound_2d": worst_2d.get(name),
                        "launches_ddpm": {"step_2d": ddpm[2]["per_step"][name],
                                          "step_3d": ddpm[3]["per_step"][name],
                                          "sample_2d": ddpm[2]["samples"][16]["counts"][name],
                                          "sample_3d": ddpm[3]["samples"][1]["counts"][name],
                                          "cli_epoch_2d": ddpm_cli[2][name],
                                          "cli_epoch_3d": ddpm_cli[3][name]},
                        "step_ms_ddpm": {"2d": ddpm[2]["step"][name],
                                         "3d": ddpm[3]["step"][name]},
                        "shapes_ddpm": [{k: r[k] for k in ("shape", "ms", "bound_ms")}
                                        for r in rec_ddpm.get(name, [])],
                        "launches_aug_cond": {"ae_step": aug_cond["ae"]["per_step"][name],
                                              "ldm_step": aug_cond["ldm"]["per_step"][name]},
                        "step_ms_aug_cond": {"ae": aug_cond["ae"]["step"][name],
                                             "ldm": aug_cond["ldm"]["step"][name]},
                        "shapes_context": [{k: r[k] for k in ("shape", "Sk", "ms", "bound_ms")}
                                           for r in aug_cond["context"]["kernels"].get(name, [])],
                        "launches_context": aug_cond["context"]["launches"][name],
                        "launches_ring": {label: r["launches"][name]
                                          for label, r in dist["ring"].items()},
                        "launches_dist_step": dist["step"]["launches"][name],
                        "launches_maisi": maisi["per_step"][name],
                        "shapes_maisi": [{k: r[k] for k in ("shape", "dtype", "ms", "bound_ms",
                                                            "plain_ms", "library_ms")}
                                         for r in maisi["kernels"].get(name, [])]})
    for name, source, replaces in (
            ("flash_attn_fwd_narrow", "flash_attn_narrow_fwd.cu", "pallas_attention.py:153"),
            ("flash_attn_bwd_dq_narrow", "flash_attn_narrow_bwd.cu", "pallas_attention.py:326"),
            ("flash_attn_bwd_dkdv_narrow", "flash_attn_narrow_bwd.cu", "pallas_attention.py:326")):
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": jax_ops + replaces, "launches": counts[name],
                        "launches_maisi": maisi["per_step"][name],
                        "shapes_maisi": [{k: r[k] for k in ("shape", "dtype", "ms", "bound_ms",
                                                            "exp_bound_ms", "plain_ms",
                                                            "library_ms")}
                                         for r in maisi["kernels"].get(name, [])]})
    for name in ("sq_norm", "adamw_update"):  # clip + AdamW: no TPU kernel to replace
        kernels.append({"name": name, "route": "cuda", "source": src + "adamw.cu",
                        "replaces": None, "launches": counts[name], **per_step[name],
                        "flagship_3d": opt_3d[name], "flagship_2d": t2d["opt"][name],
                        "optimizer_check": {"3d": opt_3d, "2d": t2d["opt"]},
                        "cli_launches": cli_counts[name],
                        "ae_launches": ae[True]["counts"][name],
                        "launches_2d": {"ldm_step": t2d["ldm"]["per_step"][name],
                                        "ae_step": t2d["ae_1"]["per_step"][name]},
                        "step_ms_2d": {"ldm": t2d["ldm"]["step"][name],
                                       "ae": t2d["ae_1"]["step"][name]},
                        "launches_plan": {rung: plan[rung][name] for rung in REMAT_RUNGS},
                        "launches_ddpm": {"step_2d": ddpm[2]["per_step"][name],
                                          "step_3d": ddpm[3]["per_step"][name],
                                          "cli_epoch_2d": ddpm_cli[2][name],
                                          "cli_epoch_3d": ddpm_cli[3][name]},
                        "launches_aug_cond": {"ae_step": aug_cond["ae"]["per_step"][name],
                                              "ldm_step": aug_cond["ldm"]["per_step"][name]},
                        "launches_dist_step": dist["step"]["launches"][name],
                        "launches_maisi": maisi["per_step"][name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
