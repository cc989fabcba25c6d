#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises and exits non-zero):

1. build    -- compile every kernel in medical_image_generation_tpu_torch/csrc
               with nvcc (one process per source, in parallel).
2. kernels  -- each hand-written kernel against its plain PyTorch version on
               CUDA tensors at the flagship path's shapes, bf16 and fp32:
               max error against a stated tolerance, and median kernel /
               plain / library times (CUDA events) beside the card's bound.
3. parity   -- the tiny 3D config (seeded random weights, fp32) through one
               U-Net forward and one decode on the CPU (plain versions) and
               on the GPU (kernels).
4. slice    -- the flagship 3D LDM at full width (U-Net [256,512,768], VAE
               decoder [32,64,128], bf16, batch 2, seeded random weights in
               every layer): 10 DDIM steps through LDMSampler, then decode to
               (2, 128, 128, 128, 1); checks the output and that every kernel's
               launch count rose by what the code predicts.

The last two lines of standard output are the kernels' JSON record and the
device record; the card's name and power limit are printed before them.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch

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


def randomize_(model, seed):
    """Seeded random values in every parameter, including zero-initialised
    layers: fan-in scaled normals for weights, small normals for biases,
    GroupNorm scale 1 + 0.1 n."""
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm

    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    gn = {id(m.weight) for m in model.modules() if isinstance(m, GroupNorm)}
    with torch.no_grad():
        for p in model.parameters():
            n = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            if id(p) in gn:
                p.copy_(1.0 + 0.1 * n)
            elif p.dim() >= 2:
                p.copy_(n / math.sqrt(p[0].numel()))
            else:
                p.copy_(0.02 * n)


def phase_build():
    from medical_image_generation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} libraries built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def flash_close(o, lse, o_ref, lse_ref, dtype):
    """(o within FLASH_TOL, lse within LSE_TOL, max|o - o_ref|, max|lse - lse_ref|)."""
    rtol, atol = FLASH_TOL[dtype]
    d = (o.float() - o_ref.float()).abs()
    lerr = _err(lse, lse_ref)
    o_ok = bool((d <= atol + rtol * o_ref.float().abs()).all())
    return o_ok, lerr <= LSE_TOL, d.max().item(), lerr


def phase_kernels():
    """Returns {kernel: record at its representative shape}."""
    import torch.nn.functional as F

    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {}

    # ---- flash attention: (B, S, H, D) of the U-Net's attention sites
    for (B, S, H, D) in [(2, 4096, 1, 512), (2, 512, 1, 768), (2, 1000, 3, 96)]:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
                       for _ in range(3))
            scale = D ** -0.5
            o, lse = fa.flash_attention(q, k, v, scale)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
            # each tolerance, o's and lse's, must see a kernel that skips one 64-key K/V tile
            o_cut, lse_cut = fa.flash_attention_plain(q, k[:, 64:], v[:, 64:], scale)
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
            ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            bound, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
            rtol, atol = FLASH_TOL[dt]
            log(f"[kernels] flash_attn_fwd {str(dt)[6:]} B={B} S={S} H={H} D={D}: "
                f"max|o-o_plain|={err:.3e} (tol {atol:g} + {rtol:g}*|o|, max|o_plain|="
                f"{o_ref.float().abs().max().item():.3e}) max|lse-lse_plain|={lerr:.3e} "
                f"(tol {LSE_TOL:g}) one-tile-skip caught={cut_seen} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                f"({bound_by}) ({flops / ms / 1e9:.1f} TFLOP/s) {'OK' if ok and cut_seen else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash attention disagrees with its plain version at "
                                     f"{(B, S, H, D)} {dt}: {err} / {lerr}")
            if not cut_seen:
                raise AssertionError(f"flash tolerance at {(B, S, H, D)} {dt} cannot see a "
                                     "skipped K/V tile")
            if (B, S, H, D) == (2, 4096, 1, 512) and dt == torch.bfloat16:
                rec["flash_attn_fwd"] = dict(
                    shape=[B, S, H, D], dtype="bf16", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)

    # ---- GroupNorm stats + affine(+SiLU): (B, M, C) activations, groups
    gn_shapes = [  # (M, C, groups)
        (32768, 256, 32), (32768, 768, 32), (4096, 512, 32), (4096, 1280, 32),
        (512, 768, 32), (512, 1536, 32), (32768, 128, 16), (262144, 64, 16),
        (2097152, 32, 16)]
    B = 2
    for (M, C, G) in gn_shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((B, M, C), generator=gen, device="cuda") * 1.3 + 0.7).to(dt)
            st = gn.channel_stats(x)
            st_ref = gn.channel_stats_plain(x)
            torch.cuda.synchronize()
            serr = _err(st, st_ref)
            srel = serr / st_ref.abs().max().item()
            w = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
            b = 0.1 * torch.randn(C, generator=gen, device="cuda")
            A, bb = gn.fold_affine(st_ref, w, b, G, M, 1e-6)
            rA, rbb = gn.fold_affine_plain(st_ref, w, b, G, M, 1e-6)
            torch.cuda.synchronize()
            ferr = max(_err(A, rA) / rA.abs().max().item(), _err(bb, rbb) / rbb.abs().max().item())
            y = gn.affine_act(x, A, bb, True)
            y_ref = gn.affine_act_plain(x, A, bb, True)
            torch.cuda.synchronize()
            aerr = _err(y, y_ref)
            rtol, atol = AFFINE_TOL[dt]
            a_ok = bool(((y.float() - y_ref.float()).abs()
                         <= atol + rtol * y_ref.float().abs()).all())
            ok = srel <= STATS_REL_TOL and a_ok and ferr <= FOLD_REL_TOL
            isz = x.element_size()
            s_ms = time_ms(lambda: gn.channel_stats(x))
            s_plain = time_ms(lambda: gn.channel_stats_plain(x), 1, 5)
            s_lib = time_ms(lambda: torch.var_mean(x, dim=1, correction=0))
            f_ms = time_ms(lambda: gn.fold_affine(st, w, b, G, M, 1e-6))
            f_plain = time_ms(lambda: gn.fold_affine_plain(st, w, b, G, M, 1e-6), 1, 5)
            a_ms = time_ms(lambda: gn.affine_act(x, A, bb, True))
            a_plain = time_ms(lambda: gn.affine_act_plain(x, A, bb, True), 1, 5)
            xl = x.permute(0, 2, 1)  # (B, C, M) view of the same buffer
            lib_ms = time_ms(lambda: F.silu(F.group_norm(xl, G, w.to(dt), b.to(dt), 1e-6)))
            s_bound = (B * M * C * isz + B * 2 * C * 4) / PEAK_BYTES * 1e3
            a_bound = (B * M * C * 2 * isz + 2 * B * C * 4) / PEAK_BYTES * 1e3
            f_bound = (4 * B * C * 4 + 2 * C * 4) / PEAK_BYTES * 1e3
            log(f"[kernels] groupnorm {str(dt)[6:]} B={B} M={M} C={C}: "
                f"stats rel_err={srel:.3e} (tol {STATS_REL_TOL:g}) ms={s_ms:.4f} "
                f"plain_ms={s_plain:.4f} var_mean_ms={s_lib:.4f} bound_ms={s_bound:.4f} | fold rel_err={ferr:.3e} "
                f"(tol {FOLD_REL_TOL:g}) ms={f_ms:.4f} plain_ms={f_plain:.4f} "
                f"bound_ms={f_bound:.5f} | affine+silu "
                f"max_abs_err={aerr:.3e} (tol {atol:g} + {rtol:g}*|y|) ms={a_ms:.4f} plain_ms={a_plain:.4f} "
                f"bound_ms={a_bound:.4f} | F.group_norm+F.silu ms={lib_ms:.4f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"GroupNorm kernels disagree at {(B, M, C)} {dt}: "
                                     f"stats {srel}, fold {ferr}, affine {aerr}")
            if (M, C) == (32768, 256) and dt == torch.bfloat16:
                rec["gn_channel_stats"] = dict(
                    shape=[B, M, C], dtype="bf16", max_abs_err=serr, ms=s_ms, plain_ms=s_plain,
                    bound_ms=s_bound, bound_by="bytes", library_ms=s_lib)
                rec["gn_fold_affine"] = dict(
                    shape=[B, C], dtype="fp32", max_abs_err=max(_err(A, rA), _err(bb, rbb)),
                    ms=f_ms, plain_ms=f_plain, bound_ms=f_bound, bound_by="bytes",
                    library_ms=None)
                rec["gn_affine_act"] = dict(
                    shape=[B, M, C], dtype="bf16", max_abs_err=aerr, ms=a_ms, plain_ms=a_plain,
                    bound_ms=a_bound, bound_by="bytes", library_ms=lib_ms)
    return rec


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


def _counters():
    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    return {"flash_attn_fwd": fa.flash_attention, "gn_channel_stats": gn.channel_stats,
            "gn_fold_affine": gn.fold_affine, "gn_affine_act": gn.affine_act}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


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
        _reset_counts()
        eps_gpu, img_gpu = unet_g(x.cuda(), t.cuda()), vae_g.decode(x.cuda())
        torch.cuda.synchronize()
    counts = _read_counts()
    tol = 1e-4  # fp32 everywhere (TF32 off); summation order only
    e1 = _err(eps_gpu.cpu(), eps_cpu) / max(1.0, eps_cpu.abs().max().item())
    e2 = _err(img_gpu.cpu(), img_cpu) / max(1.0, img_cpu.abs().max().item())
    log(f"[parity] tiny 3D config fp32, CPU plain vs GPU kernels: unet err={e1:.3e} "
        f"decode err={e2:.3e} (max abs / max(1, max|ref|), tol {tol:g}); "
        f"GPU launches {counts}")
    if not (e1 <= tol and e2 <= tol and all(v > 0 for v in counts.values())):
        raise AssertionError("tiny-config CPU/GPU parity failed")


def phase_slice(steps=10):
    from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.training.sample import LDMSampler

    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    unet, vae, latent, ddpm_p, image = _build_models(torch.bfloat16, dev, False, 1234)
    n_params = sum(p.numel() for p in unet.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    log(f"[slice] flagship U-Net {ddpm_p['num_channels']} params={n_params:,}; VAE decoder "
        f"params={n_vae:,}; latent {latent}x{ddpm_p['in_channels']} -> image {image}; bf16 batch 2")
    B = 2
    sampler = LDMSampler(unet, vae, NoiseSchedule.create(device=dev), scale_factor=1.0,
                         latent_shape=(B, *latent, ddpm_p["in_channels"]), device=dev)

    def count(mod, cls):
        return sum(isinstance(m, cls) for m in mod.modules())

    flash_per_fwd = count(unet, AttentionBlock)
    gn_per_fwd = count(unet, GroupNorm)
    gn_per_decode = count(vae, GroupNorm)
    gen = torch.Generator(device=dev).manual_seed(0)
    sampler.sample(B, sampler="ddim", num_inference_steps=2, generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    t0 = time.perf_counter()
    images = sampler.sample(B, sampler="ddim", num_inference_steps=steps, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _read_counts()

    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expect = {"flash_attn_fwd": flash_per_fwd * steps,
              "gn_channel_stats": gn_per_fwd * steps + gn_per_decode,
              "gn_fold_affine": gn_per_fwd * steps + gn_per_decode,
              "gn_affine_act": gn_per_fwd * steps + gn_per_decode}
    log(f"[slice] launches per U-Net forward: flash {flash_per_fwd}, GroupNorm {gn_per_fwd}; "
        f"per decode: GroupNorm {gn_per_decode}; {steps} DDIM steps + decode: counted "
        f"{counts}, expected {expect}")
    finite = bool(torch.isfinite(torch.from_numpy(images)).all())
    shape_ok = images.shape == (B, *image, 1)
    spread = float(images.std())
    log(f"[slice] images shape={images.shape} finite={finite} min={images.min():.4f} "
        f"max={images.max():.4f} std={spread:.4f}")
    if counts != expect or flash_per_fwd != 11:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
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
        profile_breakdown("U-Net forward", lambda: unet(x, t))
        profile_breakdown("decode", lambda: sampler.decode(x))
    return counts


def profile_breakdown(label, fn):
    """One call under torch.profiler: device time by kernel, the three port
    kernels' share, and the device's busy share of the call's wall time
    (single stream, so kernels do not overlap); plus the host's enqueue time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log(f"[profile] {label}: the profiler recorded no device kernels")
        return
    by_name = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy = sum(v[0] for v in by_name.values()) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    port = {"flash_attn": "flash_fwd", "gn_stats": "stats_", "gn_fold": "fold_kernel",
            "gn_affine": "affine"}
    shares = {k: sum(v[0] for n, v in by_name.items() if pat in n) / 1e3
              for k, pat in port.items()}
    log(f"[profile] {label}: {len(kern)} kernels, device busy {busy:.3f} ms over a "
        f"{span:.3f} ms span (idle share {1 - busy / span:.3f}); host enqueue "
        f"{host_ms:.3f} ms; port kernels ms {({k: round(v, 3) for k, v in shares.items()})}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {us / 1e3:8.3f} ms  x{n:<4d} {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    rec = phase_kernels()
    phase_parity()
    counts = phase_slice()
    log(f"[env] total {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    src = "medical_image_generation_tpu_torch/csrc/"
    meta = {
        "flash_attn_fwd": (src + "flash_attn_fwd.cu",
                           "medical_image_generation_tpu/ops/pallas_attention.py:153"),
        "gn_channel_stats": (src + "groupnorm.cu",
                             "medical_image_generation_tpu/ops/pallas_groupnorm.py:107"),
        "gn_fold_affine": (src + "groupnorm.cu",
                           "medical_image_generation_tpu/ops/pallas_groupnorm.py:226"),
        "gn_affine_act": (src + "groupnorm.cu",
                          "medical_image_generation_tpu/ops/pallas_groupnorm.py:204"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], **rec[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
