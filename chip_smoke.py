#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises and exits non-zero):

1. build        -- compile every kernel in medical_image_generation_tpu_torch/csrc
                   with nvcc (one process per source, in parallel), print each
                   instantiation's registers and spills, and check in the SASS
                   (cuobjdump) that every bf16 flash forward, dQ and dK/dV
                   kernel issues HGMMA (wgmma).
2. kernels      -- each forward kernel against its plain PyTorch version on
                   CUDA tensors at the flagship path's shapes, bf16 and fp32:
                   max error against a stated tolerance, and median kernel /
                   plain / library times (CUDA events) beside the card's bound
                   (flash: TFLOP/s and the ratio to SDPA at both sites);
                   GroupNorm stats must take its 16-byte loads at every
                   flagship shape and give the same bits twice.
3. kernels_bwd  -- the same for the backward kernels (flash dQ and dK/dV,
                   GroupNorm(+SiLU) backward stats and apply); dQ (with
                   delta), dK/dV and both GroupNorm backward passes must give
                   the same bits twice, and the GroupNorm backward must take
                   its 16-byte loads at every flagship shape.
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
                   the bound summed over the step's launches), then
                   save_checkpoint and sample one volume from it through
                   LDMSampler.from_config.

The last two lines of standard output are the kernels' JSON record (launches
counted on the train path) and the device record; the card's name and power
limit are printed before them.
"""

from __future__ import annotations

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

GN_SHAPES = [  # (M, C, groups) of every GroupNorm on the flagship paths, batch 2
    (32768, 256, 32), (32768, 768, 32), (4096, 512, 32), (4096, 1280, 32),
    (512, 768, 32), (512, 1536, 32), (32768, 128, 16), (262144, 64, 16),
    (2097152, 32, 16)]
FLASH_SHAPES = [(2, 4096, 1, 512), (2, 512, 1, 768), (2, 1000, 3, 96)]  # (B, S, H, D)
FLAGSHIP_FLASH = FLASH_SHAPES[:2]  # the U-Net's two attention sites
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
    check_hgmma(_build)


def check_hgmma(build):
    """Every instantiation of the bf16 flash forward, dQ and dK/dV kernels
    must issue HGMMA (wgmma) in its SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel in (("flash_attn_fwd", "flash_fwd_bf16"), ("flash_attn_bwd", "flash_bwd_dq_bf16"),
                        ("flash_attn_bwd", "flash_bwd_dkdv_bf16")):
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

    # ---- GroupNorm stats + affine(+SiLU): (B, M, C) activations, groups
    B = 2
    for (M, C, G) in GN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((B, M, C), generator=gen, device="cuda") * 1.3 + 0.7).to(dt)
            vec0 = gn.channel_stats.vector_launches
            st = gn.channel_stats(x)
            vec_path = gn.channel_stats.vector_launches == vec0 + 1
            st_ref = gn.channel_stats_plain(x)
            # no float atomics, fixed summation order
            st_same = torch.equal(st, gn.channel_stats(x))
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
            ok = srel <= STATS_REL_TOL and a_ok and ferr <= FOLD_REL_TOL and st_same and vec_path
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
                f"stats rel_err={srel:.3e} (tol {STATS_REL_TOL:g}) 16-byte loads={vec_path} "
                f"bit-identical on a rerun={st_same} ms={s_ms:.4f} plain_ms={s_plain:.4f} "
                f"var_mean_ms={s_lib:.4f} bound_ms={s_bound:.4f} ({s_bound / s_ms:.2f} of the "
                f"bound's rate) | fold rel_err={ferr:.3e} "
                f"(tol {FOLD_REL_TOL:g}) ms={f_ms:.4f} plain_ms={f_plain:.4f} "
                f"bound_ms={f_bound:.5f} | affine+silu "
                f"max_abs_err={aerr:.3e} (tol {atol:g} + {rtol:g}*|y|) ms={a_ms:.4f} plain_ms={a_plain:.4f} "
                f"bound_ms={a_bound:.4f} | F.group_norm+F.silu ms={lib_ms:.4f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"GroupNorm kernels disagree at {(B, M, C)} {dt}: "
                                     f"stats {srel} (same bits on a rerun {st_same}, 16-byte "
                                     f"loads {vec_path}), fold {ferr}, affine {aerr}")
            if dt == torch.bfloat16:  # every GroupNorm shape, (2, 32768, 256) first
                add_record(rec, "gn_channel_stats", dict(
                    shape=[B, M, C], dtype="bf16", max_abs_err=serr, ms=s_ms, plain_ms=s_plain,
                    bound_ms=s_bound, bound_by="bytes", library_ms=s_lib))
            if (M, C) == (32768, 256) and dt == torch.bfloat16:
                rec["gn_fold_affine"] = dict(
                    shape=[B, C], dtype="fp32", max_abs_err=max(_err(A, rA), _err(bb, rbb)),
                    ms=f_ms, plain_ms=f_plain, bound_ms=f_bound, bound_by="bytes",
                    library_ms=None)
                rec["gn_affine_act"] = dict(
                    shape=[B, M, C], dtype="bf16", max_abs_err=aerr, ms=a_ms, plain_ms=a_plain,
                    bound_ms=a_bound, bound_by="bytes", library_ms=lib_ms)
    return rec


def phase_kernels_bwd():
    """The backward kernels against their plain versions; returns
    {kernel: record at its representative shape}."""
    import torch.nn.functional as F

    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = {}

    # ---- flash backward: dQ pass, then dK/dV pass
    for (B, S, H, D) in FLASH_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
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
                         f" plain_ms={plain_kv:.4f} bound_ms={b_kv[0]:.4f} ({b_kv[1]}; "
                         f"{8 * fl / ms_kv / 1e9:.1f} TFLOP/s) | pair ms={ms_dq + ms_kv:.4f} "
                         f"bound_ms={b_all[0]:.4f} ({b_all[1]}, 5 S^2 D matmuls) | SDPA "
                         f"backward (fwd+bwd - fwd) ms={lib_ms:.4f} (pair "
                         f"{(ms_dq + ms_kv) / lib_ms:.2f}x its time), top kernel {backend!r}")
                if (B, S, H, D) in FLAGSHIP_FLASH:
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
            st = gn.channel_stats_plain(x)
            A, bb = gn.fold_affine_plain(st, w, b, G, M, 1e-6)
            for silu in (False, True):
                vec0 = (gn.gn_bwd_stats.vector_launches, gn.gn_bwd_apply.vector_launches)
                coef, ds, db = gn.gn_bwd_stats(x, g, A, bb, st, w, G, 1e-6, silu)
                dx = gn.gn_bwd_apply(x, g, A, bb, coef, silu)
                vec_path = (gn.gn_bwd_stats.vector_launches,
                            gn.gn_bwd_apply.vector_launches) == (vec0[0] + 1, vec0[1] + 1)
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
                line = (f"[kernels_bwd] gn_bwd {str(dt)[6:]} silu={silu} B={B} M={M} C={C}: "
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


def _train_config(tiny):
    from medical_image_generation_tpu_torch.planning.planner import (
        create_config_dict,
        flagship_configs,
    )

    vae_p, ddpm_p, image = flagship_configs(tiny=tiny)
    ds = {"median_shape": tuple(image), "max_shape": tuple(image)}
    return create_config_dict(ds, [0], 1, vae_p, ddpm_p)


def _counters():
    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    return {"flash_attn_fwd": fa.flash_attention, "flash_attn_bwd_dq": fa.flash_bwd_dq,
            "flash_attn_bwd_dkdv": fa.flash_bwd_dkdv, "gn_channel_stats": gn.channel_stats,
            "gn_fold_affine": gn.fold_affine, "gn_affine_act": gn.affine_act,
            "gn_bwd_stats": gn.gn_bwd_stats, "gn_bwd_apply": gn.gn_bwd_apply}


def _reset_counts():
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    for fn in _counters().values():
        fn.launches = 0
    fa.flash_attention.input_copies = fa.flash_bwd_dq.input_copies = 0
    fa.flash_bwd_dkdv.input_copies = 0
    for fn in (gn.channel_stats, gn.gn_bwd_stats, gn.gn_bwd_apply):
        fn.vector_launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _input_copies():
    """Inputs the flash wrappers had to copy before TMA could load them."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa

    return (fa.flash_attention.input_copies + fa.flash_bwd_dq.input_copies
            + fa.flash_bwd_dkdv.input_copies)


def _scalar_stats():
    """Channel-stats launches since the last reset that did not take the
    16-byte loads."""
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    return gn.channel_stats.launches - gn.channel_stats.vector_launches


def _scalar_bwd():
    """{GroupNorm backward wrapper: launches since the last reset that did not
    take the 16-byte loads}."""
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    return {name: fn.launches - fn.vector_launches
            for name, fn in (("gn_bwd_stats", gn.gn_bwd_stats), ("gn_bwd_apply", gn.gn_bwd_apply))}


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
    fwd = ("flash_attn_fwd", "gn_channel_stats", "gn_fold_affine", "gn_affine_act")
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
    loss_c = cpu.train_step(x, draws=draws)
    _reset_counts()
    loss_g = gpu.train_step(x.cuda(), draws=draws)
    torch.cuda.synchronize()
    counts = _read_counts()
    l_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    names = [n for n, p in cpu.unet.named_parameters() if p.requires_grad]
    g_err = max(_err(pg.grad.cpu(), pc.grad) / max(pc.grad.abs().max().item(), 1e-30)
                for pc, pg in zip(cpu.params, gpu.params))
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
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel did not launch in the GPU train step: {counts}")


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

    _reset_counts()
    t0 = time.perf_counter()
    images = sampler.sample(B, sampler="ddim", num_inference_steps=steps, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _read_counts()
    copies = _input_copies()
    scalar = _scalar_stats()

    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expect = {k: 0 for k in counts}
    expect.update({"flash_attn_fwd": flash_per_fwd * steps,
                   "gn_channel_stats": gn_per_fwd * steps + gn_per_decode,
                   "gn_fold_affine": gn_per_fwd * steps + gn_per_decode,
                   "gn_affine_act": gn_per_fwd * steps + gn_per_decode})
    log(f"[slice] launches per U-Net forward: flash {flash_per_fwd}, GroupNorm {gn_per_fwd}; "
        f"per decode: GroupNorm {gn_per_decode}; {steps} DDIM steps + decode: counted "
        f"{counts}, expected {expect}; flash inputs copied for TMA: {copies}; channel-stats "
        f"launches without 16-byte loads: {scalar}")
    finite = bool(torch.isfinite(torch.from_numpy(images)).all())
    shape_ok = images.shape == (B, *image, 1)
    spread = float(images.std())
    log(f"[slice] images shape={images.shape} finite={finite} min={images.min():.4f} "
        f"max={images.max():.4f} std={spread:.4f}")
    if counts != expect or flash_per_fwd != 11 or copies or scalar:
        raise AssertionError(f"launch counts {counts} != expected {expect}, or {copies} "
                             f"flash inputs copied, or {scalar} scalar channel-stats launches")
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
    """The flagship train step; returns the launch counts of the timed steps."""
    from medical_image_generation_tpu_torch.data.augment import augment_batch
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm
    from medical_image_generation_tpu_torch.ops import _build
    from medical_image_generation_tpu_torch.ops import groupnorm as gn
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
    per_step = {"flash_attn_fwd": attn_u + attn_e, "flash_attn_bwd_dq": attn_u,
                "flash_attn_bwd_dkdv": attn_u, "gn_channel_stats": gn_u + gn_e,
                "gn_fold_affine": gn_u + gn_e, "gn_affine_act": gn_u + gn_e,
                "gn_bwd_stats": gn_u, "gn_bwd_apply": gn_u}

    p0 = [p.detach().clone() for p in trainer.params[:4]]
    losses = [trainer.train_step(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    gn.gn_bwd_apply.grad_copies = 0
    t0 = time.perf_counter()
    losses += [trainer.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _read_counts()
    copies = gn.gn_bwd_apply.grad_copies
    flash_copies = _input_copies()
    scalar = _scalar_stats()
    scalar_bwd = _scalar_bwd()
    vec_bwd = {"gn_bwd_stats": gn.gn_bwd_stats.vector_launches,
               "gn_bwd_apply": gn.gn_bwd_apply.vector_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    expect = {k: v * steps for k, v in per_step.items()}
    changed = all(not torch.equal(a, p.detach()) for a, p in zip(p0, trainer.params[:4]))
    log(f"[train] losses {['%.5f' % v for v in losses]}")
    log(f"[train] launches per step predicted {per_step} (U-Net: {attn_u} attention, {gn_u} "
        f"GroupNorm; encoder: {attn_e} attention, {gn_e} GroupNorm); {steps} steps counted "
        f"{counts}, expected {expect}; GroupNorm gradients copied to channels-last: "
        f"{copies / steps:g} a step; flash inputs copied for TMA: {flash_copies}; "
        f"channel-stats launches without 16-byte loads: {scalar}; GroupNorm backward "
        f"launches with 16-byte loads {vec_bwd}, without {scalar_bwd}")
    ms_step = secs * 1e3 / steps
    log(f"[train] {steps} steps in {secs * 1e3:.1f} ms: {ms_step:.3f} ms per step = "
        f"{1e3 / ms_step:.3f} steps/s; peak memory {peak_gb:.2f} GiB; params changed={changed}; "
        f"mu dtype {trainer.opt.mu[0].dtype}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if (counts != expect or attn_u != 11 or gn_u != 46 or gn_e != 13 or flash_copies
            or scalar or copies or any(scalar_bwd.values())):
        raise AssertionError(f"launch counts {counts} != expected {expect}, or {flash_copies} "
                             f"flash inputs copied, or {scalar} scalar channel-stats launches, "
                             f"or {copies} GroupNorm gradients copied, or scalar GroupNorm "
                             f"backward launches {scalar_bwd}")
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
    grads = [p.grad for p in trainer.params]
    opt_ms = time_ms(lambda: trainer.opt.step(grads), 1, 5)
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
                             f"(PORT_KERNELS patterns out of date?): {unseen}")
    for name, b_ms in bounds.items():
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
                    for name, b_ms in bounds.items()}


def step_bounds(trainer, batch):
    """{kernel: least ms the card could take for the kernel's launches in one
    train step}: the bound of each launch, from the shapes that reach the
    GroupNorm and attention modules in one step, summed."""
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm

    seen = []  # (module kind, differentiated, input shape, itemsize)

    def hook_for(kind, grad):
        def hook(mod, args):
            x = args[0]
            seen.append((kind, grad, mod, tuple(x.shape), x.element_size()))
        return hook

    handles = [m.register_forward_pre_hook(hook_for(cls.__name__, grad))
               for net, grad in ((trainer.unet, True), (trainer.vae.encoder, False))
               for m in net.modules() for cls in (GroupNorm, AttentionBlock)
               if isinstance(m, cls)]
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    ms = {k: 0.0 for k in _counters()}
    for kind, grad, mod, shape, isz in seen:
        B, C, M = shape[0], shape[1], math.prod(shape[2:])
        if kind == "GroupNorm":
            ms["gn_channel_stats"] += (B * M * C * isz + B * 2 * C * 4) / PEAK_BYTES * 1e3
            ms["gn_fold_affine"] += (4 * B * C * 4 + 2 * C * 4) / PEAK_BYTES * 1e3
            ms["gn_affine_act"] += (B * M * C * 2 * isz + 2 * B * C * 4) / PEAK_BYTES * 1e3
            if grad:
                ms["gn_bwd_stats"] += (2 * B * M * C * isz + 9 * B * C * 4) / PEAK_BYTES * 1e3
                ms["gn_bwd_apply"] += (3 * B * M * C * isz + 4 * B * C * 4) / PEAK_BYTES * 1e3
        else:
            S, H, D = M, mod.num_heads, mod.head_dim
            fl, n, bhs = B * H * S * S * D, B * S * H * D, B * H * S
            ms["flash_attn_fwd"] += bound(4 * fl, 4 * n * isz + 4 * bhs, PEAK_BF16_FLOPS)[0]
            if grad:
                ms["flash_attn_bwd_dq"] += bound(6 * fl, 6 * n * isz + 8 * bhs,
                                                 PEAK_BF16_FLOPS)[0]
                ms["flash_attn_bwd_dkdv"] += bound(8 * fl, 6 * n * isz + 8 * bhs,
                                                   PEAK_BF16_FLOPS)[0]
    return ms


PORT_KERNELS = {  # profile name patterns of each port kernel, by its counter's name
    "flash_attn_fwd": ("flash_fwd",), "flash_attn_bwd_dq": ("flash_bwd_dq",),
    "flash_attn_bwd_dkdv": ("flash_bwd_dkdv",),
    "gn_channel_stats": ("stats_partial", "stats_reduce"), "gn_fold_affine": ("::fold_kernel",),
    "gn_affine_act": ("::affine_",),
    "gn_bwd_stats": ("gn_bwd_partial_kernel", "gn_bwd_reduce_fold_kernel"),
    "gn_bwd_apply": ("gn_bwd_apply_kernel",),
}


def profile_breakdown(label, fn):
    """One call under torch.profiler: device time by kernel, the port
    kernels' share, and the device's busy share of the call's wall time
    (single stream, so kernels do not overlap); plus the host's enqueue time.
    Returns (device busy ms, {port kernel: device ms})."""
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
        raise AssertionError(f"[profile] {label}: the profiler recorded no device kernels")
    by_name = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy = sum(v[0] for v in by_name.values()) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    owners = {n: [k for k, pats in PORT_KERNELS.items() if any(p in n for p in pats)]
              for n in by_name}
    shared = {n: ks for n, ks in owners.items() if len(ks) > 1}
    if shared:
        raise AssertionError(f"[profile] {label}: kernels matched by two port kernels' "
                             f"patterns: {shared}")
    shares = {k: sum(v[0] for n, v in by_name.items() if owners[n] == [k]) / 1e3
              for k in PORT_KERNELS}
    by_pattern = {p: (sum(v[1] for n, v in by_name.items() if p in n),
                      sum(v[0] for n, v in by_name.items() if p in n) / 1e3)
                  for pats in PORT_KERNELS.values() for p in pats}
    log(f"[profile] {label}: {len(kern)} kernels, device busy {busy:.3f} ms over a "
        f"{span:.3f} ms span (idle share {1 - busy / span:.3f}); host enqueue "
        f"{host_ms:.3f} ms; port kernels ms {({k: round(v, 3) for k, v in shares.items()})}")
    log(f"[profile] {label}: port kernels by name, launches and summed ms "
        f"{({p: (n, round(ms, 4)) for p, (n, ms) in by_pattern.items() if n})}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {us / 1e3:8.3f} ms  x{n:<4d} {name[:110]}")
    return busy, shares


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    rec = phase_kernels()
    rec.update(phase_kernels_bwd())
    phase_parity()
    phase_parity_train()
    phase_slice()
    counts, per_step = phase_train()
    log(f"[env] total {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    src = "medical_image_generation_tpu_torch/csrc/"
    jax_ops = "medical_image_generation_tpu/ops/"
    meta = {
        "flash_attn_fwd": (src + "flash_attn_fwd.cu", jax_ops + "pallas_attention.py:153"),
        "flash_attn_bwd_dq": (src + "flash_attn_bwd.cu", jax_ops + "pallas_attention.py:326"),
        "flash_attn_bwd_dkdv": (src + "flash_attn_bwd.cu", jax_ops + "pallas_attention.py:326"),
        "gn_channel_stats": (src + "groupnorm.cu", jax_ops + "pallas_groupnorm.py:107"),
        "gn_fold_affine": (src + "groupnorm.cu", jax_ops + "pallas_groupnorm.py:226"),
        "gn_affine_act": (src + "groupnorm.cu", jax_ops + "pallas_groupnorm.py:204"),
        "gn_bwd_stats": (src + "groupnorm_bwd.cu", jax_ops + "pallas_groupnorm.py:372"),
        "gn_bwd_apply": (src + "groupnorm_bwd.cu", jax_ops + "pallas_groupnorm.py:372"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], **rec[name], **per_step[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
