"""A/B timing of two builds of the port's flash-attention and GroupNorm
kernels on one GPU.

    git archive <commit> medical_image_generation_tpu_torch/csrc | tar -x -C build/parent
    python3 -m medical_image_generation_tpu_torch.bench.kernel_ab \\
        --parent build/parent/medical_image_generation_tpu_torch/csrc

Builds ``flash_attn_fwd.cu``, ``flash_attn_bwd.cu``, ``groupnorm.cu`` and
``groupnorm_bwd.cu`` from the parent's ``csrc`` directory and from this
checkout's, calls both through the C entry points (``medimgen_flash_attn_fwd``,
``medimgen_flash_attn_bwd_dq``, ``medimgen_flash_attn_bwd_dkdv``,
``medimgen_gn_channel_stats``, ``medimgen_gn_bwd_stats``,
``medimgen_gn_bwd_apply``) on the same inputs, and times them with CUDA
events around batches of calls back to back, in turns: parent, change,
change, parent. Flash runs in bf16 at the U-Net's two attention sites,
channel stats in bf16 at the largest and the widest-row flagship GroupNorm
shapes, the GroupNorm(+SiLU) backward in bf16 at the U-Net's two largest.
Each build gets the grid its own wrapper gives it. The parent is commit
e562fb4, whose GroupNorm backward entry points take the arguments bound in
``build`` and the grid of ``_parent_bwd_slabs``. PyTorch's SDPA forward and
backward, ``torch.var_mean``, ``F.group_norm``+``F.silu`` backward and
``aten.native_group_norm_backward`` (dscale and dbias only, no SiLU) are
timed beside them as yardsticks. Prints one line per shape and a JSON record
as the last line; needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from medical_image_generation_tpu_torch.ops import _build
from medical_image_generation_tpu_torch.ops import groupnorm as gn

SITES = [(2, 4096, 1, 512), (2, 512, 1, 768)]  # (B, S, H, D) of the U-Net's attention
GN_SITES = [(2, 32768, 256), (2, 2097152, 32)]  # (B, M, C) of two flagship GroupNorms
GN_BWD_SITES = [(2, 32768, 256, 32), (2, 32768, 768, 32)]  # (B, M, C, groups) in the U-Net
SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "groupnorm", "groupnorm_bwd")
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate


def _parent_bwd_slabs(M: int):
    """The parent's (rows per block, blocks along M) of its GroupNorm
    backward stats pass: at least 128 rows, at most ~1024 blocks."""
    rows = max(128, -(-M // 1024))
    return rows, -(-M // rows)


def build(csrc: str, tag: str) -> dict:
    """{name: loaded library} of the sources under ``csrc``."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), f"kernel_ab_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["flash_attn_fwd"].medimgen_flash_attn_fwd.argtypes = (
        [vp] * 5 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, vp])
    for fn in ("medimgen_flash_attn_bwd_dq", "medimgen_flash_attn_bwd_dkdv"):
        getattr(libs["flash_attn_bwd"], fn).argtypes = (
            [vp] * 8 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, vp])
    libs["groupnorm"].medimgen_gn_channel_stats.argtypes = (
        [vp, vp, vp, i32, i64, i32, i32, i64, i32, i32, vp])
    bwd, f32 = libs["groupnorm_bwd"], ctypes.c_float
    if tag == "parent":  # a t scratch, no vec argument; the apply's own flat grid
        bwd.medimgen_gn_bwd_stats.argtypes = (
            [vp] * 11 + [i32, i64, i32, i32, f32, i32, i32, i64, i32, vp])
        bwd.medimgen_gn_bwd_apply.argtypes = [vp] * 6 + [i32, i64, i32, i32, i32, i32, vp]
    else:
        bwd.medimgen_gn_bwd_stats.argtypes = (
            [vp] * 10 + [i32, i64, i32, i32, f32, i32, i32, i64, i32, i32, vp])
        bwd.medimgen_gn_bwd_apply.argtypes = (
            [vp] * 6 + [i32, i64, i32, i32, i32, i64, i32, i32, vp])
    return libs


def time_ms(fn, warmup=5, iters=20, batch=10) -> float:
    """Median ms a call over `iters` CUDA-event pairs, each around `batch`
    calls back to back: each launch's latency hides behind the previous
    call's work, as it does on the model's stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(batch):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / batch)
    return statistics.median(times)


def in_turns(fn) -> dict:
    """{parent, change: mean of two medians, runs: the four medians in order}."""
    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        runs[who].append(time_ms(lambda: fn(who)))
    res = {who: statistics.mean(t) for who, t in runs.items()}
    res["runs"] = runs
    return res


def site(libs: dict, B: int, S: int, H: int, D: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    scale = D ** -0.5
    strides = (q.stride(0), q.stride(1)) * 3
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), device="cuda")
    delta = torch.empty((B * H, S), device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)

    def fwd(who):
        err = libs[who]["flash_attn_fwd"].medimgen_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, S, D,
            1, *strides, scale, 1, stream)
        _build.check(err, f"{who} flash forward")

    def dq_pass(who):
        err = libs[who]["flash_attn_bwd"].medimgen_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, S, D, 1, *strides, scale, 1,
            stream)
        _build.check(err, f"{who} flash dQ")

    def dkdv(who):
        err = libs[who]["flash_attn_bwd"].medimgen_flash_attn_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, S, D, 1, *strides, scale, 1,
            stream)
        _build.check(err, f"{who} flash dK/dV")

    res = {"shape": [B, S, H, D]}
    fwd("change")  # o and lse for the backward passes
    dq_pass("change")  # delta for the dK/dV pass
    for what, fn in (("fwd", fwd), ("dq", dq_pass), ("dkdv", dkdv)):
        res[what] = in_turns(fn)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    sdpa_both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qh, kh, vh, scale=scale), (qh, kh, vh), doh))
    res["sdpa_fwd_ms"], res["sdpa_bwd_ms"] = sdpa_fwd, sdpa_both - sdpa_fwd
    return res


def gn_site(libs: dict, B: int, M: int, C: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((B, M, C), generator=gen, device="cuda") * 1.3 + 0.7).bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the parent's channel-stats grid is this checkout's (unchanged since e562fb4)
    geometry = {who: gn._stats_slabs(B, M, C, 8, sms) for who in ("parent", "change")}
    parts = {who: torch.empty((B, nblk, 2, C), device="cuda")
             for who, (_, nblk) in geometry.items()}
    outs = {who: torch.empty((B, 2, C), device="cuda") for who in geometry}

    def stats(who):
        rows, nblk = geometry[who]
        err = libs[who]["groupnorm"].medimgen_gn_channel_stats(
            x.data_ptr(), parts[who].data_ptr(), outs[who].data_ptr(), B, M, C, 1, rows, nblk, 1,
            stream)
        _build.check(err, f"{who} channel stats")

    res = {"shape": [B, M, C], "stats": in_turns(stats)}
    torch.cuda.synchronize()
    res["max_abs_diff_change_vs_parent"] = (outs["change"] - outs["parent"]).abs().max().item()
    res["var_mean_ms"] = time_ms(lambda: torch.var_mean(x, dim=1, correction=0))
    res["bound_ms"] = (B * M * C * 2 + B * 2 * C * 4) / PEAK_BYTES * 1e3
    return res


def gn_bwd_site(libs: dict, B: int, M: int, C: int, G: int) -> dict:
    """GroupNorm+SiLU backward, bf16: the stats pass and the apply pass of
    both builds, each apply on its own build's [P, Q]."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn((B, M, C), generator=gen, device="cuda") * 1.3 + 0.7).bfloat16()
    g = torch.randn((B, M, C), generator=gen, device="cuda").bfloat16()
    w = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
    st = gn.channel_stats_plain(x)
    A, bb = gn.fold_affine_plain(st, w, bias, G, M, 1e-6)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stats_grid = {"parent": _parent_bwd_slabs(M),
                  "change": gn._bwd_slabs("stats", B, M, C, 8, sms)}
    apply_grid = gn._bwd_slabs("apply", B, M, C, 8, sms)
    out = {who: dict(part=torch.empty((B, stats_grid[who][1], 2, C), device="cuda"),
                     coef=torch.empty((B, 2, C), device="cuda"),
                     dscale=torch.empty(C, device="cuda"), dbias=torch.empty(C, device="cuda"),
                     dx=torch.empty_like(x)) for who in stats_grid}
    t_scratch = torch.empty((B, 2, C), device="cuda")
    ptrs = (x.data_ptr(), g.data_ptr(), A.data_ptr(), bb.data_ptr())

    def stats(who):
        o, (rows, nblk) = out[who], stats_grid[who]
        lib = libs[who]["groupnorm_bwd"]
        if who == "parent":
            err = lib.medimgen_gn_bwd_stats(
                *ptrs, st.data_ptr(), w.data_ptr(), o["part"].data_ptr(), t_scratch.data_ptr(),
                o["coef"].data_ptr(), o["dscale"].data_ptr(), o["dbias"].data_ptr(), B, M, C, G,
                1e-6, 1, 1, rows, nblk, stream)
        else:
            err = lib.medimgen_gn_bwd_stats(
                *ptrs, st.data_ptr(), w.data_ptr(), o["part"].data_ptr(), o["coef"].data_ptr(),
                o["dscale"].data_ptr(), o["dbias"].data_ptr(), B, M, C, G, 1e-6, 1, 1, rows,
                nblk, 1, stream)
        _build.check(err, f"{who} GroupNorm backward stats")

    def apply(who):
        o = out[who]
        lib = libs[who]["groupnorm_bwd"]
        args = (*ptrs, o["coef"].data_ptr(), o["dx"].data_ptr(), B, M, C, 1, 1)
        if who == "parent":
            err = lib.medimgen_gn_bwd_apply(*args, 1, stream)
        else:
            err = lib.medimgen_gn_bwd_apply(*args, *apply_grid, 1, stream)
        _build.check(err, f"{who} GroupNorm backward apply")

    for who in out:
        stats(who)
    res = {"shape": [B, M, C], "groups": G, "stats": in_turns(stats), "apply": in_turns(apply)}
    torch.cuda.synchronize()
    res["max_abs_diff_change_vs_parent"] = {
        k: (out["change"][k].float() - out["parent"][k].float()).abs().max().item()
        for k in ("coef", "dscale", "dbias", "dx")}
    xg = x.detach().requires_grad_()
    wl, bl = w.bfloat16().requires_grad_(), bias.bfloat16().requires_grad_()
    y = F.silu(F.group_norm(xg.permute(0, 2, 1), G, wl, bl, 1e-6))
    res["group_norm_silu_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        y, (xg, wl, bl), g.permute(0, 2, 1), retain_graph=True))
    res["native_gn_bwd_params_ms"] = native_gn_bwd_params_ms(x, g, wl.detach(), bl.detach(), G)
    res["stats_bound_ms"] = (2 * B * M * C * 2 + 9 * B * C * 4) / PEAK_BYTES * 1e3
    res["apply_bound_ms"] = (3 * B * M * C * 2 + 4 * B * C * 4) / PEAK_BYTES * 1e3
    return res


def native_gn_bwd_params_ms(x, g, w, bias, G: int) -> float:
    """Median ms of ``aten.native_group_norm_backward`` for dscale and dbias
    only (no SiLU) on channels-first copies of the (B, M, C) x and g: the
    one PyTorch call that does the backward stats' reduction over x and dy."""
    B, M, C = x.shape
    xc, gc = x.permute(0, 2, 1).contiguous(), g.permute(0, 2, 1).contiguous()
    _, mean, rstd = torch.ops.aten.native_group_norm(xc, w, bias, B, C, M, G, 1e-6)
    return time_ms(lambda: torch.ops.aten.native_group_norm_backward(
        gc, xc, mean, rstd, w, B, C, M, G, [False, True, True]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="csrc directory of the parent build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    libs = {"parent": build(args.parent, "parent"), "change": build(_build.CSRC_DIR, "change")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": card, "sites": [], "gn_sites": [], "gn_bwd_sites": []}
    for shape in SITES:
        r = site(libs, *shape)
        out["sites"].append(r)
        print(f"[kernel_ab] {card} B,S,H,D={tuple(shape)}: "
              + "; ".join(f"{w} parent {r[w]['parent']:.4f} ms, change {r[w]['change']:.4f} ms"
                          for w in ("fwd", "dq", "dkdv"))
              + f" (SDPA forward {r['sdpa_fwd_ms']:.4f}, whole backward {r['sdpa_bwd_ms']:.4f})",
              flush=True)
    for shape in GN_SITES:
        r = gn_site(libs, *shape)
        out["gn_sites"].append(r)
        print(f"[kernel_ab] {card} B,M,C={tuple(shape)}: channel stats parent "
              f"{r['stats']['parent']:.4f} ms, change {r['stats']['change']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms (var_mean {r['var_mean_ms']:.4f}); max |change - parent| "
              f"{r['max_abs_diff_change_vs_parent']:.3e}", flush=True)
    for shape in GN_BWD_SITES:
        r = gn_bwd_site(libs, *shape)
        out["gn_bwd_sites"].append(r)
        print(f"[kernel_ab] {card} B,M,C={tuple(shape[:3])} GroupNorm+SiLU backward: "
              + "; ".join(f"{w} parent {r[w]['parent']:.4f} ms, change {r[w]['change']:.4f} ms, "
                          f"bound {r[w + '_bound_ms']:.4f} ms" for w in ("stats", "apply"))
              + f" (F.group_norm+F.silu backward {r['group_norm_silu_bwd_ms']:.4f}, "
              f"native_group_norm_backward dscale+dbias {r['native_gn_bwd_params_ms']:.4f}); "
              "max |change - parent| " + ", ".join(
                  f"{k} {v:.3e}" for k, v in r["max_abs_diff_change_vs_parent"].items()),
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
