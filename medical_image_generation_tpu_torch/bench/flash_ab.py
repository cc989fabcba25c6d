"""A/B timing of two builds of the flash-attention kernels on one GPU.

    git archive <commit> medical_image_generation_tpu_torch/csrc | tar -x -C build/parent
    python3 -m medical_image_generation_tpu_torch.bench.flash_ab \\
        --parent build/parent/medical_image_generation_tpu_torch/csrc

Builds ``flash_attn_fwd.cu`` and ``flash_attn_bwd.cu`` from the parent's
``csrc`` directory and from this checkout's, calls both through the same C
entry points (``medimgen_flash_attn_fwd``, ``medimgen_flash_attn_bwd_dkdv``)
on the same bf16 inputs at the U-Net's two attention sites, and times them
with CUDA events in turns: parent, change, change, parent. PyTorch's SDPA
forward and backward are timed beside them as a yardstick. Prints one line
per site and a JSON record as the last line; needs a GPU and nvcc.
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

SITES = [(2, 4096, 1, 512), (2, 512, 1, 768)]  # (B, S, H, D) of the U-Net's attention


def build(csrc: str, tag: str) -> dict:
    """{name: loaded library} of the two flash sources under ``csrc``."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), f"flash_ab_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
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
    libs["flash_attn_bwd"].medimgen_flash_attn_bwd_dkdv.argtypes = (
        [vp] * 8 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, vp])
    return libs


def time_ms(fn, warmup=5, iters=20) -> float:
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


def site(libs: dict, B: int, S: int, H: int, D: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    scale = D ** -0.5
    strides = (q.stride(0), q.stride(1)) * 3
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), device="cuda")
    delta = (do.float() * q.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = torch.empty_like(q), torch.empty_like(q)

    def fwd(lib):
        err = lib["flash_attn_fwd"].medimgen_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, S, D,
            1, *strides, scale, 1, stream)
        _build.check(err, "flash forward")

    def dkdv(lib):
        err = lib["flash_attn_bwd"].medimgen_flash_attn_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, S, D, 1, *strides, scale, 1,
            stream)
        _build.check(err, "flash dK/dV")

    res = {"shape": [B, S, H, D]}
    for what, fn in (("fwd", fwd), ("dkdv", dkdv)):
        runs = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            runs[who].append(time_ms(lambda: fn(libs[who])))
        res[what] = {who: statistics.mean(t) for who, t in runs.items()}
        res[what]["runs"] = runs
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    sdpa_both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qh, kh, vh, scale=scale), (qh, kh, vh), doh))
    res["sdpa_fwd_ms"], res["sdpa_bwd_ms"] = sdpa_fwd, sdpa_both - sdpa_fwd
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="csrc directory of the parent build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 2
    libs = {"parent": build(args.parent, "parent"), "change": build(_build.CSRC_DIR, "change")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": card, "sites": []}
    for shape in SITES:
        r = site(libs, *shape)
        out["sites"].append(r)
        print(f"[flash_ab] {card} B,S,H,D={tuple(shape)}: forward parent "
              f"{r['fwd']['parent']:.4f} ms, change {r['fwd']['change']:.4f} ms "
              f"(SDPA {r['sdpa_fwd_ms']:.4f}); dK/dV parent {r['dkdv']['parent']:.4f} ms, "
              f"change {r['dkdv']['change']:.4f} ms (SDPA whole backward "
              f"{r['sdpa_bwd_ms']:.4f})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
