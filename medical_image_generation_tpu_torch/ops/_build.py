"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` into a shared library under ``build/torch_kernels/`` beside the
package (git-ignored), named by a hash of its source and flags, then loaded
with ``ctypes``. No PyTorch headers are compiled, so a build takes seconds.
``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module and have
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "groupnorm", "groupnorm_bwd", "adamw")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> str:
    """Library path named by a hash of the source, every shared header in
    ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel. Returns {name: nvcc log}
    (ptxas register / shared-memory report) for the sources it built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    path = lib_path(name)
    if not os.path.exists(path):
        build_all([name])
    return ctypes.CDLL(path)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
