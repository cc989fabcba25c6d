"""The port's hand-written CUDA kernels, one table entry each, and the
counters of their launches.

An entry (``Kernel``) declares a kernel once: its counter name, its source
``csrc/<source>.cu`` (``SOURCES`` is the set of them), its C entry
point with the ctypes argument types (every entry point returns its
``cudaError_t`` as an int), and the ``__global__`` functions the profiler
shows for it. No device name is part of another's, so an event's name has
at most one owner (``owner``). Calling an entry launches through its C
entry point, bound on the first call, raises on a CUDA error and counts the
launch. The wrappers in ``ops/`` pick the entry and build its arguments; a
new kernel is one entry here and its wrapper. The C functions the wrappers
ask a library once, beside its entry points, are declared in ``QUERIES``.

The counter store holds each entry's launches under its name, and the
counts the wrappers keep beside them under dotted names (``SIDE_COUNTS``):
the inputs a flash pass copied before TMA could load them
(``<kernel>.input_copies``), the GroupNorm launches that took 16-byte loads
(``<kernel>.vector_launches``), the incoming GroupNorm gradients made
channels-last (``gn_bwd_apply.grad_copies``), the gradients the optimizer
copied into their param's layout (``adamw_update.grad_copies``) and the
calls of the sharded ring attention (``ring_attention.calls``). CPU tensors
take the plain versions, which count nothing. Nothing here builds or loads
a library at import time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

from medical_image_generation_tpu_torch.ops import _build

vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Kernel:
    """One hand-written kernel. ``device_launches``: the ``__global__``
    launches one call of its entry point makes (one of ``device_names`` each)."""

    __slots__ = ("name", "source", "symbol", "argtypes", "device_names", "device_launches",
                 "_fn")

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence,
                 device_names: Sequence[str], device_launches: int = 1):
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes, self.device_names = tuple(argtypes), tuple(device_names)
        self.device_launches = device_launches
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch with ``args`` (the entry point's, in order) and count it."""
        fn = self._fn
        if fn is None:
            fn = self._fn = _build.bind(self.source, self.symbol, self.argtypes, i32)
        err = fn(*args)
        if err:
            raise RuntimeError(f"{self.symbol} launch: CUDA error {err}")
        _COUNTS[self.name] += 1


_FLASH_FWD = [vp] * 5 + [i32] * 6 + [i64] * 6 + [f32, i32, vp]
_FLASH_BWD = [vp] * 8 + [i32] * 6 + [i64] * 6 + [f32, i32, vp]

KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    # the wide flash design: head dims over warpgroups and clusters, fp32 and bf16
    Kernel("flash_attn_fwd", "flash_attn_fwd", "medimgen_flash_attn_fwd", _FLASH_FWD,
           ("flash_fwd_bf16", "flash_fwd_f32")),
    Kernel("flash_attn_bwd_dq", "flash_attn_bwd", "medimgen_flash_attn_bwd_dq", _FLASH_BWD,
           ("flash_bwd_dq_bf16", "flash_bwd_dq_f32")),
    Kernel("flash_attn_bwd_dkdv", "flash_attn_bwd", "medimgen_flash_attn_bwd_dkdv", _FLASH_BWD,
           ("flash_bwd_dkdv_bf16", "flash_bwd_dkdv_f32")),
    # the narrow flash design: one warpgroup holds a bf16 head dim up to 64
    Kernel("flash_attn_fwd_narrow", "flash_attn_narrow_fwd", "medimgen_flash_narrow_fwd",
           _FLASH_FWD, ("flash_fwd_narrow_bf16",)),
    Kernel("flash_attn_bwd_dq_narrow", "flash_attn_narrow_bwd", "medimgen_flash_narrow_bwd_dq",
           _FLASH_BWD, ("flash_bwd_dq_narrow_bf16",)),
    Kernel("flash_attn_bwd_dkdv_narrow", "flash_attn_narrow_bwd",
           "medimgen_flash_narrow_bwd_dkdv", _FLASH_BWD, ("flash_bwd_dkdv_narrow_bf16",)),
    # GroupNorm(+SiLU) on (B, M, C) rows
    Kernel("gn_stats_fold", "groupnorm", "medimgen_gn_stats_fold",
           [vp] * 7 + [i32, i64, i32, i32, f32, i32, i64, i32, i32, vp],
           ("stats_partial_kernel", "stats_reduce_fold_kernel"), device_launches=2),
    Kernel("gn_affine_act", "groupnorm", "medimgen_gn_affine_act",
           [vp] * 4 + [i32, i64, i32, i32, i32, i32, vp], ("affine_kernel", "affine_vec_kernel")),
    Kernel("gn_bwd_stats", "groupnorm_bwd", "medimgen_gn_bwd_stats",
           [vp] * 10 + [i32, i64, i32, i32, f32, i32, i32, i64, i32, i32, vp],
           ("gn_bwd_partial_kernel", "gn_bwd_reduce_fold_kernel"), device_launches=2),
    Kernel("gn_bwd_apply", "groupnorm_bwd", "medimgen_gn_bwd_apply",
           [vp] * 6 + [i32, i64, i32, i32, i32, i64, i32, i32, vp], ("gn_bwd_apply_kernel",)),
    # clip + AdamW over a table of tensors (the table and the scalars by pointer)
    Kernel("sq_norm", "adamw", "medimgen_adamw_sq_norm", [vp, vp, vp, vp, i32, i32, vp],
           ("adamw_sq_norm_kernel",)),
    Kernel("adamw_update", "adamw", "medimgen_adamw_update", [vp, vp, vp, vp, i32, i32, vp],
           ("adamw_update_kernel",)),
)}

SOURCES: Tuple[str, ...] = tuple(dict.fromkeys(k.source for k in KERNELS.values()))

# {symbol: (source, argtypes, restype)}: the wide flash design's shared memory
# a block at (D, dtype code) and its limit, and csrc/adamw.cu's struct sizes
# and constants (written to six long longs)
QUERIES: Dict[str, Tuple[str, Tuple, Optional[type]]] = {
    "medimgen_flash_attn_smem_bytes": ("flash_attn_fwd", (i32, i32), i64),
    "medimgen_flash_attn_bwd_smem_bytes": ("flash_attn_bwd", (i32, i32), i64),
    "medimgen_flash_attn_smem_limit": ("flash_attn_fwd", (), i64),
    "medimgen_adamw_layout": ("adamw", (ctypes.POINTER(i64),), None),
}


def query(symbol: str):
    """The typed C function ``symbol`` of ``QUERIES`` (the caller keeps it,
    or caches what it returns)."""
    source, argtypes, restype = QUERIES[symbol]
    return _build.bind(source, symbol, argtypes, restype)


SIDE_COUNTS: Tuple[str, ...] = (
    *(f"{k}.input_copies" for k in KERNELS if k.startswith("flash_")),
    "gn_stats_fold.vector_launches", "gn_bwd_stats.vector_launches",
    "gn_bwd_apply.vector_launches", "gn_bwd_apply.grad_copies", "adamw_update.grad_copies",
    "ring_attention.calls",
)

_COUNTS: Dict[str, int] = dict.fromkeys((*KERNELS, *SIDE_COUNTS), 0)
_OWNERS = tuple((dn, k.name) for k in KERNELS.values() for dn in k.device_names)


def add(name: str, n: int = 1) -> None:
    """Add n to a counter (a kernel's or a side count's name)."""
    _COUNTS[name] += n


def read(name: str) -> int:
    """A counter's value."""
    return _COUNTS[name]


def launches() -> Dict[str, int]:
    """{kernel name: launches} of every entry."""
    return {k: _COUNTS[k] for k in KERNELS}


def total(count: str) -> int:
    """One side count summed over the kernels that keep it, e.g.
    ``total("input_copies")``."""
    return sum(_COUNTS.get(f"{k}.{count}", 0) for k in KERNELS)


def reset() -> None:
    """Every counter to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


def owner(device_name: str) -> Optional[str]:
    """The entry whose device name is part of a profiler event's name, or
    None for a kernel that is not the port's."""
    return next((k for dn, k in _OWNERS if dn in device_name), None)


def beyond_launches(launches: Dict[str, int], events: Dict[str, int]) -> Dict[str, int]:
    """What a profile shows beyond the launches counted over it. ``launches``:
    {kernel: launches}; ``events``: {device name: events of it}. A launch runs
    each of its kernel's device names at most once, ``device_launches`` of
    them in all, so a profile may drop events but never show more. Returns
    {device name or kernel: events beyond}, empty when none."""
    out = {}
    for k in KERNELS.values():
        n = launches[k.name]
        out.update((dn, events[dn] - n) for dn in k.device_names if events[dn] > n)
        over = sum(events[dn] for dn in k.device_names) - n * k.device_launches
        if over > 0:
            out[k.name] = over
    return out
