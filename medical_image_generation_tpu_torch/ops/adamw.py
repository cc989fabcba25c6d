"""clip_by_global_norm + AdamW over a list of tensors: two hand-written
kernel passes (``sq_norm``, ``adamw_update``) with their plain
``torch._foreach_*`` versions beside them.

The kernels (``csrc/adamw.cu``) replace no TPU kernel: the JAX package's
optax update is array code that XLA fuses. Eager PyTorch makes it ~22
``_foreach`` passes over the optimizer state; the kernels make two, bound
by bytes (28 B a parameter with a bf16 first moment):

* ``sq_norm(plan)``: one read of every gradient; the [sharded, replicated]
  sums of squares (the Megatron layout's split of ``global_norm``) as an
  fp32 (2,) device tensor.
* ``adamw_update(plan, hyper, sums)``: the clip (the norm read on the
  device from ``sums``, so an all-reduce of the sharded sum over the model
  axis may run between the passes without a host read) and the AdamW step
  in place on params, ``mu`` and ``nu``, each element in the plain
  version's fp32 operations and order; returns the norm as a 0-d fp32
  device tensor.

A ``Plan`` holds what the launches need of a fixed list of params and
moments: the tensors' addresses and tile offsets in ``AdamwTable``s, one a
launch (the ctypes mirror of the kernels' by-value parameter), and the flags
(sharded, 16-byte path). ``set_grads`` writes the step's gradient addresses
(0 for a None gradient, read as zeros; a gradient in another layout than
its param's is copied into it first); nothing else changes between steps,
and no table is copied to the device. A step allocates ~4 KB: ``sq_norm``'s
zeroed scratch (one memset launch; freed with the step, so no other phase's
peak memory holds it) and the norm.

Plain versions: ``global_norm`` / ``clip_by_global_norm`` (optax's
``where(norm < max, g, g / norm * max)``) and ``adamw_plain_``, which CPU
tensors take (``training/common.py`` ``AdamW``). CUDA tensors launch the
kernels (the entries ``sq_norm`` and ``adamw_update`` of ``ops/kernels.py``,
which count the launches) or raise; ``adamw_update.grad_copies`` there
counts the gradients copied into their param's layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch.ops import kernels
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup

# Mirrors of csrc/adamw.cu (checked against the library when it loads)
MAX_TENSORS = 384  # tensors a launch's table holds
TILE = 4096  # elements a tile
THREADS = 256
BLOCKS_PER_SM = 4  # the persistent grid: blocks an SM
SHARDED, VEC = 1, 2  # AdamwTable.flags bits
KERNEL_PARAM_BYTES = 32764  # sm_90, CUDA >= 12.1
_MU_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SQ_NORM, _UPDATE = kernels.KERNELS["sq_norm"], kernels.KERNELS["adamw_update"]


class AdamwTable(ctypes.Structure):
    _fields_ = [("g", ctypes.c_uint64 * MAX_TENSORS), ("p", ctypes.c_uint64 * MAX_TENSORS),
                ("mu", ctypes.c_uint64 * MAX_TENSORS), ("nu", ctypes.c_uint64 * MAX_TENSORS),
                ("numel", ctypes.c_longlong * MAX_TENSORS),
                ("tile_start", ctypes.c_int * (MAX_TENSORS + 1)), ("n", ctypes.c_int),
                ("flags", ctypes.c_ubyte * MAX_TENSORS)]


class AdamwHyper(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "max_norm", "b1_mu", "one_minus_b1", "b2", "one_minus_b2", "inv_bc1", "inv_bc2", "eps",
        "wd", "neg_lr")] + [("clip", ctypes.c_int), ("has_wd", ctypes.c_int)]


class Hyper(NamedTuple):
    """One step's scalars, as the plain version hands them to PyTorch:
    ``b1_mu`` is b1 rounded to mu's dtype, ``bc1`` / ``bc2`` the fp32 bias
    corrections."""
    lr: float
    b1: float
    b2: float
    eps: float
    wd: float
    b1_mu: float
    bc1: float
    bc2: float

    def to_c(self, max_norm: Optional[float]) -> AdamwHyper:
        """The kernel's scalars: each Python float rounded to fp32 as
        PyTorch rounds a scalar operand of an fp32 op on CUDA; a division by
        a scalar there is a product with its reciprocal, taken in double."""
        return AdamwHyper(max_norm=max_norm or 0.0, b1_mu=self.b1_mu, one_minus_b1=1 - self.b1,
                          b2=self.b2, one_minus_b2=1 - self.b2, inv_bc1=1 / self.bc1,
                          inv_bc2=1 / self.bc2,
                          eps=self.eps, wd=self.wd, neg_lr=-self.lr, clip=int(bool(max_norm)),
                          has_wd=int(bool(self.wd)))


@functools.cache
def _check_layout() -> None:
    """Raise unless csrc/adamw.cu's structs and constants are the mirrors'
    (asked of the library once)."""
    got = (ctypes.c_longlong * 6)()
    kernels.query("medimgen_adamw_layout")(got)
    want = (ctypes.sizeof(AdamwTable), ctypes.sizeof(AdamwHyper), MAX_TENSORS, TILE, THREADS,
            BLOCKS_PER_SM)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/adamw.cu layout {tuple(got)} != the wrapper's {want}")


# ------------------------------------------------------------------- plain

def global_norm(tensors: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                axis: Optional[AxisGroup] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device.
    Under the Megatron layout (``sharded``: which tensors are this rank's
    shards, ``axis``: the model axis) the sharded tensors' squares are
    summed over the axis and the replicated ones counted once, so every
    rank gets the norm of the whole gradient."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if axis is None or axis.trivial or not sharded or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    mask = torch.tensor(list(sharded), device=sq.device)
    part = torch.stack([sq[mask].sum(), sq[~mask].sum()])
    axis.sum_(part[:1])
    return part.sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sharded: Optional[Sequence[bool]] = None,
                        axis: Optional[AxisGroup] = None,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clip in place in optax's form; returns the norm before clipping
    (``global_norm``, or ``norm`` when given). No host synchronisation: the
    choice is made on the device."""
    if norm is None:
        norm = global_norm(grads, sharded, axis)
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


@torch.no_grad()
def adamw_plain_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor], h: Hyper) -> None:
    """optax ``adamw`` on clipped fp32 gradients, in place on params, mu and
    nu. mu = (1 - b1) g + b1 mu, summed in fp32; as in optax, b1 * mu is a
    product in the stored moment's dtype, with b1 itself rounded to it
    (bf16: 0.8984375), and the update uses the fp32 moment, of which only the
    stored copy is rounded."""
    b1, b2 = h.b1, h.b2
    m32 = [m.float() for m in torch._foreach_mul(mu, h.b1_mu)]
    torch._foreach_add_(m32, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
    denom = torch._foreach_div(nu, h.bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, h.eps)
    upd = torch._foreach_div(m32, h.bc1)
    torch._foreach_div_(upd, denom)
    if h.wd:
        torch._foreach_add_(upd, torch._foreach_mul(params, h.wd))
    torch._foreach_add_(params, torch._foreach_mul(upd, -h.lr))
    torch._foreach_copy_(mu, m32)  # stored moment: rounded to mu's dtype


# ------------------------------------------------------------ host tables

class Launch(NamedTuple):
    lo: int  # the launch's tensors: [lo, hi) of the list
    hi: int
    tile_start: List[int]  # hi - lo + 1 prefix tile counts from 0


def partition(numels: Sequence[int], max_tensors: int = MAX_TENSORS,
              tile: int = TILE) -> List[Launch]:
    """The launches of a list of tensor sizes: consecutive runs of at most
    ``max_tensors`` tensors (the tensors a launch's by-value table holds)
    whose tiles number under 2**31; each with its tensors' tile offsets."""
    launches, lo, starts = [], 0, [0]
    for i, n in enumerate(numels):
        tiles = -(-int(n) // tile)
        if i > lo and (i - lo == max_tensors or starts[-1] + tiles >= 2 ** 31):
            launches.append(Launch(lo, i, starts))
            lo, starts = i, [0]
        starts.append(starts[-1] + tiles)
    if len(numels) > lo:
        launches.append(Launch(lo, len(numels), starts))
    return launches


def _layout(t: torch.Tensor) -> tuple:
    """t's strides along its dims longer than 1: two dense tensors of one
    shape lie alike in memory when these agree (a size-1 dim's stride is
    free)."""
    return tuple(st for st, sz in zip(t.stride(), t.shape) if sz > 1)


def _dense(t: torch.Tensor) -> bool:
    """t covers numel consecutive elements in some order of its dims."""
    expect = 1
    for st, sz in sorted((st, sz) for st, sz in zip(t.stride(), t.shape) if sz > 1):
        if st != expect:
            return False
        expect *= sz
    return True


class Plan:
    """The kernels' tables for one list of fp32 params with
    their ``mu`` (fp32 or bf16) and fp32 ``nu``, all of one dense layout each
    (channels-last conv weights included). ``sharded[i]``: tensor i's
    squares are the Megatron-sharded sum's. ``sms``: the SM count that sizes
    the grid (the device's when None)."""

    def __init__(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                 sms: Optional[int] = None):
        if not params:
            raise ValueError("an AdamW plan needs at least one parameter")
        dev = params[0].device
        self.mu_dtype = mu[0].dtype
        self.param_ptrs = [p.data_ptr() for p in params]
        self.shapes = [tuple(p.shape) for p in params]
        self.strides = [p.stride() for p in params]
        self.layouts = [_layout(p) for p in params]
        base = []
        for i, (p, m, v) in enumerate(zip(params, mu, nu)):
            if (p.dtype != torch.float32 or v.dtype != torch.float32 or m.dtype != self.mu_dtype
                    or self.mu_dtype not in _MU_DTYPES):
                raise TypeError(f"AdamW kernels take fp32 params and nu and an fp32 or bf16 mu "
                                f"of one dtype; tensor {i}: {p.dtype}, {m.dtype}, {v.dtype}")
            if (any(t.device != dev or t.shape != p.shape or _layout(t) != self.layouts[i]
                    for t in (m, v)) or not _dense(p)):
                raise ValueError(f"tensor {i}: param, mu and nu need one device, shape and "
                                 f"dense layout, got strides {p.stride()}, {m.stride()}, "
                                 f"{v.stride()}")
            vec = (p.data_ptr() | v.data_ptr()) % 16 == 0 and m.data_ptr() % (
                4 * m.element_size()) == 0
            base.append((SHARDED if sharded and sharded[i] else 0) | (VEC if vec else 0))
        self.base_flags = base
        self.parts = partition([p.numel() for p in params])
        self.tables = []
        self._g_views, self._flag_views = [], []
        for ln in self.parts:
            t = AdamwTable()
            t.n = ln.hi - ln.lo
            for j, i in enumerate(range(ln.lo, ln.hi)):
                t.p[j], t.mu[j], t.nu[j] = (params[i].data_ptr(), mu[i].data_ptr(),
                                            nu[i].data_ptr())
                t.numel[j] = params[i].numel()
                t.flags[j] = base[i]
            for j, s in enumerate(ln.tile_start):
                t.tile_start[j] = s
            self.tables.append(t)
            self._g_views.append(np.ctypeslib.as_array(t.g)[:t.n])
            self._flag_views.append(np.ctypeslib.as_array(t.flags)[:t.n])
        if sms is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.grid_max = max(1, sms * BLOCKS_PER_SM)
        self.grids = [max(1, min(ln.tile_start[-1], self.grid_max)) for ln in self.parts]
        self.device = dev

    def set_grads(self, grads: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """Write the step's gradient addresses into the tables: each in its
        param's shape, or None (read as zeros). A gradient in another dtype
        or layout than its param's fp32 one (``torch.autograd.grad`` does
        not restride as ``.grad`` accumulation does) is first copied into
        it, as the plain version's ``g.float()`` takes any, and counted in
        ``adamw_update.grad_copies`` (``ops/kernels.py``); returns those
        copies, which the caller holds until the kernels are launched. A gradient off 16-byte
        alignment takes its tensor off the 16-byte path."""
        if len(grads) != len(self.shapes):
            raise ValueError(f"{len(grads)} gradients for {len(self.shapes)} params")
        ptrs, flags, copies = [], [], []
        for i, g in enumerate(grads):
            if g is None:
                ptrs.append(0)
                flags.append(self.base_flags[i])
                continue
            if tuple(g.shape) != self.shapes[i]:
                raise ValueError(f"gradient {i}: shape {tuple(g.shape)}, its param's "
                                 f"{self.shapes[i]}")
            if g.dtype != torch.float32 or (g.stride() != self.strides[i]
                                            and _layout(g) != self.layouts[i]):
                g = torch.empty_strided(self.shapes[i], self.strides[i], dtype=torch.float32,
                                        device=self.device).copy_(g)
                copies.append(g)
            ptr = g.data_ptr()
            ptrs.append(ptr)
            flags.append(self.base_flags[i] & ~VEC if ptr % 16 else self.base_flags[i])
        for ln, gv, fv in zip(self.parts, self._g_views, self._flag_views):
            gv[:] = ptrs[ln.lo:ln.hi]
            fv[:] = flags[ln.lo:ln.hi]
        kernels.add("adamw_update.grad_copies", len(copies))
        return copies


# ----------------------------------------------------------------- kernels

def sq_norm(plan: Plan) -> torch.Tensor:
    """The gradients' [sharded, replicated] sums of squares, fp32 (2,) on
    the device, one read of each gradient."""
    _check_layout()
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    # [partials (2 a block) | sums (2) | ticket (uint32, 0 between launches)]
    g2 = 2 * plan.grid_max
    scratch = torch.zeros(g2 + 3, dtype=torch.float32, device=plan.device)
    base = scratch.data_ptr()
    for k, (t, grid) in enumerate(zip(plan.tables, plan.grids)):
        _SQ_NORM(ctypes.byref(t), base, base + 4 * g2, base + 4 * (g2 + 2), grid, int(k > 0),
                 stream)
    return scratch[g2:g2 + 2]


def adamw_update(plan: Plan, h: Hyper, sums: Optional[torch.Tensor],
                 max_norm: Optional[float]) -> Optional[torch.Tensor]:
    """The clip by ``max_norm`` (none when it is falsy; the norm is
    sqrt(sums[0] + sums[1]) of ``sq_norm``'s sums, read on the device) and
    the AdamW step, in place on the plan's params, mu and nu. Returns the
    norm (0-d fp32 on the device) or None without a clip."""
    _check_layout()
    dev = plan.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    clip = bool(max_norm)
    if clip and (sums is None or sums.shape != (2,) or sums.dtype != torch.float32
                 or sums.device != dev):
        raise ValueError("a clipped update reads sq_norm(plan)'s fp32 (2,) sums")
    norm = torch.empty((), dtype=torch.float32, device=dev) if clip else None
    ch = h.to_c(max_norm)
    for t, grid in zip(plan.tables, plan.grids):
        _UPDATE(ctypes.byref(t), ctypes.byref(ch), sums.data_ptr() if clip else None,
                norm.data_ptr() if clip else None, _MU_DTYPES[plan.mu_dtype], grid, stream)
    return norm
