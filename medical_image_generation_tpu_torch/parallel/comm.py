"""Collectives over one axis of the mesh, as autograd Functions.

The port's counterpart of what GSPMD and ``shard_map`` insert in the JAX
package. ``AxisGroup`` is one rank's place on one mesh axis: its process
group, its index along the axis and the axis size. Its four differentiable
collectives are the conjugate pairs of Megatron-style model parallelism:

* ``copy``: identity forward, all-reduce (sum) backward. It marks where a
  tensor every rank holds whole enters a rank-local computation (the input
  of a column-parallel layer): each rank's backward holds only its part of
  the input's gradient, and the sum is the whole;
* ``reduce``: all-reduce (sum) forward, identity backward (the output of a
  row-parallel layer: partial products summed);
* ``gather(x, dim)``: all-gather along ``dim`` forward; the backward takes
  this rank's slice of the gradient, with no sum. What follows the gather
  is computed by every rank of the axis alike, so each rank's gradient of
  the gathered tensor is already the whole one;
* ``scatter(x, dim)``: this rank's slice along ``dim`` forward; all-gather
  of the slices' gradients backward (the tensor was whole and alike on
  every rank, and each rank's slice saw only its own part of the loss).

A gather / scatter pair whose backward summed, or skipped the collective,
would give gradients ``size`` times too large, or zero outside the rank's
slice. An axis of one rank (``group`` None) makes every operation the
identity. ``all_reduce_mean_`` averages a list of tensors in place over the
axis (the data-parallel gradient mean), in buckets.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20  # flattened bytes an all-reduce of all_reduce_mean_


def _all_gather(x, group, size: int, dim: int):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x, index: int, size: int, dim: int):
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide over {size} ranks")
    return x.narrow(dim, index * (n // size), n // size)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()  # keeps a dense layout (a channels-last conv output stays so)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size, dim):
        ctx.args = (index, size, dim)
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args).contiguous(), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size, dim):
        ctx.args = (group, size, dim)
        return _slice(x, index, size, dim)

    @staticmethod
    def backward(ctx, g):
        group, size, dim = ctx.args
        return _all_gather(g, group, size, dim), None, None, None, None


class AxisGroup:
    """One rank's place on one mesh axis: ``group`` (None for an axis of
    one rank), ``index`` along the axis and ``size``."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, int(index), int(size)

    @staticmethod
    def of(mesh, axis: str) -> "AxisGroup":
        """The data column (``"data"``) or model row (``"model"``) of
        ``mesh``'s rank."""
        i = 0 if axis == "data" else 1
        return AxisGroup(mesh.data_group if i == 0 else mesh.model_group, mesh.coords[i],
                         mesh.shape[axis])

    @property
    def trivial(self) -> bool:
        return self.group is None

    def copy(self, x):
        return x if self.trivial else _Copy.apply(x, self.group)

    def reduce(self, x):
        return x if self.trivial else _Reduce.apply(x, self.group)

    def gather(self, x, dim: int):
        return x if self.trivial else _Gather.apply(x, self.group, self.index, self.size, dim)

    def scatter(self, x, dim: int):
        return x if self.trivial else _Scatter.apply(x, self.group, self.index, self.size, dim)

    def local(self, x, dim: int):
        """This rank's slice of ``x`` along ``dim`` (no autograd collective)."""
        return x if self.size == 1 else _slice(x, self.index, self.size, dim)

    @torch.no_grad()
    def all_gather(self, x, dim: int):
        """The slices of every rank along ``dim`` (no autograd)."""
        return x if self.trivial else _all_gather(x, self.group, self.size, dim)

    @torch.no_grad()
    def sum_(self, x):
        """All-reduce (sum) ``x`` in place; returns it."""
        if not self.trivial:
            dist.all_reduce(x, group=self.group)
        return x

    @torch.no_grad()
    def mean(self, x):
        """The mean of ``x`` over the axis (a new tensor; ``x`` itself on an
        axis of one rank)."""
        return x if self.trivial else self.sum_(x.detach().clone()) / self.size

    @torch.no_grad()
    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average each tensor in place over the axis: flattened into
        buckets of at most ``BUCKET_BYTES`` a dtype, one all-reduce a
        bucket."""
        if self.trivial:
            return
        bucket: List[torch.Tensor] = []
        nbytes = 0

        def flush():
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            parts = flat.split([t.numel() for t in bucket])
            torch._foreach_copy_(bucket, [p.view_as(t) for p, t in zip(parts, bucket)])

        for t in tensors:
            if bucket and (t.dtype != bucket[0].dtype or nbytes + t.nbytes > BUCKET_BYTES):
                flush()
                bucket, nbytes = [], 0
            bucket.append(t)
            nbytes += t.nbytes
        if bucket:
            flush()
