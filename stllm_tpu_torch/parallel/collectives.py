"""Collectives over a process group (stllm_tpu/parallel/collectives.py; the
reference's GatherLayer, all_gather_with_grad and concat_all_gather).

In the reference these are ``jax.lax`` collectives, differentiated by their
transpose rules. Here each is ``torch.distributed`` under an autograd
Function whose backward is that transpose. Every function is the identity
on a None group, as the reference's are outside a mapped axis.

The tensor-parallel trio follows from the same rules: ``copy_to`` (the
identity forward, a sum of the partial input gradients backward) goes in
front of a column-parallel matmul, ``reduce_from`` (a sum forward, the
identity backward) after a row-parallel one, and ``gather_from`` joins
column slices whose consumers run replicated, so its backward keeps this
rank's slice of a gradient every rank holds whole; ``scatter_to`` is its
conjugate.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

# the torch 2.13 names of these two collectives; older releases have only the
# deprecated ones, which take the same arguments
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@torch.no_grad()
def gather_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` joined along ``dim`` in rank order (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    _gather_into(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


@torch.no_grad()
def reduce_scatter_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of the group's ``x``, cut along ``dim`` into equal slices;
    this rank's slice (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    _reduce_scatter(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


@torch.no_grad()
def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ``x`` in a new tensor (no gradient)."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def slice_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * c, c)


# ---------------------------------------------------------------------------
# many tensors, one collective: a parameter tree's leaves travel together
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x as (n, numel / n): its n equal slices along ``dim``, one a row."""
    return x.movedim(dim, 0).contiguous().reshape(n, -1)


def _from_rows(rows: torch.Tensor, like_shape, dim: int) -> torch.Tensor:
    """The inverse of ``_rows``: (n, m) rows back into a tensor whose
    ``dim`` is n times the length of ``like_shape``'s."""
    shape = list(like_shape)
    moved = [shape[dim]] + shape[:dim] + shape[dim + 1:]
    moved[0] *= rows.shape[0]
    return rows.reshape(moved).movedim(0, dim).contiguous()


@torch.no_grad()
def gather_many(xs: List[torch.Tensor], dims: List[int], group) -> List[torch.Tensor]:
    """``gather_dim`` of every tensor, in ONE all-gather of their bytes."""
    n = group_size(group)
    if n == 1 or not xs:
        return list(xs)
    parts = [x.movedim(d, 0).contiguous().reshape(-1).view(torch.uint8) for x, d in zip(xs, dims)]
    flat = torch.cat(parts)
    out = flat.new_empty(n * flat.numel())
    _gather_into(out, flat, group=group)
    out = out.view(n, -1)
    got, off = [], 0
    for x, d, p in zip(xs, dims, parts):
        rows = out[:, off:off + p.numel()].contiguous().view(x.dtype)
        got.append(_from_rows(rows, x.shape, d))
        off += p.numel()
    return got


@torch.no_grad()
def reduce_scatter_many(xs: List[torch.Tensor], dims: List[int], group
                        ) -> List[torch.Tensor]:
    """``reduce_scatter_dim`` of every tensor, one reduce-scatter a dtype."""
    n = group_size(group)
    if n == 1:
        return list(xs)
    got: List[Optional[torch.Tensor]] = [None] * len(xs)
    for dtype in {x.dtype for x in xs}:
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        rows = [_rows(xs[i], dims[i], n) for i in idx]
        flat = torch.cat(rows, dim=1).reshape(-1)
        out = flat.new_empty(flat.numel() // n)
        _reduce_scatter(out, flat, group=group)
        off = 0
        for i, r in zip(idx, rows):
            shape = list(xs[i].shape)
            shape[dims[i]] //= n
            got[i] = _from_rows(out[off:off + r.shape[1]][None], shape, dims[i])
            off += r.shape[1]
    return got


@torch.no_grad()
def all_reduce_many(xs: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``all_reduce`` of every tensor, one all-reduce a dtype."""
    if group is None:
        return list(xs)
    got: List[Optional[torch.Tensor]] = [None] * len(xs)
    for dtype in {x.dtype for x in xs}:
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            got[i] = flat[off:off + xs[i].numel()].view(xs[i].shape)
            off += xs[i].numel()
    return got


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Gather along dim 0 over ``group``, differentiable: the backward sums
    the gradient over the group and keeps this rank's rows (the transpose of
    ``lax.all_gather``, the reference's GatherLayer)."""
    if group is None:
        return x
    return _GatherWithGrad.apply(x, group, 0)


def concat_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Gather along dim 0 WITHOUT gradient."""
    return gather_dim(x.detach(), group, 0)


def psum_scalar(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """Sum over ``group`` (a metric or a count: no gradient)."""
    return all_reduce(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return slice_dim(g, ctx.group, ctx.dim).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return slice_dim(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group, dim % x.dim())


def scatter_to(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``x``, which every rank holds whole; the
    backward gathers the slices' gradients (``gather_from``'s conjugate)."""
    return x if group is None else _ScatterTo.apply(x, group, dim % x.dim())
