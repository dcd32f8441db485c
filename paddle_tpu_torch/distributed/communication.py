"""Collectives over the installed mesh's named axes (counterpart of
``paddle_tpu/distributed/communication.py``).

Each function takes this rank's value and an axis name (or the data
axes ``("dp", "fsdp")``) and runs over that axis's process group
(:meth:`~.mesh.Mesh.group`): the ranks that share this rank's other
coordinates.  The reference calls them inside ``shard_map``; here they
run eagerly in each rank, inside the port's ``shard_map`` or anywhere
else.  Inputs are not written; on gloo CUDA tensors are staged through
host memory (:mod:`.collective`).  An axis of one rank is the identity.

Differentiable (each a ``torch.autograd.Function``, whose backward is a
collective every rank of the axis runs in the same order):
``ppermute`` (backward: ``ppermute`` with the inverse pairs),
``all_to_all`` (backward: the inverse ``all_to_all``) and the three
tensor-parallel region functions of the explicit model-parallel layers
(:mod:`.meta_parallel`), which the reference leaves to XLA's SPMD
partitioner:

- ``copy_to_region``: identity forward, sum over the axis backward (the
  input of a column-parallel product, whose ranks each see one block of
  the output's cotangent);
- ``reduce_from_region``: sum over the axis forward, identity backward
  (a row-parallel product's partial sums);
- ``gather_from_region``: the ranks' blocks concatenated along a dim
  forward, this rank's block of the cotangent backward.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import mesh as mesh_mod
from .collective import (ReduceOp, _all_gather, _all_reduce, _all_to_all,
                         _reduce_scatter)

__all__ = [
    "psum", "pmean", "pmax", "pmin", "pprod", "all_gather", "reduce_scatter",
    "ppermute", "all_to_all", "axis_index", "axis_size", "broadcast_from",
    "ring_shift", "copy_to_region", "reduce_from_region",
    "gather_from_region",
]


def _group(axis, mesh=None):
    return (mesh or mesh_mod.get_mesh()).group(axis)


def _reduce(x, axis, op):
    return _all_reduce(x.clone(), op, _group(axis))


def psum(x, axis):
    """The sum over ``axis``."""
    return _reduce(x, axis, ReduceOp.SUM)


def pmean(x, axis):
    return psum(x, axis) / axis_size(axis)


def pmax(x, axis):
    return _reduce(x, axis, ReduceOp.MAX)


def pmin(x, axis):
    return _reduce(x, axis, ReduceOp.MIN)


def pprod(x, axis):
    """The product over ``axis``, in axis order (a gather, then one
    product: no exp(sum(log)), which breaks on zero or negative
    values)."""
    return torch.prod(torch.stack(_all_gather(x, _group(axis))), dim=0)


def all_gather(x, axis, *, tiled: bool = False, gather_dim: int = 0):
    """Every rank's ``x`` along ``axis``: stacked on a new ``gather_dim``,
    or (``tiled``) concatenated along it."""
    parts = _all_gather(x, _group(axis))
    return (torch.cat(parts, dim=gather_dim) if tiled
            else torch.stack(parts, dim=gather_dim))


def reduce_scatter(x, axis, *, scatter_dim: int = 0):
    """The sum over ``axis``, this rank's block of ``scatter_dim``."""
    return _reduce_scatter(x, scatter_dim, _group(axis))


def _ppermute(x, axis, perm, mesh=None):
    """``x`` from the rank ``perm`` sends to this one (zeros when none),
    over ``mesh`` (default: the installed one); no autograd."""
    me = (mesh or mesh_mod.get_mesh()).axis_index(axis)
    src = [i for i, j in perm if j == me]
    parts = _all_gather(x.contiguous(), _group(axis, mesh))
    return parts[src[0]].clone() if src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(j, i) for i, j in ctx.perm]
        return _ppermute(g.contiguous(), ctx.axis, inv), None, None


def ppermute(x, axis, perm: Sequence):
    """Rank ``i`` of ``axis`` sends ``x`` to rank ``j`` for each ``(i,
    j)`` of ``perm``; a rank no pair sends to gets zeros (the reference's
    semantics).  Runs as a gather along the axis, which is exact."""
    return _PPermute.apply(x, axis, tuple(tuple(p) for p in perm))


def ring_shift(x, axis, shift: int = 1):
    """Rotate values around the ``axis`` ring by ``shift``: rank i gets
    rank (i - shift)'s value."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


def _a2a(x, axis, split_dim, concat_dim):
    n = axis_size(axis)
    if n == 1:
        return x
    parts = [p.contiguous() for p in x.chunk(n, dim=split_dim)]
    return torch.cat(_all_to_all(parts, _group(axis)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _a2a(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _a2a(g, axis, concat_dim, split_dim), None, None, None


def all_to_all(x, axis, *, split_dim: int, concat_dim: int,
               tiled: bool = True):
    """Block j of ``x`` along ``split_dim`` goes to rank j of ``axis``;
    the blocks received are concatenated along ``concat_dim`` (stacked on
    a new ``concat_dim`` without ``tiled``, where ``split_dim`` has one
    entry a rank and is dropped)."""
    if tiled:
        return _AllToAll.apply(x, axis, split_dim, concat_dim)
    n = axis_size(axis)
    parts = list(x.chunk(n, dim=split_dim)) if n > 1 else [x]
    parts = [p.squeeze(split_dim) for p in parts]
    return torch.stack(_all_to_all(parts, _group(axis)), dim=concat_dim)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axis, ReduceOp.SUM), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _reduce(x, axis, ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim, x.shape[dim])
        return torch.cat(_all_gather(x.contiguous(), _group(axis)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, size = ctx.args
        return g.narrow(dim, axis_index(axis) * size, size), None, None


def _one(axis) -> bool:
    mesh = mesh_mod.get_mesh(create=False)
    return mesh is None or not mesh.distributed or mesh.axis_size(axis) == 1


def copy_to_region(x, axis):
    """Identity forward; the cotangent summed over ``axis`` backward.  An
    axis of one rank returns ``x`` itself."""
    return x if _one(axis) else _CopyToRegion.apply(x, axis)


def reduce_from_region(x, axis):
    """The sum over ``axis`` forward; the cotangent as it is backward."""
    return x if _one(axis) else _ReduceFromRegion.apply(x, axis)


def gather_from_region(x, axis, dim: int = -1):
    """The ranks' blocks of ``axis`` concatenated along ``dim`` forward
    (rank order); this rank's block of the cotangent backward."""
    if _one(axis):
        return x
    return _GatherFromRegion.apply(x, axis, dim % x.dim())


def axis_index(axis) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh_mod.get_mesh().axis_index(axis)


def axis_size(axis) -> int:
    return mesh_mod.get_mesh().axis_size(axis)


def broadcast_from(x, axis, root: int = 0):
    """Rank ``root`` of ``axis``'s value on every rank of it."""
    parts = _all_gather(x, _group(axis))
    return parts[root].clone()
