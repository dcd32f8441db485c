"""Collectives over the installed mesh's named axes (counterpart of
``paddle_tpu/distributed/communication.py``).

Each function takes this rank's value and an axis name (or the data
axes ``("dp", "fsdp")``) and runs over that axis's process group
(:meth:`~.mesh.Mesh.group`): the ranks that share this rank's other
coordinates.  The reference calls them inside ``shard_map``; here they
run eagerly in each rank, inside the port's ``shard_map`` or anywhere
else.  Inputs are not written; on gloo CUDA tensors are staged through
host memory (:mod:`.collective`).  An axis of one rank is the identity.
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
    "ring_shift",
]


def _group(axis):
    return mesh_mod.get_mesh().group(axis)


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


def ppermute(x, axis, perm: Sequence):
    """Rank ``i`` of ``axis`` sends ``x`` to rank ``j`` for each ``(i,
    j)`` of ``perm``; a rank no pair sends to gets zeros (the reference's
    semantics).  Runs as a gather along the axis."""
    me = axis_index(axis)
    src = [i for i, j in perm if j == me]
    parts = _all_gather(x, _group(axis))
    return parts[src[0]].clone() if src else torch.zeros_like(x)


def ring_shift(x, axis, shift: int = 1):
    """Rotate values around the ``axis`` ring by ``shift``: rank i gets
    rank (i - shift)'s value."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


def all_to_all(x, axis, *, split_dim: int, concat_dim: int,
               tiled: bool = True):
    """Block j of ``x`` along ``split_dim`` goes to rank j of ``axis``;
    the blocks received are concatenated along ``concat_dim`` (stacked on
    a new ``concat_dim`` without ``tiled``, where ``split_dim`` has one
    entry a rank and is dropped)."""
    n = axis_size(axis)
    parts = list(x.chunk(n, dim=split_dim)) if n > 1 else [x]
    if not tiled:
        parts = [p.squeeze(split_dim) for p in parts]
    got = _all_to_all(parts, _group(axis))
    return (torch.cat(got, dim=concat_dim) if tiled
            else torch.stack(got, dim=concat_dim))


def axis_index(axis) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh_mod.get_mesh().axis_index(axis)


def axis_size(axis) -> int:
    return mesh_mod.get_mesh().axis_size(axis)


def broadcast_from(x, axis, root: int = 0):
    """Rank ``root`` of ``axis``'s value on every rank of it."""
    parts = _all_gather(x, _group(axis))
    return parts[root].clone()
