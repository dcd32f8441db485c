"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/meta_parallel.py``): ``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``, ``mark_sharding`` /
``shard_parameter`` and ``get_rng_state_tracker``.

The reference annotates each weight with a spec over the ``tp`` axis and
lets XLA's SPMD partitioner derive the collectives.  The port has no
partitioner: each rank holds its own block of each parameter, and the
layers call the collectives explicitly (the region functions of
:mod:`.communication`, the Megatron arrangement):

- ``ColumnParallelLinear`` holds columns ``[r n / tp, (r + 1) n / tp)``
  of W [in, n] (and of the bias): its input passes ``copy_to_region``
  (the cotangents of the ranks' column blocks sum there), and with
  ``gather_output`` the ranks' output blocks are concatenated
  (``gather_from_region``);
- ``RowParallelLinear`` holds rows of W [n, out]: its input is this
  rank's block of the last dim (``input_is_parallel``, or cut here), the
  partial products are summed over ``tp`` (``reduce_from_region``), then
  the (replicated) bias is added;
- ``VocabParallelEmbedding`` holds rows of the table: ids outside them
  look up row 0 and are zeroed, and the ranks' rows are summed over
  ``tp``.

A layer whose weight is whole (tp 1, or no process group) is bitwise a
plain linear or embedding: no collective runs.  ``mark_sharding`` records
a parameter's spec (``dist_spec``) and, when the installed mesh is over
processes and splits one of the spec's axes, replaces the parameter's
data by this rank's block (the reference lays the value out on the mesh
at the same point), so a model built under a mesh holds only its blocks;
every rank draws the whole weights from the same generator, so the
blocks are those of the model built whole.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..nn.functional import common as F
from ..nn.layer.common import Constant, Normal, XavierNormal, _param
from . import communication as comm
from . import mesh as mesh_mod
from .spec_layout import get_layout

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "mark_sharding", "shard_parameter", "get_rng_state_tracker",
    "block_of",
]


def _live_mesh():
    mesh = mesh_mod.get_mesh(create=False)
    return mesh if mesh is not None and mesh.distributed else None


def block_of(t, spec, mesh, full_shape=None):
    """This rank's block of ``t`` under ``spec`` (a dim entry: None or an
    axis name) on ``mesh``; a dim already smaller than ``full_shape``'s is
    taken as cut.  Works on tensors and numpy arrays."""
    shape = tuple(t.shape)
    full = tuple(full_shape) if full_shape is not None else shape
    for d, ax in enumerate(spec):
        if ax is None or d >= len(shape):
            continue
        n = mesh.axis_size(ax)
        if n == 1 or shape[d] != full[d]:
            continue
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} does not split "
                             f"over {ax!r} ({n} ranks)")
        size = shape[d] // n
        i = mesh.axis_index(ax)
        idx = [slice(None)] * len(shape)
        idx[d] = slice(i * size, (i + 1) * size)
        t = t[tuple(idx)]
        shape = tuple(t.shape)
    return t


def mark_sharding(param: nn.Parameter, spec, full_shape=None):
    """Record ``spec`` on ``param`` (``dist_spec``, its whole shape on
    ``full_shape``) and, under a mesh over processes, keep only this
    rank's block of it."""
    spec = tuple(spec) + (None,) * (param.dim() - len(tuple(spec)))
    param.dist_spec = spec
    param.full_shape = tuple(full_shape if full_shape is not None
                             else param.shape)
    mesh = _live_mesh()
    if mesh is not None and any(s is not None for s in spec):
        with torch.no_grad():
            blk = block_of(param.data, spec, mesh, param.full_shape)
            if tuple(blk.shape) != tuple(param.shape):
                param.data = blk.clone()
    return param


shard_parameter = mark_sharding


class _SplitToRegion(torch.autograd.Function):
    """This rank's block of the last dim forward; the ranks' cotangent
    blocks concatenated backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        n = comm.axis_size(axis)
        size = x.shape[-1] // n
        return x.narrow(-1, comm.axis_index(axis) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.gather_from_region(g.contiguous(), ctx.axis, -1), None


class ColumnParallelLinear(nn.Module):
    """y = x @ W (+ b) with W's output columns split over ``tp`` (the
    reference's ``_parallel_linear`` at axis 1).  ``gather_output``: the
    output whole on every rank, else this rank's columns."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        lay = get_layout()
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = mark_sharding(
            _param((in_features, out_features), weight_attr or XavierNormal(),
                   device, dtype, generator), lay.param_spec("col_linear"))
        self.bias = (mark_sharding(
            _param((out_features,), Constant(0.0), device, dtype, generator),
            lay.param_spec("col_bias")) if has_bias else None)

    def split(self) -> bool:
        """Whether this rank holds a block of the columns."""
        return self.weight.shape[-1] != self.out_features

    def local(self, x):
        """This rank's columns of ``x @ W (+ b)``, no collective (the
        caller has passed ``x`` through ``copy_to_region``)."""
        return F.linear(x, self.weight, self.bias)

    def forward(self, x):
        if not self.split():
            return F.linear(x, self.weight, self.bias)
        axis = get_layout().act_axis("col_out")
        y = self.local(comm.copy_to_region(x, axis))
        return comm.gather_from_region(y, axis, -1) if self.gather_output \
            else y


class RowParallelLinear(nn.Module):
    """y = x @ W (+ b) with W's input rows split over ``tp`` (the
    reference's ``_parallel_linear`` at axis 0).  ``input_is_parallel``:
    ``x`` is already this rank's block of its last dim."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = mark_sharding(
            _param((in_features, out_features), weight_attr or XavierNormal(),
                   device, dtype, generator),
            get_layout().param_spec("row_linear"))
        self.bias = (_param((out_features,), Constant(0.0), device, dtype,
                            generator) if has_bias else None)

    def split(self) -> bool:
        return self.weight.shape[0] != self.in_features

    def forward(self, x):
        if not self.split():
            return F.linear(x, self.weight, self.bias)
        axis = get_layout().param_spec("row_linear")[0]
        if not self.input_is_parallel:
            x = _SplitToRegion.apply(x, axis)
        y = comm.reduce_from_region(F.linear(x, self.weight), axis)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class VocabParallelEmbedding(nn.Module):
    """Embedding with the table's rows split over ``tp`` (the reference's
    ``_parallel_embedding``): out-of-block ids are masked, looked up and
    zeroed, and the ranks' rows summed."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = mark_sharding(
            _param((num_embeddings, embedding_dim),
                   weight_attr or Normal(0.0, 0.02), device, dtype,
                   generator), get_layout().param_spec("embedding"))

    def forward(self, ids):
        n = self.weight.shape[0]
        if n == self._num_embeddings:
            return F.embedding(ids, self.weight)
        axis = get_layout().param_spec("embedding")[0]
        local = ids.long() - comm.axis_index(axis) * n
        inside = (local >= 0) & (local < n)
        out = F.embedding(torch.where(inside, local, 0), self.weight)
        out = torch.where(inside[..., None], out, out.new_zeros(()))
        return comm.reduce_from_region(out, axis)


class _RNGStateTracker:
    """Named random regions (the reference's ``get_rng_state_tracker``):
    ``add(name, seed)``, then ``rng_state(name)`` runs its block with
    PyTorch's default generators seeded from the global seed and the
    region's seed; their states outside the block are kept.  Ranks that
    add different seeds for a region draw different values there."""

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        self._states[name] = int(seed)

    def rng_state(self, name="local"):
        from .. import get_seed

        @contextlib.contextmanager
        def cm():
            cuda = (torch.cuda.is_available()
                    and torch.cuda.is_initialized())
            devices = [torch.cuda.current_device()] if cuda else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed((get_seed() * 1000003
                                   + self._states.get(name, 0)) % 2 ** 63)
                yield
        return cm()


_tracker = _RNGStateTracker()


def get_rng_state_tracker():
    return _tracker
