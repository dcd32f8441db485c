"""Single-device linear and embedding layers, dropout, and the
initializers.

The counterpart of ``nn/layer/common.py``'s plain ``Linear``: the same
parameter names (``weight``, ``bias``) and the same [in, out] weight
layout, so a JAX ``state_dict`` loads without transposes.  The parallel
layers ``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` live in :mod:`...distributed.meta_parallel`
(one set for the models and ``distributed.split``); this module and
:mod:`.` re-export them.  Weights are created directly on
``device`` in ``dtype`` and drawn from an explicit ``torch.Generator``
(``None``: PyTorch's default generator).

``Embedding`` is the reference's plain embedding (``nn/layer/common.py:
62``: N(0, 1) weights, ``padding_idx``).  ``Dropout`` (``:122``) draws
its masks from the ``torch.Generator`` it holds: the one it is given, or
one on ``device`` seeded from the global seed (see
:func:`paddle_tpu_torch.make_generator`).  Layers that should draw
different masks share one generator (the BERT model passes its own to
every dropout).

``Linear`` is not a base of the parallel layers:
``quantization.convert_to_int8_inference`` swaps every ``Linear`` and,
as in the reference, leaves the parallel layers alone.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ... import make_generator, resolve_device
from ..functional import common as F

__all__ = ["Normal", "Constant", "XavierNormal", "KaimingNormal", "Linear",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "Embedding", "Dropout"]

_PARALLEL = ("ColumnParallelLinear", "RowParallelLinear",
             "VocabParallelEmbedding")


def __getattr__(name):
    # the parallel layers import this module, so they are re-exported on
    # first use rather than at import
    if name in _PARALLEL:
        from ...distributed import meta_parallel
        return getattr(meta_parallel, name)
    raise AttributeError(name)


class Normal:
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, t: torch.Tensor, generator):
        t.normal_(self.mean, self.std, generator=generator)


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, t: torch.Tensor, generator):
        t.fill_(self.value)


class XavierNormal:
    def __call__(self, t: torch.Tensor, generator):
        fan_in, fan_out = t.shape[0], t.shape[-1]
        t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                  generator=generator)


class KaimingNormal:
    """N(0, gain / sqrt(fan_in)) with the ReLU gain sqrt(2); ``fan_in``
    defaults to the weight's (in * kh * kw for OIHW)."""

    def __init__(self, fan_in: Optional[int] = None):
        self.fan_in = fan_in

    def __call__(self, t: torch.Tensor, generator):
        fan_in = self.fan_in or t.shape[1] * math.prod(t.shape[2:])
        t.normal_(0.0, math.sqrt(2.0) / math.sqrt(fan_in),
                  generator=generator)


def _param(shape, init, device, dtype, generator) -> nn.Parameter:
    t = torch.empty(shape, device=device, dtype=dtype)
    with torch.no_grad():
        init(t, generator)
    return nn.Parameter(t)


class _Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _param((in_features, out_features),
                             weight_attr or XavierNormal(), device, dtype,
                             generator)
        self.bias = (_param((out_features,), Constant(0.0), device, dtype,
                            generator) if has_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Linear(_Linear):
    """The reference's ``nn.Linear``: y = x @ W + b, W [in, out]
    XavierNormal, b zeros (``bias_attr=False`` drops it)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr is not False,
                         device=resolve_device(device), dtype=dtype,
                         generator=generator)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = _param((num_embeddings, embedding_dim),
                             weight_attr or Normal(0.0, 1.0),
                             resolve_device(device), dtype, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = (generator if generator is not None
                          else make_generator(device))

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
