"""Batch normalisation over 2-D feature maps, and layer normalisation.

Counterpart of ``paddle_tpu/nn/layer/norm.py`` (``_BatchNormBase``,
``BatchNorm2D``, ``LayerNorm``).  ``BatchNorm2D``: ``weight`` ones and ``bias`` zeros as parameters, the
running statistics as persistent buffers under the reference's names
``_mean`` (zeros) and ``_variance`` (ones), so a JAX ``state_dict``
carries across.  In training mode the forward normalises with the batch
statistics and updates the running statistics in place (see
``functional.batch_norm``); in eval mode it applies them.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ..functional import common as F
from .common import Constant, _param

__all__ = ["BatchNorm2D", "LayerNorm"]


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False else
                       _param((num_features,), weight_attr or Constant(1.0),
                              device, dtype, None))
        self.bias = (None if bias_attr is False else
                     _param((num_features,), bias_attr or Constant(0.0),
                            device, dtype, None))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device, dtype=dtype))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device,
                                                     dtype=dtype))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        shape = tuple(self._normalized_shape)
        affine = weight_attr is not False and bias_attr is not False
        self.weight = (_param(shape, weight_attr or Constant(1.0), device,
                              dtype, None) if affine else None)
        self.bias = (_param(shape, bias_attr or Constant(0.0), device,
                            dtype, None) if affine else None)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
