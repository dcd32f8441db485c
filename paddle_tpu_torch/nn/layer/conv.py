"""The 2-D convolution layer.

Counterpart of ``paddle_tpu/nn/layer/conv.py`` (``_ConvNd``, ``Conv2D``):
an OIHW ``weight`` drawn from ``KaimingNormal(fan_in)`` and an optional
zero ``bias``, with the configuration kept under the reference's names
(``_stride``, ``_padding``, ``_dilation``, ``_groups``,
``_data_format``), which ``quantization.Int8InferenceConv2D`` reads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ... import resolve_device
from ..functional import conv as F
from .common import Constant, KaimingNormal, _param

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode {padding_mode!r}: only 'zeros' is ported")
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{data_format!r}")
        device = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = F._pair(kernel_size, 2)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = _param(
            (out_channels, in_channels // groups, *self._kernel_size),
            weight_attr or KaimingNormal(fan_in=fan_in), device, dtype,
            generator)
        self.bias = (None if bias_attr is False else
                     _param((out_channels,), bias_attr or Constant(0.0),
                            device, dtype, generator))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
