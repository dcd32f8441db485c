"""The ResNet family.

Counterpart of ``paddle_tpu/vision/models/resnet.py``: ``BasicBlock``,
``BottleneckBlock`` (stride on the 3x3 conv), ``ResNet`` and
``resnet18/34/50/101/152`` with the wide variants.  Parameter and buffer
names are the reference's (``layer1.0.conv1.weight``,
``layer1.0.downsample.1._mean``, ``fc.weight`` as [in, out], ...), so a
JAX ``state_dict`` carries across with ``framework.io.load_jax_state_dict``.
NCHW (the default) and NHWC are supported.

``device`` defaults to ``cuda`` (raises without a card); ``dtype`` is the
parameter dtype (float32 unless asked); ``generator`` draws the initial
weights (default: the global seed, see :func:`paddle_tpu_torch.seed`).
In training mode batch norm takes the batch statistics and updates its
running statistics; the convolutions' backward is autograd over
``torch.nn.functional.conv2d`` (cuDNN on the card), as the reference
left it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import make_generator, resolve_device
from ...framework.dtype import to_torch
from ...nn.functional import flatten
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                         MaxPool2D, ReLU)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = dict(data_format=data_format, device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, generator=generator, **df)
        self.bn1 = norm_layer(planes, **df)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            generator=generator, **df)
        self.bn2 = norm_layer(planes, **df)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = dict(data_format=data_format, device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            generator=generator, **df)
        self.bn1 = norm_layer(width, **df)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation,
                            bias_attr=False, generator=generator, **df)
        self.bn2 = norm_layer(width, **df)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, generator=generator, **df)
        self.bn3 = norm_layer(planes * self.expansion, **df)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = to_torch(dtype) if dtype is not None else torch.float32
        gen = generator if generator is not None else make_generator(dev)
        self._kw = dict(device=dev, dtype=dt)
        self.data_format = data_format
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        df = dict(data_format=data_format, **self._kw)
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, generator=gen, **df)
        self.bn1 = self._norm_layer(self.inplanes, **df)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], gen=gen)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, gen)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, gen)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, gen)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             generator=gen, **self._kw)

    def _make_layer(self, block, planes, blocks, stride=1, gen=None):
        norm_layer = self._norm_layer
        df = dict(data_format=self.data_format, **self._kw)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, generator=gen,
                       **df),
                norm_layer(planes * block.expansion, **df))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        generator=gen, **df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes,
                                groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, generator=gen,
                                **df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights need a download; carry a converted "
            "checkpoint across with framework.io.load_jax_state_dict")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)
