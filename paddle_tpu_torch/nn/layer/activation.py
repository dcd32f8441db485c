"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from torch import nn

from ..functional import activation as A
from ..functional import common as F

__all__ = ["ReLU", "GELU", "Tanh"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return A.gelu(x, self.approximate)


class Tanh(nn.Module):
    def forward(self, x):
        return A.tanh(x)
