"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from torch import nn

from ..functional import common as F

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)
