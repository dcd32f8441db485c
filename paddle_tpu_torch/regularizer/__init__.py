"""Weight-decay regularizers (counterpart of the reference's
``regularizer/__init__.py``): ``L1Decay`` and ``L2Decay`` add their
term to a gradient before the optimizer's update, in the gradient's
dtype."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def apply_gradient(self, p, g):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = coeff

    def apply_gradient(self, p, g):
        return g + self.coeff * torch.sign(p).to(g.dtype)


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = coeff

    def apply_gradient(self, p, g):
        return g + self.coeff * p.to(g.dtype)
