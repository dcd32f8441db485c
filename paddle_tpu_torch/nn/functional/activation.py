"""GELU and tanh (counterparts of ``paddle_tpu/nn/functional/
activation.py``'s ``gelu`` and ``tanh``).

``gelu`` is ``jax.nn.gelu``: the erf form ``x * (1 + erf(x / sqrt(2))) /
2`` by default, the tanh form with ``approximate=True``, in the input
dtype.  The reference left both to XLA with no Pallas kernel, so plain
PyTorch is the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["gelu", "tanh"]


def gelu(x, approximate=False):
    with torch.profiler.record_function("gelu"):
        return tF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)
