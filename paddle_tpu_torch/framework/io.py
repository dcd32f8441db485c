"""Carry weights across from a ``paddle_tpu`` model.

``arrays`` is ``{name: np.ndarray}`` as the JAX model's ``state_dict()``
gives it: parameters and persistent buffers (batch norm's ``_mean`` and
``_variance``, an int8 layer's ``qweight``, ``w_scale`` and ``bias``).
Linear weights are [in, out] on both sides (the port computes ``x @ w``),
so no transposes are needed.  Each array is cast to the dtype of the
tensor it lands in: bf16 arrays arrive as float32 numpy (this package
cannot import ``ml_dtypes``), int8 stays int8, and an f32 ``w_scale``
stays f32 in a bf16 model.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_state_dict"]


def load_jax_state_dict(model: torch.nn.Module,
                        arrays: Mapping[str, np.ndarray]) -> None:
    """Copy ``arrays`` into ``model``'s parameters and persistent buffers
    in place.  Raises on any missing, extra or mis-shaped key, before
    anything is copied."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing={missing} "
                       f"extra={extra}")
    for name, p in own.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: array shape {shape} != model "
                             f"shape {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.ascontiguousarray(np.asarray(arrays[name]))
            p.copy_(torch.from_numpy(a).to(device=p.device, dtype=p.dtype))
