"""Gradient clipping (counterpart of the reference's ``nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.

A clip is called on ``[(param, grad), ...]`` pairs (the optimizer's
eager ``step``) or on a list of gradients (:meth:`ClipGradBase.
apply_values`, the train step's form) and returns new gradients; the
inputs are not written.  The norms are sums of squares in the
gradient's dtype, the scale ``min(clip_norm / max(norm, 1e-12), 1)``.
The global clip keeps the reference's no-NaN-contagion rule: a
non-finite global norm scales nothing (scale 1), so one poisoned
gradient does not turn the healthy ones to NaN; finding and skipping
the bad step is ``train_guard``'s work."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError

    def apply_values(self, grads):
        """The clip of a list of gradient tensors (None entries kept)."""
        return [g for _, g in self([(None, g) for g in grads])]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


def _scale(norm, clip_norm):
    return torch.clamp_max(clip_norm / torch.clamp_min(norm, 1e-12), 1.0)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                g = g * _scale(torch.sqrt(torch.sum(g * g)), self.clip_norm)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        sq = [torch.sum(g * g) for _, g in params_grads if g is not None]
        if not sq:
            return params_grads
        gnorm = torch.sqrt(sum(sq))
        scale = torch.where(torch.isfinite(gnorm),
                            _scale(gnorm, self.clip_norm), 1.0)
        return [(p, None if g is None else g * scale)
                for p, g in params_grads]
