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
the bad step is ``train_guard``'s work.

A norm clip also takes ``sq_reduce``: for each gradient, None or a
function that sums a sum of squares (a one-element tensor, in place) over
the ranks holding the gradient's other rows (a ZeRO-split gradient of the
train step), so every norm spans the whole tensor."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads, sq_reduce=None):
        raise NotImplementedError

    def apply_values(self, grads, sq_reduce=None):
        """The clip of a list of gradient tensors (None entries kept)."""
        pairs = [(None, g) for g in grads]
        out = self(pairs) if sq_reduce is None else self(pairs, sq_reduce)
        return [g for _, g in out]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads, sq_reduce=None):
        return [(p, None if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


def _scale(norm, clip_norm):
    return torch.clamp_max(clip_norm / torch.clamp_min(norm, 1e-12), 1.0)


def _sum_sq(g, reduce=None):
    sq = torch.sum(g * g)
    return sq if reduce is None else reduce(sq.reshape(1))[0]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads, sq_reduce=None):
        reduces = sq_reduce or [None] * len(params_grads)
        out = []
        for (p, g), red in zip(params_grads, reduces):
            if g is not None:
                g = g * _scale(torch.sqrt(_sum_sq(g, red)), self.clip_norm)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads, sq_reduce=None):
        reduces = sq_reduce or [None] * len(params_grads)
        sq, split = [], {}         # split: reduce -> its tensors' squares
        for (_, g), red in zip(params_grads, reduces):
            if g is None:
                continue
            s = torch.sum(g * g)
            if red is None:
                sq.append(s)
            else:
                split.setdefault(red, []).append(s)
        if not sq and not split:
            return params_grads
        # one reduction a group of ranks
        sq += [red(sum(ss).reshape(1))[0] for red, ss in split.items()]
        gnorm = torch.sqrt(sum(sq))
        scale = torch.where(torch.isfinite(gnorm),
                            _scale(gnorm, self.clip_norm), 1.0)
        return [(p, None if g is None else g * scale)
                for p, g in params_grads]
