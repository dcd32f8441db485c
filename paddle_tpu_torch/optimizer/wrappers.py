"""Optimizer wrappers (counterpart of the reference's
``optimizer/wrappers.py``): ``LookaheadOptimizer`` and ``ModelAverage``.

Both wrap any optimizer of the port and work on the parameters in
place.  Lookahead keeps slow weights from the initial parameters; every
``k`` inner steps they move ``alpha`` of the way towards the fast
weights, and the fast weights are reset to them.  ModelAverage keeps an
exponentially decayed sum of the parameters over a window that grows
with training (``average_window_rate`` of the steps, between
``min_average_window`` and ``max_average_window``) and a denominator
decayed alike; ``apply()`` swaps the averages in and ``restore()`` swaps
the parameters back.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

__all__ = ["LookaheadOptimizer", "ModelAverage"]


class LookaheadOptimizer:
    """Lookahead (k steps forward, 1 step back)."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if k < 1:
            raise ValueError("k must be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._parameter_list = list(inner_optimizer._parameter_list)
        # slow weights start at the initial parameters
        self._slow: List[torch.Tensor] = [p.detach().clone()
                                          for p in self._parameter_list]

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for i, p in enumerate(self._parameter_list):
                slow = self._slow[i] + self.alpha * (p - self._slow[i])
                self._slow[i] = slow
                p.copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        return {"inner": self.inner_optimizer.state_dict(),
                "step_count": self._step_count,
                "slow": [s.cpu().numpy() for s in self._slow]}

    def set_state_dict(self, sd):
        self.inner_optimizer.set_state_dict(sd["inner"])
        self._step_count = int(sd.get("step_count", 0))
        if "slow" in sd:
            self._slow = [torch.as_tensor(np.asarray(s)).to(p.device)
                          for s, p in zip(sd["slow"], self._parameter_list)]

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """Running average of the parameters for evaluation."""

    def __init__(self, average_window_rate: float = 0.15,
                 parameters=None, min_average_window: int = 10000,
                 max_average_window: int = 10000 * 10):
        if parameters is None:
            raise ValueError("parameters is required")
        self._params = list(parameters)
        self._rate = average_window_rate
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._sum = [torch.zeros_like(p) for p in self._params]
        self._denom = 0.0   # accumulated with the same decays as _sum
        self._count = 0
        self._saved: Optional[List[torch.Tensor]] = None

    def _window(self) -> int:
        return max(self._min_w,
                   min(self._max_w, int(self._count * self._rate) or 1))

    @torch.no_grad()
    def step(self):
        """Accumulate the current parameters (call after the optimizer's
        step)."""
        decay = 1.0 - 1.0 / self._window()
        for i, p in enumerate(self._params):
            self._sum[i] = self._sum[i] * decay + p
        # the denominator sees the same decays as the sum: a closed-form
        # geometric series would assume one decay while the window grows
        self._denom = self._denom * decay + 1.0
        self._count += 1

    def _average(self, i):
        return self._sum[i] / (self._denom or 1.0)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        """Swap the averaged weights in for the body of the ``with``."""
        if self._count == 0:
            yield
            return
        self._saved = [p.detach().clone() for p in self._params]
        with torch.no_grad():
            for i, p in enumerate(self._params):
                p.copy_(self._average(i))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._saved is not None:
            for p, v in zip(self._params, self._saved):
                p.copy_(v)
            self._saved = None
