"""Optimizer base (counterpart of the reference's ``optimizer/optimizer.py``).

Each optimizer defines a pure ``_update(p, g, lr, state) -> (new_p,
new_state)`` rule.  :meth:`Optimizer.step` applies it to every parameter
holding a ``.grad`` and writes the result into the parameter in place
(one parameter at a time, so the update's temporaries stay the size of
one parameter); :meth:`Optimizer.functional_update` applies it to lists
of tensors and returns new ones, as the reference's jitted train step
uses it.  The reference left this update to XLA with no Pallas kernel,
so plain PyTorch is the port.

Not ported yet (each raises ``NotImplementedError``): learning-rate
schedulers (``lr.py``), gradient clipping and regulariser weight decay.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

__all__ = ["Optimizer"]

_LATER = "is not ported yet (ROADMAP queue item 4)"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (no global program to "
                             "harvest them from)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"a learning-rate scheduler (lr.py) {_LATER}; pass a float")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip {_LATER}")
        if weight_decay is not None:
            raise NotImplementedError(
                f"regulariser weight decay {_LATER}; AdamW decays")
        self._parameter_list: List[torch.Tensor] = list(parameters)
        self._learning_rate = float(learning_rate)
        # state: parameter id -> dict of tensors on the parameter's device
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}

    def get_lr(self) -> float:
        return self._learning_rate

    def _create_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-parameter slot init (override)."""
        return {}

    def _update(self, p, g, lr, state):
        """Pure update rule (override): returns (new_p, new_state)."""
        raise NotImplementedError

    def _state(self, p) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._create_state(p)
        return st

    @torch.no_grad()
    def step(self):
        """Update every parameter that holds a gradient, in place."""
        lr = self.get_lr()
        for p in self._parameter_list:
            if p.grad is None:
                continue
            new_p, new_s = self._update(p, p.grad, lr, self._state(p))
            p.copy_(new_p)
            self._accumulators[id(p)] = new_s

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    # functional view ---------------------------------------------------
    def opt_state(self) -> List[Dict[str, torch.Tensor]]:
        """All accumulator state, aligned with the parameter list."""
        return [self._state(p) for p in self._parameter_list]

    def load_opt_state(self, states):
        for p, s in zip(self._parameter_list, states):
            self._accumulators[id(p)] = s

    @torch.no_grad()
    def functional_update(self, params: Sequence[torch.Tensor],
                          grads: Sequence[torch.Tensor], states, lr=None):
        """Pure batched update: new parameter and state lists, the inputs
        untouched."""
        lr = self.get_lr() if lr is None else float(lr)
        new_ps, new_ss = [], []
        for p, g, s in zip(params, grads, states):
            np_, ns = self._update(p, g, lr, s)
            new_ps.append(np_)
            new_ss.append(ns)
        return new_ps, new_ss
