"""Adam and AdamW (counterparts of the reference's ``optimizers.py``).

The same f32 arithmetic, in the same order, as the reference's update
rules: f32 moments ``m`` / ``v``, the running ``beta1_pow`` /
``beta2_pow`` as 0-dim f32 tensors, bias-corrected step
``lr * m_hat / (sqrt(v_hat) + eps)``, and for AdamW the decoupled decay
``p * (1 - lr * coeff * decay)`` before the step.  The other optimizers
of the reference's zoo are not ported yet.
"""
from __future__ import annotations

import torch

from .optimizer import _LATER, Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_state(self, p):
        def one():
            return torch.ones((), dtype=torch.float32, device=p.device)
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": one(), "beta2_pow": one()}

    def _adam_core(self, p, g, lr, state):
        g32 = g.float()
        m = self._beta1 * state["m"] + (1 - self._beta1) * g32
        v = self._beta2 * state["v"] + (1 - self._beta2) * (g32 * g32)
        b1p = state["beta1_pow"] * self._beta1
        b2p = state["beta2_pow"] * self._beta2
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        step = lr * m_hat / (torch.sqrt(v_hat) + self._eps)
        return step, {"m": m, "v": v, "beta1_pow": b1p, "beta2_pow": b2p}

    def _update(self, p, g, lr, state):
        step, new_state = self._adam_core(p, g, lr, state)
        return (p.float() - step).to(p.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay.  ``apply_decay_param_fun(name)`` chooses
    the decayed parameters by their ``name`` attribute ("" where unset,
    as for the reference's unnamed parameters)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(f"AdamW lr_ratio {_LATER}")
        self._coeff = weight_decay if isinstance(weight_decay, (int, float)) \
            else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._decay_flags = {
            id(p): (apply_decay_param_fun is None
                    or bool(apply_decay_param_fun(getattr(p, "name", ""))))
            for p in self._parameter_list}

    def _create_state(self, p):
        st = super()._create_state(p)
        st["decay"] = torch.tensor(
            1.0 if self._decay_flags.get(id(p), True) else 0.0,
            dtype=torch.float32, device=p.device)
        return st

    def _update(self, p, g, lr, state):
        step, new_state = self._adam_core(p, g, lr, state)
        decay = state["decay"]
        p32 = p.float() * (1.0 - lr * self._coeff * decay)
        new_state["decay"] = decay
        return (p32 - step).to(p.dtype), new_state
