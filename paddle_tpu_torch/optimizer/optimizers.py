"""The optimizer zoo (counterpart of the reference's ``optimizers.py``):
SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp, Lamb and
Lars.

The same arithmetic, in the same order and dtypes, as the reference's
update rules.  SGD and Momentum work in the parameter's dtype (Momentum
keeps its velocity there, casts the gradient and ``lr`` to it, and
steps by ``v``, or by ``g + momentum * v`` with ``use_nesterov``).
Adam keeps f32 moments ``m`` / ``v`` and the running ``beta1_pow`` /
``beta2_pow`` as 0-dim f32 tensors and steps by ``lr * m_hat /
(sqrt(v_hat) + eps)``; AdamW applies the decoupled decay ``p * (1 - lr
* coeff * decay)`` before the step.  The others create their slots in
the parameter's dtype, as the reference does, and compute in f32 from
an f32 copy of the gradient (so their slots are f32 after the first
step).  Lamb scales each parameter's step by the trust ratio
``|p| / |r|`` and Lars its lr by ``coeff |p| / (|g| + wd |p| + eps)``
(both 1 where a norm is 0).
"""
from __future__ import annotations

import functools

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "Lars"]


@functools.lru_cache(maxsize=64)
def _scalar(x, dtype):
    """``x`` as a 0-dim CPU tensor of ``dtype``: the constant is rounded
    to the parameter's dtype first, as JAX rounds a weakly typed scalar
    (and as the reference casts ``lr``).  Cached: the update reads it and
    never writes it."""
    return torch.tensor(float(x), dtype=torch.float32).to(dtype)


class SGD(Optimizer):
    def _update(self, p, g, lr, state):
        return p - _scalar(lr, p.dtype) * g.to(p.dtype), state


def _one(p):
    return torch.ones((), dtype=torch.float32, device=p.device)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        self._momentum = momentum
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, p, g, lr, state):
        g = g.to(p.dtype)
        mu = _scalar(self._momentum, p.dtype)
        v = mu * state["velocity"] + g
        step = g + mu * v if self._nesterov else v
        return p - _scalar(lr, p.dtype) * step, {"velocity": v}


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
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _one(p), "beta2_pow": _one(p)}

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
    as for the reference's unnamed parameters).  ``lr_ratio`` is
    accepted and, as in the reference's AdamW, not applied."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_state(self, p):
        return {"m": torch.zeros_like(p), "inf_norm": torch.zeros_like(p),
                "beta1_pow": _one(p)}

    def _update(self, p, g, lr, state):
        g32 = g.float()
        m = self._beta1 * state["m"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g32))
        b1p = state["beta1_pow"] * self._beta1
        step = lr * m / ((1 - b1p) * (u + self._eps))
        return ((p.float() - step).to(p.dtype),
                {"m": m, "inf_norm": u, "beta1_pow": b1p})


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        self._eps = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update(self, p, g, lr, state):
        g32 = g.float()
        acc = state["moment"] + g32 * g32
        step = lr * g32 / (torch.sqrt(acc) + self._eps)
        return (p.float() - step).to(p.dtype), {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._eps = epsilon
        self._rho = rho
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_state(self, p):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    def _update(self, p, g, lr, state):
        g32 = g.float()
        asg = self._rho * state["avg_sq_grad"] + (1 - self._rho) * g32 * g32
        upd = (torch.sqrt(state["avg_sq_update"] + self._eps)
               / torch.sqrt(asg + self._eps)) * g32
        asu = self._rho * state["avg_sq_update"] + (1 - self._rho) * upd * upd
        return ((p.float() - lr * upd).to(p.dtype),
                {"avg_sq_grad": asg, "avg_sq_update": asu})


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._rho = rho
        self._eps = epsilon
        self._momentum = momentum
        self._centered = centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_state(self, p):
        st = {"mean_square": torch.zeros_like(p),
              "momentum": torch.zeros_like(p)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p)
        return st

    def _update(self, p, g, lr, state):
        g32 = g.float()
        ms = self._rho * state["mean_square"] + (1 - self._rho) * g32 * g32
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * g32
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * state["momentum"] + lr * g32 / denom
        new_state = {"mean_square": ms, "momentum": mom}
        if self._centered:
            new_state["mean_grad"] = mg
        return (p.float() - mom).to(p.dtype), new_state


def _norm(x, sq_reduce=None):
    """The 2-norm of ``x``; ``sq_reduce`` sums its square over the ranks
    holding the parameter's other rows (``Optimizer._apply_one``)."""
    sq = torch.sum(x * x)
    if sq_reduce is not None:
        sq = sq_reduce(sq.reshape(1))[0]
    return torch.sqrt(sq)


class Lamb(Optimizer):
    """Layer-wise adaptive moments for large batches; ``lamb_weight_decay``
    joins the step (not the gradient), and ``exclude_from_weight_decay_fn
    (param)`` turns it off for a parameter."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._lamb_wd = lamb_weight_decay
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._wd_flags = {
            id(p): 0.0 if (exclude_from_weight_decay_fn is not None
                           and exclude_from_weight_decay_fn(p)) else 1.0
            for p in self._parameter_list}

    def _create_state(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
                "beta1_pow": _one(p), "beta2_pow": _one(p),
                "wd": torch.tensor(self._wd_flags.get(id(p), 1.0)
                                   * self._lamb_wd, dtype=torch.float32,
                                   device=p.device)}

    _whole_norms = True

    def _update(self, p, g, lr, state, sq_reduce=None):
        g32, p32 = g.float(), p.float()
        m = self._beta1 * state["m"] + (1 - self._beta1) * g32
        v = self._beta2 * state["v"] + (1 - self._beta2) * g32 * g32
        b1p = state["beta1_pow"] * self._beta1
        b2p = state["beta2_pow"] * self._beta2
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        r = m_hat / (torch.sqrt(v_hat) + self._eps) + state["wd"] * p32
        w_norm, r_norm = _norm(p32, sq_reduce), _norm(r, sq_reduce)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        return ((p32 - lr * trust * r).to(p.dtype),
                {"m": m, "v": v, "beta1_pow": b1p, "beta2_pow": b2p,
                 "wd": state["wd"]})


class Lars(Optimizer):
    """Layer-wise adaptive rate scaling with momentum.
    ``exclude_from_weight_decay`` is accepted and, as in the reference,
    not applied."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay
        self._eps = epsilon
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _create_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    _whole_norms = True

    def _update(self, p, g, lr, state, sq_reduce=None):
        g32, p32 = g.float(), p.float()
        w_norm, g_norm = _norm(p32, sq_reduce), _norm(g32, sq_reduce)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._coeff * w_norm / (g_norm + self._wd * w_norm + self._eps),
            1.0)
        v = (self._momentum * state["velocity"]
             + lr * local_lr * (g32 + self._wd * p32))
        return (p32 - v).to(p.dtype), {"velocity": v}
