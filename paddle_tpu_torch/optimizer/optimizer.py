"""Optimizer base (counterpart of the reference's ``optimizer/optimizer.py``).

Each optimizer defines a pure ``_update(p, g, lr, state) -> (new_p,
new_state)`` rule.  :meth:`Optimizer.step` applies it to every parameter
holding a ``.grad`` and writes the result into the parameter in place
(one parameter at a time, so the update's temporaries stay the size of
one parameter); :meth:`Optimizer.functional_update` applies it to lists
of tensors and returns new ones, as the reference's jitted train step
uses it (the port's train step applies it in place through
:meth:`_clip_values` and :meth:`_apply_one`).  The reference left this
update to XLA with no Pallas kernel, so plain PyTorch is the port.

As in the reference, ``learning_rate`` may be an
:class:`~.lr.LRScheduler` (read on every step; ``scheduler.step()`` is
the caller's), ``grad_clip`` a clip of :mod:`..nn.clip` applied to all
gradients before any update, and ``weight_decay`` a float (an
``L2Decay``) or a regularizer added to each gradient before its update.
A parameter's own ``regularizer`` attribute overrides the optimizer's,
and its ``optimize_attr["learning_rate"]`` multiplies the lr.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(like.device)
    return torch.as_tensor(np.asarray(v)).to(like.device)


def _is_int8(v) -> bool:
    return (v.dtype == torch.int8 if isinstance(v, torch.Tensor)
            else np.asarray(v).dtype == np.int8)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (no global program to "
                             "harvest them from)")
        self._parameter_list: List[torch.Tensor] = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (int, float)):
            from ..regularizer import L2Decay
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        # state: parameter id -> dict of tensors on the parameter's device
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0
        self._skipped_steps = 0   # guard / scaler-dropped steps (audit only)

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "set_lr is not allowed when the lr is an LRScheduler; call "
                "scheduler.step() instead (as the reference)")
        self._learning_rate = value

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

    # whether the update rule takes norms of the whole parameter (Lamb,
    # Lars): its ``_update`` then accepts ``sq_reduce``
    _whole_norms = False

    def _clip_values(self, grads, sq_reduce=None):
        """The optimizer's ``grad_clip`` over all gradients at once
        (``sq_reduce``: :mod:`..nn.clip`'s, for ZeRO-split gradients)."""
        if self._grad_clip is None:
            return list(grads)
        return self._grad_clip.apply_values(list(grads), sq_reduce)

    def _apply_one(self, p, g, lr, state, decay=None, sq_reduce=None):
        """Weight decay, then the update rule, for one (clipped)
        gradient.  ``sq_reduce``: for a parameter whose other rows other
        ranks hold (ZeRO), a function that sums a sum of squares (a
        one-element tensor, in place) over them, so the rule's norms span
        the whole parameter."""
        decay = decay if decay is not None else self._weight_decay
        if decay is not None:
            g = decay.apply_gradient(p, g)
        if sq_reduce is not None and self._whole_norms:
            return self._update(p, g, lr, state, sq_reduce=sq_reduce)
        return self._update(p, g, lr, state)

    @torch.no_grad()
    def step(self):
        """Update every parameter that holds a gradient, in place."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            lr_mult = getattr(p, "optimize_attr", {}).get("learning_rate",
                                                          1.0)
            plr = lr if lr_mult == 1.0 else lr * lr_mult
            new_p, new_s = self._apply_one(
                p, g, plr, self._state(p), getattr(p, "regularizer", None))
            p.copy_(new_p)
            self._accumulators[id(p)] = new_s
        self._global_step += 1

    minimize_step = step

    def grad_leaves(self) -> List[torch.Tensor]:
        """The gradient of every parameter holding one: the input of
        ``train_guard``'s fused health check and of ``GradScaler.
        unscale_``'s overflow test."""
        return [p.grad for p in self._parameter_list if p.grad is not None]

    def skip_step(self):
        """Drop this step's gradients without applying them (a guard's
        skip verdict, a scaler's overflow).  ``_global_step`` does not
        advance: a skipped step leaves the optimizer as if it never saw
        the batch."""
        self.clear_grad()
        self._skipped_steps += 1

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward and step in one call (the v1 spelling)."""
        loss.backward()
        self.step()
        return [], [(p, p.grad) for p in self._parameter_list]

    # checkpointing -----------------------------------------------------
    def _key(self, i, p) -> str:
        return getattr(p, "name", None) or f"param_{i}"

    def state_dict(self):
        """``global_step``, the scheduler's state under ``LR_Scheduler``
        and every slot as ``"<param name or param_i>.<slot>"``."""
        out = {"global_step": self._global_step}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for i, p in enumerate(self._parameter_list):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                out[f"{self._key(i, p)}.{k}"] = v
        return out

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if (isinstance(self._learning_rate, LRScheduler)
                and "LR_Scheduler" in state_dict):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            st = self._create_state(p)
            found = False
            for k in st:
                v = state_dict.get(f"{self._key(i, p)}.{k}")
                if v is not None:
                    dt = torch.int8 if _is_int8(v) else st[k].dtype
                    st[k] = _as_tensor(v, p).to(dt)
                    found = True
            # an int8 slot saved from a train step with moment_dtype
            # "int8" rides with its "<slot>@scale" scales: decoded back to
            # f32 here, so no other step or the eager step sees raw codes
            for k in list(st):
                sc = state_dict.get(f"{self._key(i, p)}.{k}@scale")
                if sc is not None and st[k].dtype == torch.int8:
                    from .slot_codec import _q8_decode
                    st[k] = _q8_decode(st[k], _as_tensor(sc, p).float())
            if found:
                self._accumulators[id(p)] = st

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
        untouched.  Applies ``grad_clip`` (over all of ``grads``) and the
        weight decay exactly as :meth:`step` does."""
        lr = self.get_lr() if lr is None else float(lr)
        new_ps, new_ss = [], []
        for p, g, s in zip(params, self._clip_values(grads), states):
            np_, ns = self._apply_one(p, g, lr, s)
            new_ps.append(np_)
            new_ss.append(ns)
        return new_ps, new_ss
