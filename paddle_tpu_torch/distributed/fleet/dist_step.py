"""DistributedTrainStep: the one-device plain training step of the
reference's ``distributed/fleet/dist_step.py``.

One call is one optimizer step: the forward and backward of
``loss_fn(*batch)``, then the optimizer's update of every parameter it
holds.  With ``strategy.amp`` (bfloat16) every f32 master parameter is
cast to bf16 inside the step, so the model computes in bf16 and the f32
gradients come out of the cast's backward; float batch tensors are cast
too, and the loss is taken in f32.  ``strategy.recompute`` recomputes
the whole forward during the backward (activation checkpointing of the
step).  The update writes into the parameters and the optimizer state in
place, one parameter at a time.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP
queue item 4): float16 loss scaling, ZeRO sharding, DGC, gradient
merge, the other parallel toggles, ``guard_health`` and a mesh of more
than one device.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .strategy import IMPLEMENTED_TOGGLES, DistributedStrategy

__all__ = ["DistributedTrainStep"]

_LATER = "is not ported yet (ROADMAP queue item 4)"


class _LossModule(nn.Module):
    """Holds the model as a child so ``functional_call`` can swap its
    parameters while ``loss_fn`` runs."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self._loss_fn = loss_fn

    def forward(self, *args):
        return self._loss_fn(*args)


class DistributedTrainStep:
    """Compile (model, loss_fn, optimizer, strategy) into one step::

        step = DistributedTrainStep(model, loss_fn, opt, strategy)
        for x, y in loader:
            loss = step(x, y)

    ``mesh`` may be None or a collection of one device.
    """

    def __init__(self, model, loss_fn, optimizer, strategy=None, mesh=None,
                 guard_health=False):
        strategy = strategy or DistributedStrategy()
        refused = [t for t in strategy.enabled()
                   if t not in IMPLEMENTED_TOGGLES]
        if refused:
            raise NotImplementedError(
                f"strategy toggles {refused}: {_LATER}; the port runs the "
                f"one-device step with {list(IMPLEMENTED_TOGGLES)}")
        amp_dtype = str(strategy.amp_configs["dtype"])
        if strategy.amp and amp_dtype not in ("bfloat16", "bf16"):
            raise NotImplementedError(
                f"float16 AMP with loss scaling (amp_configs dtype "
                f"{amp_dtype!r}) {_LATER}; use dtype='bfloat16'")
        hybrid = {k: v for k, v in strategy.hybrid_configs.items()
                  if v not in (1, -1)}
        if hybrid:
            raise NotImplementedError(f"hybrid_configs {hybrid} {_LATER}")
        if guard_health:
            raise NotImplementedError(f"guard_health {_LATER}")
        if mesh is not None and len(mesh) > 1:
            raise NotImplementedError(
                f"a mesh of {len(mesh)} devices {_LATER}")
        self._strategy = strategy
        self._amp = bool(strategy.amp)
        self._recompute = bool(strategy.recompute)
        self._opt = optimizer
        # align with the optimizer's parameter list (its state order)
        id2name = {id(p): n for n, p in model.named_parameters()}
        self._names = []
        for p in optimizer._parameter_list:
            n = id2name.get(id(p))
            if n is None:
                raise ValueError("optimizer holds a parameter that is not "
                                 "part of the model passed to "
                                 "DistributedTrainStep")
            self._names.append(n)
        self._params = list(optimizer._parameter_list)
        self._wrapper = _LossModule(model, loss_fn)

    def _amp_cast(self, t):
        if (self._amp and isinstance(t, torch.Tensor)
                and t.dtype == torch.float32):
            return t.to(torch.bfloat16)
        return t

    def loss_and_grads(self, *args):
        """The f32 loss of ``loss_fn(*args)`` and the gradients of the
        optimizer's parameters (f32 for f32 masters), without an update."""
        cast = [self._amp_cast(p) for p in self._params]
        args = tuple(self._amp_cast(a) for a in args)
        names = ["model." + n for n in self._names]

        def run(*params):
            return torch.func.functional_call(
                self._wrapper, dict(zip(names, params)), args)

        if self._recompute:
            loss = checkpoint(run, *cast, use_reentrant=False)
        else:
            loss = run(*cast)
        loss = loss.float()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def __call__(self, *args):
        loss, grads = self.loss_and_grads(*args)
        opt = self._opt
        lr = opt.get_lr()
        states = opt.opt_state()
        with torch.no_grad():
            for i, p in enumerate(self._params):
                (new_p,), (new_s,) = opt.functional_update(
                    [p], [grads[i]], [states[i]], lr)
                grads[i] = None
                p.copy_(new_p)
                states[i] = new_s
        opt.load_opt_state(states)
        return loss
