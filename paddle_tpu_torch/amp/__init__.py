"""Automatic mixed precision (counterpart of ``paddle_tpu.amp``):
``auto_cast`` / ``autocast``, ``decorate`` and ``GradScaler``.

Under ``auto_cast(dtype=...)`` the port's white-listed functionals
(``nn.functional.linear`` and ``conv2d``) cast their float32 operands to
the autocast dtype (bfloat16 or float16) through
:func:`maybe_cast_inputs`, as the reference's ``linear`` / ``conv`` /
``matmul`` do; everything else keeps its dtype.  The white and black
lists are the reference's.  ``torch.autocast`` is not used: its op lists
cast other ops than the reference's.

``GradScaler`` is the reference's dynamic loss scaling: ``scale(loss)``
multiplies by the scale; ``unscale_`` multiplies every gradient by
``1 / scale`` and tests them for overflow with ``train_guard``'s fused
health check (one host fetch for the whole tree); ``step`` skips the
update on an overflow; ``update`` grows the scale by ``incr_ratio``
after ``incr_every_n_steps`` finite steps in a row (at most 2**32) and
shrinks it by ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps
in a row (at least 1).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework.dtype import to_torch

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler",
           "white_list", "black_list", "amp_state", "maybe_cast_inputs"]

_state = threading.local()

# the reference's op lists (its names)
white_list = {"matmul", "conv2d", "conv1d", "conv3d", "linear", "einsum",
              "bmm", "mm", "mv"}
black_list = {"softmax", "log_softmax", "layer_norm", "batch_norm", "mean",
              "sum", "exp", "log", "cross_entropy"}


def amp_state():
    return getattr(_state, "amp", None)


class auto_cast(contextlib.ContextDecorator):
    """``with auto_cast(dtype="float16"):``: white-listed ops compute in
    ``dtype`` (bfloat16 by default)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = (torch.bfloat16 if dtype in ("bfloat16", "bf16")
                      else torch.float16)
        self.custom_white = set(custom_white_list or [])
        self.custom_black = set(custom_black_list or [])

    def __enter__(self):
        self._prev = amp_state()
        _state.amp = self if self.enable else None
        return self

    def __exit__(self, *exc):
        _state.amp = self._prev
        return False

    def should_cast(self, op_name: str) -> bool:
        if op_name in self.custom_black or op_name in black_list:
            return False
        if self.level == "O2":
            return True
        return op_name in white_list or op_name in self.custom_white


autocast = auto_cast


def maybe_cast_inputs(op_name, *vals):
    """Called by the white-listed functionals: their float32 operands in
    the autocast dtype when an ``auto_cast`` is active and casts
    ``op_name``, else unchanged."""
    st = amp_state()
    if st is None or not st.should_cast(op_name):
        return vals
    return tuple(v.to(st.dtype) if isinstance(v, torch.Tensor)
                 and v.dtype == torch.float32 else v for v in vals)


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, **kw):
    """O2 casts the models' parameters to ``dtype`` (the optimizers keep
    their f32 arithmetic); O1 changes nothing."""
    if level == "O2" and models is not None:
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=to_torch(dtype))
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (the reference's state machine, module
    docstring).  ``enable=False`` makes every method a pass-through."""

    # unbounded growth overflows the scale to inf on a long clean run,
    # and the next scale(loss) turns a healthy step to NaN
    MAX_LOSS_SCALING = 2.0 ** 32

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True,
                 max_loss_scaling=None):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._max_scale = float(max_loss_scaling
                                if max_loss_scaling is not None
                                else self.MAX_LOSS_SCALING)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._last_health = None   # HealthState of the last unscale_
        self._unscaled = set()     # optimizers already unscaled this step

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Unscale the gradients in place and record ``found_inf`` from
        one fused reduction and one host fetch for the whole tree."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        inv = 1.0 / self._scale
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad = p.grad * inv
        from ..train_guard import health_check
        h = health_check(optimizer)
        self._last_health = h      # a co-operating TrainGuard reuses it
        self._found_inf = h.nonfinite_count > 0
        self._unscaled.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)   # a no-op if the caller unscaled already
        if not self._found_inf:
            optimizer.step()
        self.update()
        self._unscaled.discard(id(optimizer))

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale = min(self._scale * self._incr_ratio,
                                  self._max_scale)
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    is_use_dynamic_loss_scaling = is_enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]
