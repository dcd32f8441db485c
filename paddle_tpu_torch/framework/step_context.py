"""Whether the running forward belongs to a train step that keeps only
the loss.

The reference engages its memory savers for the loss (the chunked LM
loss) only when the forward is traced under ``jit``, where the outputs
the step drops are dead code.  The port runs eagerly, so its
counterpart of "traced" is this flag: ``DistributedTrainStep`` sets it
around its forward (:func:`loss_only`), and a model reads it
(:func:`keeps_loss_only`) to skip outputs that no one will read.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["loss_only", "keeps_loss_only"]

_state = threading.local()


@contextlib.contextmanager
def loss_only():
    prev = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


def keeps_loss_only() -> bool:
    return getattr(_state, "on", False)
