"""Optimizers (counterpart of ``paddle_tpu.optimizer``): the base class,
the zoo, the learning-rate schedulers (``lr``) and the Lookahead and
ModelAverage wrappers."""
from . import lr  # noqa: F401
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Lars, Momentum, RMSProp)
from .wrappers import LookaheadOptimizer, ModelAverage

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "lr",
           "LookaheadOptimizer", "ModelAverage"]
