"""Optimizers (counterpart of ``paddle_tpu.optimizer``): the base class,
Adam and AdamW."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
