"""Optimizers (counterpart of ``paddle_tpu.optimizer``): the base class,
Momentum, Adam and AdamW."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW, Momentum

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]
