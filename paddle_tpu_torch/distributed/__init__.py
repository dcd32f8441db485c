"""Distributed training (counterpart of ``paddle_tpu.distributed``): so
far the one-device train step of ``fleet``."""
from . import fleet

__all__ = ["fleet"]
