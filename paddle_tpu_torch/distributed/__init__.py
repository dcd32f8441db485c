"""Distributed training (counterpart of ``paddle_tpu.distributed``): so
far ``fleet``'s one-device train step and its parameter-server path."""
from . import fleet

__all__ = ["fleet"]
