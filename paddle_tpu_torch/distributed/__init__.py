"""Distributed training (counterpart of ``paddle_tpu.distributed``):
``fleet``'s one-device train step, its parameter-server path and its
elastic data plane; the checkpoint format (``checkpoint``), the device
mesh (``mesh``) and the elastic launcher (``launch``)."""
from . import checkpoint, fleet, mesh  # noqa: F401
from .checkpoint import (CheckpointManager, load_state_dict,  # noqa: F401
                         save_state_dict)

__all__ = ["fleet", "checkpoint", "mesh", "CheckpointManager",
           "save_state_dict", "load_state_dict"]
