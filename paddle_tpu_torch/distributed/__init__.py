"""Distributed training (counterpart of ``paddle_tpu.distributed``):
``fleet``'s API, its one-device train step, its parameter-server path
(with geo replication) and its elastic data plane; the feature admission
entries (``entry``), the checkpoint format (``checkpoint``), the device
mesh (``mesh``) and the elastic launcher (``launch``)."""
from . import checkpoint, entry, fleet, mesh  # noqa: F401
from .checkpoint import (CheckpointManager, load_state_dict,  # noqa: F401
                         save_state_dict)
from .entry import CountFilterEntry, ProbabilityEntry  # noqa: F401

__all__ = ["fleet", "checkpoint", "entry", "mesh", "CheckpointManager",
           "save_state_dict", "load_state_dict", "CountFilterEntry",
           "ProbabilityEntry"]
