"""Fleet training (counterpart of ``paddle_tpu.distributed.fleet``): the
strategy config, the one-device train step, and the parameter-server path
(the host ``SparseTable``, the ``DeviceCachedTable`` on the card and the
pipelined ``HeterTrainer``)."""
from .dist_step import DistributedTrainStep
from .heter import DeviceCachedTable, HeterTrainer
from .ps import SparseTable
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "DistributedTrainStep", "SparseTable",
           "DeviceCachedTable", "HeterTrainer"]
