"""Fleet training (counterpart of ``paddle_tpu.distributed.fleet``): the
strategy config and the one-device train step."""
from .dist_step import DistributedTrainStep
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "DistributedTrainStep"]
