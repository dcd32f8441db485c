"""Fleet training (counterpart of ``paddle_tpu.distributed.fleet``): the
strategy config, the one-device train step, the parameter-server path
(the host ``SparseTable``, the ``DeviceCachedTable`` on the card, the
pipelined ``HeterTrainer``, and the PS service: ``PSServer`` with its
standby and read replicas, ``PSClient`` and ``RemoteTable``) and the
elastic data plane
(``ElasticCoordinator``, ``ElasticTrainer`` over ``DeviceZeroEngine``,
the ZeRO shard math and the fused optimizer apply)."""
from .dist_step import (DistributedTrainStep, LRSchedule,
                        flatten_zero_state, fused_optimizer_apply,
                        make_lr_schedule, unflatten_zero_state,
                        zero_reshard, zero_shard, zero_shard_ranges,
                        zero_unshard)
from .elastic import (CoordinatorLost, ElasticClient, ElasticCoordinator,
                      ElasticTrainer, Reform)
from .elastic_engine import DeviceZeroEngine, ReshardMeter
from .heter import DeviceCachedTable, HeterTrainer, RemoteTable
from .ps import SparseTable
from .ps_service import (PSClient, PSConnectError, PSError, PSServer,
                         PSUnavailable)
from .role_maker import ElasticRoleMaker, Role, RoleMakerBase
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "DistributedTrainStep", "SparseTable",
           "DeviceCachedTable", "HeterTrainer", "RemoteTable", "PSServer",
           "PSClient", "PSError", "PSConnectError", "PSUnavailable", "ElasticCoordinator",
           "ElasticClient", "ElasticTrainer", "Reform", "CoordinatorLost",
           "DeviceZeroEngine", "ReshardMeter", "Role", "RoleMakerBase",
           "ElasticRoleMaker", "LRSchedule", "make_lr_schedule",
           "zero_shard_ranges", "flatten_zero_state",
           "unflatten_zero_state", "zero_shard", "zero_unshard",
           "zero_reshard", "fused_optimizer_apply"]
