"""Fleet (counterpart of ``paddle_tpu.distributed.fleet``): the fleet API
(``fleet.init``, the role queries, ``util``, the parameter-server
lifecycle ``init_server`` / ``run_server`` / ``init_worker`` /
``stop_worker`` over ``PSRuntime``, the role makers and ``UtilBase``,
the metric aggregation ``metrics``), the strategy config, the
one-device train step, the parameter-server path (the host
``SparseTable`` with its spill tier, admission and geo stamps, the
``DeviceCachedTable`` on the card, the pipelined ``HeterTrainer``, and
the PS service: ``PSServer`` with its standby and read replicas,
``PSClient`` and ``RemoteTable``), geo replication (``GeoPusher``) and
the elastic data plane (``ElasticCoordinator``, ``ElasticTrainer`` over
``DeviceZeroEngine``, the ZeRO shard math and the fused optimizer
apply)."""
from . import dgc, geo, metrics  # noqa: F401
from .dist_step import (DistributedTrainStep, LRSchedule,
                        flatten_zero_state, fused_optimizer_apply,
                        make_lr_schedule, unflatten_zero_state,
                        zero_reshard, zero_shard, zero_shard_ranges,
                        zero_unshard)
from .elastic import (CoordinatorLost, ElasticClient, ElasticCoordinator,
                      ElasticTrainer, Reform)
from .elastic_engine import DeviceZeroEngine, ReshardMeter
from .fleet_base import (Fleet, barrier_worker, distributed_model,
                         distributed_optimizer, distributed_train_step,
                         init, init_server, init_worker, is_first_worker,
                         is_server, is_worker, run_server, server_endpoints,
                         server_index, server_num, stop_worker,
                         worker_endpoints, worker_index, worker_num)
from .geo import GeoPusher
from .heter import DeviceCachedTable, HeterTrainer, RemoteTable
from .ps import PSRuntime, SparseTable
from .ps_service import (PSClient, PSConnectError, PSError, PSServer,
                         PSUnavailable)
from .role_maker import (ElasticRoleMaker, PaddleCloudRoleMaker, Role,
                         RoleMakerBase, UserDefinedRoleMaker, UtilBase)
from .strategy import DistributedStrategy, warn_noop_toggles

__all__ = ["init", "is_first_worker", "worker_index", "worker_num",
           "is_worker", "worker_endpoints", "server_num", "server_index",
           "server_endpoints", "is_server", "barrier_worker", "init_worker",
           "init_server", "run_server", "stop_worker",
           "distributed_optimizer", "distributed_model",
           "distributed_train_step", "Fleet", "PSRuntime", "metrics",
           "geo", "GeoPusher", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "UtilBase",
           "DistributedStrategy", "DistributedTrainStep", "SparseTable",
           "DeviceCachedTable", "HeterTrainer", "RemoteTable", "PSServer",
           "PSClient", "PSError", "PSConnectError", "PSUnavailable",
           "ElasticCoordinator", "ElasticClient", "ElasticTrainer",
           "Reform", "CoordinatorLost", "DeviceZeroEngine", "ReshardMeter",
           "Role", "RoleMakerBase", "ElasticRoleMaker", "LRSchedule",
           "make_lr_schedule", "zero_shard_ranges", "flatten_zero_state",
           "unflatten_zero_state", "zero_shard", "zero_unshard",
           "zero_reshard", "fused_optimizer_apply", "dgc",
           "warn_noop_toggles"]
