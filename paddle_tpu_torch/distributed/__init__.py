"""Distributed training (counterpart of ``paddle_tpu.distributed``): ranks
as processes (``init_parallel_env``, ``spawn``, ``launch
--nproc_per_node``), the mesh over them (``mesh``) with its spec rules
(``spec_layout``), the collective API (``collective``), the named-axis
collectives (``communication``), ``DataParallel``, the tensor-parallel
layers (``meta_parallel``) and the GPipe / 1F1B pipelines
(``pipeline``);
``fleet``'s API with its train step over dp x fsdp, its
parameter-server path (with geo replication) and its elastic data
plane; the feature admission entries (``entry``) and the checkpoint
format (``checkpoint``)."""
from . import (checkpoint, collective, communication, entry,  # noqa: F401
               fleet, mesh, meta_parallel, pipeline, spec_layout)
from .checkpoint import (CheckpointManager, load_state_dict,  # noqa: F401
                         save_state_dict)
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_reduce, alltoall, barrier, broadcast, get_group,
                         new_group, recv, reduce, reduce_scatter, scatter,
                         send, shard_map, split, wait)
from .entry import CountFilterEntry, ProbabilityEntry  # noqa: F401
from .mesh import get_mesh, init_mesh, set_mesh  # noqa: F401
from .meta_parallel import (ColumnParallelLinear,  # noqa: F401
                            RowParallelLinear, VocabParallelEmbedding,
                            get_rng_state_tracker, mark_sharding,
                            shard_parameter)
from .parallel import (DataParallel, ParallelEnv, get_rank,  # noqa: F401
                       get_world_size, global_batch, init_parallel_env)
from .spawn import spawn  # noqa: F401

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
    "DataParallel", "global_batch", "ReduceOp", "Group", "new_group",
    "get_group", "all_reduce", "all_gather", "reduce", "reduce_scatter",
    "broadcast", "scatter", "alltoall", "send", "recv", "barrier", "wait",
    "split", "shard_map", "init_mesh", "get_mesh", "set_mesh",
    "communication", "collective", "spec_layout", "fleet", "spawn",
    "checkpoint", "entry", "mesh", "CheckpointManager", "save_state_dict",
    "load_state_dict", "CountFilterEntry", "ProbabilityEntry",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "mark_sharding", "shard_parameter", "get_rng_state_tracker",
    "meta_parallel", "pipeline"]
