"""DistributedStrategy: the subset of the reference's strategy config
(``distributed/fleet/strategy.py``) that the port runs.

Every toggle and config dict of the reference is accepted under its
name, so a strategy written for the reference builds here.  The port's
:class:`~.dist_step.DistributedTrainStep` runs ``amp`` (bf16 compute
over f32 master weights, or float16 with loss scaling),
``recompute``, ``gradient_merge``, ``sharding`` (ZeRO stages 1-3,
``moment_dtype``, ``offload``) and ``dgc`` over a mesh of ``dp`` x
``fsdp`` ranks, and ``pipeline``, ``tensor_parallel`` and
``sequence_parallel`` over ``pp``, ``tp`` and ``sp`` ranks
(``mesh_degrees``: the ``tensor_parallel_configs`` /
``sequence_parallel_configs`` degrees and ``hybrid_configs`` ``mp`` /
``pp`` / ``sep``, as the reference maps them); it refuses every other
toggle that is on with ``NotImplementedError``.  As in the reference's
step, the model's config decides the pipeline's schedule and
microbatches (``LlamaConfig.pp_num_microbatches``) and the attention
over ``sp`` (``context_parallel``): ``pipeline_configs`` and
``sequence_parallel_configs["mode"]`` are accepted and read by no
step.  ``fleet.distributed_optimizer`` swaps
in ``Lamb`` / ``Lars`` for the ``lamb`` / ``lars`` toggles.
``warn_noop_toggles`` warns once a strategy about accepted toggles and
config keys that have no effect (``fp16_allreduce``: gradients already
cross in their compute dtype).  The parameter-server modes read
``a_sync`` and ``a_sync_configs`` (``PSRuntime.init_worker``).
"""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy", "IMPLEMENTED_TOGGLES", "NOOP_TOGGLES",
           "warn_noop_toggles"]

# toggles the port's DistributedTrainStep runs
IMPLEMENTED_TOGGLES = ("amp", "recompute", "gradient_merge", "sharding",
                       "dgc", "pipeline", "tensor_parallel",
                       "sequence_parallel")
# toggles the step accepts and warns about: they change nothing here
NOOP_TOGGLES = ("fp16_allreduce",)

# config keys accepted for the reference's sake that change nothing
_INERT = {
    "amp_configs": ("use_fp16_guard",),
    "sharding_configs": ("fuse_broadcast_MB",),
    "a_sync_configs": ("max_merge_var_num", "independent_recv_thread",
                       "min_send_grad_num_before_recv", "thread_pool_size",
                       "send_wait_times", "runtime_split_send_recv"),
}

_BOOL_TOGGLES = [
    "amp", "recompute", "sharding", "pipeline", "tensor_parallel",
    "sequence_parallel", "gradient_merge", "localsgd", "adaptive_localsgd",
    "lamb", "lars", "dgc", "fp16_allreduce", "a_sync", "auto",
    "cudnn_exhaustive_search", "sync_nccl_allreduce", "fuse_all_reduce_ops",
    "find_unused_parameters", "without_graph_optimization",
]

_DEFAULT_CONFIGS = {
    # names follow the reference (its distributed_strategy.proto)
    "amp_configs": dict(
        init_loss_scaling=32768.0, incr_every_n_steps=1000,
        decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
        use_dynamic_loss_scaling=True, use_pure_fp16=False,
        use_fp16_guard=True, custom_white_list=[], custom_black_list=[],
        dtype="bfloat16"),
    "recompute_configs": dict(checkpoints=[]),
    "sharding_configs": dict(sharding_degree=1, stage=1,
                             fuse_broadcast_MB=32.0, hybrid_dp=False,
                             offload=False, moment_dtype="float32"),
    "pipeline_configs": dict(micro_batch_size=1, accumulate_steps=1,
                             schedule_mode="1F1B"),
    "tensor_parallel_configs": dict(tensor_parallel_degree=1,
                                    tensor_parallel_seed=0),
    "sequence_parallel_configs": dict(sequence_parallel_degree=1,
                                      mode="ring"),
    "gradient_merge_configs": dict(k_steps=1, avg=True),
    "localsgd_configs": dict(k_steps=1, begin_step=1),
    "dgc_configs": dict(rampup_begin_step=0, rampup_step=1,
                        sparsity=[0.999], momentum=0.9),
    "lamb_configs": dict(lamb_weight_decay=0.01, exclude_from_weight_decay=[]),
    "lars_configs": dict(lars_coeff=0.001, lars_weight_decay=0.0005,
                         epsilon=0.0, exclude_from_weight_decay=[]),
    # the parameter-server modes (``PSRuntime.init_worker``: sync, async
    # or geo) and worker liveness
    "a_sync_configs": dict(k_steps=-1, max_merge_var_num=1,
                           send_queue_size=16, independent_recv_thread=False,
                           min_send_grad_num_before_recv=1, thread_pool_size=1,
                           send_wait_times=1, runtime_split_send_recv=False,
                           launch_barrier=True, geo_sgd_mode=False,
                           geo_sgd_need_push_nums=100,
                           heartbeat_timeout=10.0, on_dead="evict"),
    "hybrid_configs": dict(dp_degree=-1, mp_degree=1, pp_degree=1,
                           sharding_degree=1, sep_degree=1),
}


class DistributedStrategy:
    def __init__(self):
        self._flags = {k: False for k in _BOOL_TOGGLES}
        self._configs = copy.deepcopy(_DEFAULT_CONFIGS)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self.__dict__.get("_flags", {}):
            return self._flags[name]
        if name in self.__dict__.get("_configs", {}):
            return self._configs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        elif name in self._flags:
            self._flags[name] = bool(value)
        elif name in self._configs:
            cfg = self._configs[name]
            unknown = set(value) - set(cfg)
            if unknown:
                raise ValueError(f"unknown keys {sorted(unknown)} in {name}; "
                                 f"valid: {sorted(cfg)}")
            cfg.update(value)
        else:
            object.__setattr__(self, name, value)

    def enabled(self):
        """Names of the toggles that are on."""
        return [k for k, v in self._flags.items() if v]

    def mesh_degrees(self):
        """Mesh axis sizes the strategy asks for (unset axes 1; dp -1
        absorbs the remainder), as the reference derives them."""
        h = self._configs["hybrid_configs"]
        fsdp = max(self._configs["sharding_configs"]["sharding_degree"],
                   h.get("sharding_degree", 1)) if self.sharding else \
            h.get("sharding_degree", 1)
        tp = max(self._configs["tensor_parallel_configs"]
                 ["tensor_parallel_degree"], h.get("mp_degree", 1)) \
            if self.tensor_parallel else h.get("mp_degree", 1)
        sp = self._configs["sequence_parallel_configs"][
            "sequence_parallel_degree"] if self.sequence_parallel else \
            h.get("sep_degree", 1)
        return {"dp": h.get("dp_degree", -1), "fsdp": max(1, fsdp),
                "tp": max(1, tp), "pp": max(1, h.get("pp_degree", 1)),
                "sp": max(1, sp)}

    def __repr__(self):
        return f"DistributedStrategy(on={self.enabled()})"


def warn_noop_toggles(strategy):
    """Warn once a strategy about accepted toggles and config keys (set
    away from their defaults) that have no effect in the port."""
    if getattr(strategy, "_warned_noop", False):
        return
    object.__setattr__(strategy, "_warned_noop", True)
    import warnings
    if strategy.fp16_allreduce:
        warnings.warn(
            "strategy.fp16_allreduce is a no-op: the gradients already "
            "cross the ranks in the dtype the step computes them in",
            UserWarning)
    for cfg_name, keys in _INERT.items():
        live = strategy._configs.get(cfg_name, {})
        for key in keys:
            if live.get(key) != _DEFAULT_CONFIGS[cfg_name][key]:
                warnings.warn(
                    f"strategy.{cfg_name}[{key!r}]={live.get(key)!r} is "
                    "accepted for the reference's sake and has no effect",
                    UserWarning)
