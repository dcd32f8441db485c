"""DistributedStrategy: the subset of the reference's strategy config
(``distributed/fleet/strategy.py``) that the port runs.

Every toggle and config dict of the reference is accepted under its
name, so a strategy written for the reference builds here.  The port's
:class:`~.dist_step.DistributedTrainStep` runs ``amp`` (bf16 compute
over f32 master weights) and ``recompute``; it refuses every other
toggle that is on, and float16 AMP, with ``NotImplementedError``.
"""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy", "IMPLEMENTED_TOGGLES"]

# toggles the port's DistributedTrainStep runs
IMPLEMENTED_TOGGLES = ("amp", "recompute")

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
    "gradient_merge_configs": dict(k_steps=1, avg=True),
    "dgc_configs": dict(rampup_begin_step=0, rampup_step=1,
                        sparsity=[0.999], momentum=0.9),
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

    def __repr__(self):
        return f"DistributedStrategy(on={self.enabled()})"
