"""Deep Gradient Compression (counterpart of
``paddle_tpu/distributed/fleet/dgc.py``): top-k sparsified gradient
exchange with momentum correction and error feedback, as the reference
wires the paper (Lin et al. 2018)::

  u_t = m * u_{t-1} + g_t              (momentum corrected before the
  v_t = v_{t-1} + u_t                   sparsification)
  mask = |v_t| in top-k                (k = max(1, round(n (1 - sparsity))))
  exchanged = allreduce(v_t * mask)    (the masked dense tensor)
  u_t, v_t *= (1 - mask)               (error feedback: the residual stays)

``torch.topk`` picks the k entries (ties are not part of the contract).
``rampup_sparsity`` / ``rampup_stage_index`` are the warm-up ramp: no
compression before ``rampup_begin_step``, then the sparsity list stepped
through over ``rampup_step`` steps.  The train step
(:class:`~.dist_step.DistributedTrainStep`) runs these on each rank's own
gradient and all-reduces the masked tensors over the data axes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

__all__ = ["dgc_init", "dgc_compress", "dgc_one", "rampup_sparsity",
           "rampup_stage_index", "topk_count"]


def rampup_stage_index(step, rampup_begin_step, rampup_step, n_stage):
    """Index into the sparsity list for ``step`` (the caller clamps it to
    ``[0, n_stage - 1]``)."""
    return ((step - rampup_begin_step) * n_stage) // max(int(rampup_step), 1)


def dgc_init(params: Dict[str, Any]) -> Dict[str, Any]:
    """Zero ``(u, v)`` accumulators a parameter."""
    return {"u": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}


def rampup_sparsity(step: int, rampup_begin_step: int = 0,
                    rampup_step: int = 1,
                    sparsity: Sequence[float] = (0.999,)) -> float:
    """The sparsity of ``step``: 0 before ``rampup_begin_step``, then the
    list stepped through, then its last value."""
    step = int(step)
    if step < rampup_begin_step:
        return 0.0
    idx = rampup_stage_index(step, rampup_begin_step, rampup_step,
                             len(sparsity))
    return float(sparsity[min(max(idx, 0), len(sparsity) - 1)])


def topk_count(n: int, sparsity: float) -> int:
    """The entries a tensor of ``n`` sends at ``sparsity``."""
    return max(1, int(round(n * (1.0 - sparsity))))


def _topk_mask(flat, k):
    idx = torch.topk(flat.abs(), k, sorted=False).indices
    return torch.zeros_like(flat).index_fill_(0, idx, 1.0)


def dgc_one(u, v, g, momentum: float, sparsity: float):
    """One tensor's step: ``(new_u, new_v, sent, mask)``, ``sent`` the
    masked accumulation before any all-reduce, ``mask`` the f32 top-k
    mask."""
    u = momentum * u + g
    v = v + u
    flat = v.reshape(-1)
    n = flat.shape[0]
    k = topk_count(n, sparsity)
    mask = torch.ones_like(flat) if k >= n else _topk_mask(flat, k)
    sent = (flat * mask).reshape(v.shape)
    keep = (flat * (1.0 - mask)).reshape(v.shape)
    new_u = (u.reshape(-1) * (1.0 - mask)).reshape(u.shape)
    return new_u, keep, sent, mask.reshape(v.shape)


def dgc_compress(state: Dict[str, Any], grads: Dict[str, Any],
                 momentum: float = 0.9, sparsity: float = 0.999,
                 allreduce_fn: Optional[Callable] = None):
    """One DGC step over ``{name: gradient}``: ``(new_state, exchanged)``,
    the exchanged tensors carrying the top-k accumulated values (passed
    through ``allreduce_fn`` when given), the rest left in the residual."""
    new_u, new_v, out = {}, {}, {}
    for name, g in grads.items():
        new_u[name], new_v[name], sent, _ = dgc_one(
            state["u"][name], state["v"][name], g, momentum, sparsity)
        out[name] = allreduce_fn(sent) if allreduce_fn is not None else sent
    return {"u": new_u, "v": new_v}, out
