"""Distributed metric aggregation over the worker world (a copy of
``paddle_tpu/distributed/fleet/metrics.py``).

Each worker holds local statistic arrays; these helpers all-reduce them
through the fleet util (``UtilBase``: PS-backed accumulator tables) and
compute the global metric.  ``auc`` consumes the positive/negative
threshold-bucket statistics the Auc metric maintains.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]

_py_sum, _py_max, _py_min = sum, max, min


def _util(util):
    if util is None:
        from .fleet_base import _fleet  # the module singleton
        util = _fleet.util
    return util


def _to_np(v):
    if hasattr(v, "numpy"):
        v = v.numpy()
    return np.asarray(v, np.float32)


def sum(input, scope=None, util=None):  # noqa: A001
    """Global element-wise sum of a local statistic array."""
    return _util(util).all_reduce(_to_np(input), mode="sum")


def max(input, scope=None, util=None):  # noqa: A001
    return _util(util).all_reduce(_to_np(input), mode="max")


def min(input, scope=None, util=None):  # noqa: A001
    return _util(util).all_reduce(_to_np(input), mode="min")


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from per-worker positive/negative bucket counts
    (reference metric.py:142: sum the buckets, then the trapezoid walk
    over thresholds)."""
    u = _util(util)
    pos = u.all_reduce(_to_np(stat_pos), mode="sum").reshape(-1)
    neg = u.all_reduce(_to_np(stat_neg), mode="sum").reshape(-1)
    # walk buckets from the highest score down accumulating tp/fp
    tp = fp = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp = tp + pos[i]
        new_fp = fp + neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    if tp == 0 or fp == 0:
        return 0.0
    return float(area / (tp * fp))


def mae(abserr, total_ins_num, scope=None, util=None):
    u = _util(util)
    e = float(u.all_reduce(_to_np(abserr), mode="sum").sum())
    n = float(u.all_reduce(_to_np(total_ins_num), mode="sum").sum())
    return e / _py_max(n, 1.0)


def mse(sqrerr, total_ins_num, scope=None, util=None):
    u = _util(util)
    e = float(u.all_reduce(_to_np(sqrerr), mode="sum").sum())
    n = float(u.all_reduce(_to_np(total_ins_num), mode="sum").sum())
    return e / _py_max(n, 1.0)


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num, scope, util)))


def acc(correct, total, scope=None, util=None):
    u = _util(util)
    c = float(u.all_reduce(_to_np(correct), mode="sum").sum())
    t = float(u.all_reduce(_to_np(total), mode="sum").sum())
    return c / _py_max(t, 1.0)
