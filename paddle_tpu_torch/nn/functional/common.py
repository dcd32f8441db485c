"""linear / embedding / silu / relu / flatten / batch_norm with the
reference's dtype behaviour.

``linear`` promotes like ``jnp.matmul`` (see :func:`..framework.dtype.
promote`): a bf16 activation times an f32 weight computes and returns
f32, which is what the JAX model's residual stream relies on.
"""
from __future__ import annotations

import torch

from ...framework.dtype import promote

__all__ = ["linear", "embedding", "silu", "relu", "flatten", "batch_norm"]


def linear(x, weight, bias=None):
    """y = x @ W + b with W stored [in, out]."""
    dt = promote(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def embedding(ids, weight):
    """Row gather ``weight[ids]``."""
    return weight[ids.long()]


def silu(x):
    """x * sigmoid(x) in the input dtype (as ``jax.nn.silu``)."""
    return x * torch.sigmoid(x)


def relu(x):
    """max(x, 0) in the input dtype (as ``jax.nn.relu``)."""
    return torch.relu(x)


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Inference batch norm with the running statistics, as the
    reference's ``(v - m) * rsqrt(var + eps) * w + b`` in that order;
    mixed dtypes promote as ``jnp`` does.  Training (batch statistics and
    the running-stat update) is not ported."""
    if training and not use_global_stats:
        raise NotImplementedError(
            "batch_norm with batch statistics (training) is not ported: "
            "see ROADMAP.md, ResNet training; call .eval() for inference")
    channel_last = data_format in ("NHWC", "NLC", "NDHWC", "NC")
    nd = x.dim()
    shape = [1] * nd
    ch_axis = nd - 1 if channel_last and nd > 2 else 1
    shape[ch_axis] = x.shape[ch_axis]
    out = (x - running_mean.reshape(shape)) * torch.rsqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
        out = out + bias.reshape(shape)
    return out
