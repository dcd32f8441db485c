"""linear / embedding / silu / relu / flatten / batch_norm with the
reference's dtype behaviour.

``linear`` promotes like ``jnp.matmul`` (see :func:`..framework.dtype.
promote`): a bf16 activation times an f32 weight computes and returns
f32, which is what the JAX model's residual stream relies on.

``batch_norm`` in training is the reference's ``_norm_train``
(``paddle_tpu/nn/functional/common.py:287-410``): f32 two-pass moments
and a closed-form backward.  The reference left it to XLA with no Pallas
kernel, so plain PyTorch is the port.
"""
from __future__ import annotations

import math

import torch

from ...framework.dtype import promote

__all__ = ["linear", "embedding", "silu", "relu", "flatten", "batch_norm",
           "BatchNormTrain"]


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


def _keep(t, ndim, red_axes):
    """``t`` over the kept axes, reshaped to broadcast against an
    ``ndim`` tensor reduced over ``red_axes``."""
    shape = [1] * ndim
    it = iter(t.shape)
    for i in range(ndim):
        if i not in red_axes:
            shape[i] = next(it)
    return t.reshape(shape)


def _moments(vf, red_axes):
    """f32 two-pass moments: the mean first, then E[(x - m)^2].  The
    one-pass E[x^2] - m^2 form cancels in f32 for un-centred inputs: at a
    mean of 1e3 the rounding of E[x^2] alone is ~6 % of a unit
    variance.  Returns (mean, biased variance, count)."""
    n = math.prod(vf.shape[a] for a in red_axes)
    m = torch.sum(vf, dim=red_axes) / n
    d = vf - _keep(m, vf.dim(), red_axes)
    var = torch.sum(d * d, dim=red_axes) / n
    return m, var, n


class BatchNormTrain(torch.autograd.Function):
    """Normalise over ``red_axes`` with the batch statistics: returns
    (out in ``v``'s dtype, f32 batch mean, f32 biased variance).

    Saves only ``(v, w, m, rstd)``: the backward recomputes x-hat from
    ``v``, so no f32 copy of the activation outlives the forward.  The
    backward is the closed form of the reference's ``_norm_train_bwd``,
    including the cotangents of the returned mean and variance; ``dw``
    and ``db`` come back in the weight's dtype."""

    @staticmethod
    def forward(ctx, v, w, b, red_axes, eps):
        vf = v.float()
        m, var, n = _moments(vf, red_axes)
        rstd = torch.rsqrt(var + eps)
        out = (vf - _keep(m, v.dim(), red_axes)) * _keep(rstd, v.dim(),
                                                          red_axes)
        if w is not None:
            out = (out * _keep(w.float(), v.dim(), red_axes)
                   + _keep(b.float(), v.dim(), red_axes))
        ctx.save_for_backward(v, w, m, rstd)
        ctx.red_axes, ctx.n = red_axes, n
        ctx.set_materialize_grads(False)
        return out.to(v.dtype), m, var

    @staticmethod
    def backward(ctx, g, gm, gvar):
        v, w, m, rstd = ctx.saved_tensors
        red, n, nd = ctx.red_axes, ctx.n, v.dim()
        vf = v.float()
        mk, rk = _keep(m, nd, red), _keep(rstd, nd, red)
        xhat = (vf - mk) * rk
        dx = dw = db = None
        if g is not None:
            gf = g.float()
            if w is not None:
                gy = gf * _keep(w.float(), nd, red)
                dw = torch.sum(gf * xhat, dim=red).to(w.dtype)
                db = torch.sum(gf, dim=red).to(w.dtype)
            else:
                gy = gf
            sum_gy = torch.sum(gy, dim=red)
            sum_gy_xhat = torch.sum(gy * xhat, dim=red)
            dx = (rk / n) * (n * gy - _keep(sum_gy, nd, red)
                             - xhat * _keep(sum_gy_xhat, nd, red))
        else:
            dx = torch.zeros_like(vf)
        # the cotangent paths through the returned batch statistics
        if gm is not None:
            dx = dx + _keep(gm, nd, red) / n
        if gvar is not None:
            dx = dx + _keep(gvar, nd, red) * 2.0 * (vf - mk) / n
        return dx.to(v.dtype), dw, db, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm as the reference's ``batch_norm``.

    Training (``training`` and not ``use_global_stats``) normalises with
    the batch statistics through :class:`BatchNormTrain` and then
    updates the running statistics in place, outside autograd:
    ``momentum * running + (1 - momentum) * batch`` with the biased
    variance.  Otherwise it applies the running statistics as the
    reference's ``(v - m) * rsqrt(var + eps) * w + b`` in that order;
    mixed dtypes promote as ``jnp`` does."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC", "NC")
    nd = x.dim()
    ch_axis = nd - 1 if channel_last and nd > 2 else 1
    if training and not use_global_stats:
        red_axes = tuple(i for i in range(nd) if i != ch_axis)
        with torch.profiler.record_function("batch_norm"):
            out, mean, var = BatchNormTrain.apply(x, weight, bias, red_axes,
                                                  epsilon)
            if running_mean is not None:
                with torch.no_grad():
                    running_mean.copy_(momentum * running_mean
                                       + (1 - momentum) * mean)
                    running_var.copy_(momentum * running_var
                                      + (1 - momentum) * var)
        return out
    shape = [1] * nd
    shape[ch_axis] = x.shape[ch_axis]
    out = (x - running_mean.reshape(shape)) * torch.rsqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
        out = out + bias.reshape(shape)
    return out
