"""linear / embedding / silu / relu / flatten / batch_norm / layer_norm /
dropout with the reference's dtype behaviour.

``linear`` promotes like ``jnp.matmul`` (see :func:`..framework.dtype.
promote`): a bf16 activation times an f32 weight computes and returns
f32, which is what the JAX model's residual stream relies on.

``batch_norm`` in training is the reference's ``_norm_train``
(``paddle_tpu/nn/functional/common.py:287-410``): f32 two-pass moments
and a closed-form backward.  The reference left it to XLA with no Pallas
kernel, so plain PyTorch is the port.

``layer_norm`` is the reference's closed form (``common.py:413-439``):
f32 moments whatever the input dtype, the scale and shift in f32, one
cast back to the input's dtype.  The reference routes the scale and shift
through a custom vjp (``_scale_shift``) only to steer XLA's fusion; plain
autograd of the same expression gives the same gradients.

``dropout`` draws its keep mask from an explicit ``torch.Generator`` on
the tensor's device, never from torch's global generator, and divides
the kept values by ``1 - p`` (a 0-dim tensor on the data's device: a
Python scalar would make PyTorch's CUDA division multiply by the
reciprocal).  The masks have no bit parity with ``jax.random``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...amp import maybe_cast_inputs
from ...framework.dtype import promote

__all__ = ["linear", "embedding", "silu", "relu", "flatten", "batch_norm",
           "BatchNormTrain", "layer_norm", "dropout"]


def linear(x, weight, bias=None):
    """y = x @ W + b with W stored [in, out]; under ``amp.auto_cast`` the
    f32 operands in the autocast dtype first."""
    x, weight = maybe_cast_inputs("linear", x, weight)
    dt = promote(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def embedding(ids, weight, padding_idx=None, sparse=False):
    """Row gather ``weight[ids]``; rows of ``padding_idx`` come out zero
    (and so pass no gradient), as the reference's dense path.  The gather
    is ``torch.nn.functional.embedding``, whose backward sums each row's
    duplicates in parallel segments: the backward of an indexing
    ``weight[ids]`` walks a row's duplicates one after another, which on
    the card took 14.1 ms of a BERT-base step for its three embeddings
    (the token-type table has two rows for 16,384 ids; PERF.md section
    6)."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True), the eager SelectedRows gradient, is "
            "not ported yet (ROADMAP queue item 4); use the dense path")
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    out = tF.embedding(ids, weight)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the trailing ``normalized_shape`` dims: f32 mean and
    biased variance, ``(x - m) * rsqrt(var + eps)``, then ``* weight +
    bias`` in f32, cast back to ``x``'s dtype (the module docstring)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    with torch.profiler.record_function("layer_norm"):
        vf = x.float()
        d = vf - torch.mean(vf, dim=dims, keepdim=True)
        out = d * torch.rsqrt(torch.mean(d * d, dim=dims, keepdim=True)
                              + epsilon)
        if weight is not None:
            out = out * weight.float() + bias.float()
        return out.to(x.dtype)


_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """The reference's ``dropout``: in training, keep each element (or, with
    ``axis``, each slice along those axes) with probability ``1 - p``;
    ``upscale_in_train`` divides the kept values by ``1 - p``,
    ``downscale_in_infer`` keeps them as they are.  ``training=False`` or
    ``p == 0`` returns ``x`` itself, in either mode (as the reference).
    ``generator`` (a ``torch.Generator`` on ``x``'s device) draws the
    mask and is required whenever one is drawn."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f"dropout mode must be one of {_DROPOUT_MODES}, "
                         f"got {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout p must be in [0, 1], got {p}")
    if not training or p == 0:
        return x
    if generator is None:
        raise ValueError("dropout draws its mask from an explicit "
                         "torch.Generator on the tensor's device; pass "
                         "generator=")
    if axis is None:
        shape = x.shape
    else:
        axes = {a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])}
        shape = tuple(n if i in axes else 1 for i, n in enumerate(x.shape))
    with torch.profiler.record_function("dropout"):
        keep = torch.rand(shape, generator=generator,
                          device=x.device) < 1.0 - p
        if mode == "upscale_in_train":
            x = x / torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


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
