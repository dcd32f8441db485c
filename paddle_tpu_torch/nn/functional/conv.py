"""2-D convolution with Paddle's padding spec.

Counterpart of ``paddle_tpu/nn/functional/conv.py`` (``_pair``,
``_padding``, ``conv2d``).  A float convolution ran in XLA outside any
Pallas kernel in the reference, so here it is
``torch.nn.functional.conv2d`` (cuDNN on the card), with asymmetric pads
applied by ``F.pad`` first.  Weights are OIHW whatever ``data_format``
is; an NHWC input is handed to PyTorch as a channels-last NCHW view (no
copy).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ...amp import maybe_cast_inputs
from ...framework.dtype import promote

__all__ = ["conv2d"]


def _pair(v, n):
    if isinstance(v, (list, tuple)):
        vv = list(v)
        if len(vv) == 1:
            vv = vv * n
        return tuple(int(i) for i in vv)
    return (int(v),) * n


def _padding(padding, n, stride, kernel, dilation, in_sizes,
             channel_last=False):
    """Resolve a Paddle padding spec to a list of n (lo, hi) pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            pads = []
            for i in range(n):
                eff_k = (kernel[i] - 1) * dilation[i] + 1
                out = -(-in_sizes[i] // stride[i])
                total = max(0, (out - 1) * stride[i] + eff_k - in_sizes[i])
                pads.append((total // 2, total - total // 2))
            return pads
        raise ValueError(f"bad padding {padding}")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        # n spatial pairs, or n + 2 pairs in data-format order
        pairs = [tuple(int(v) for v in p) for p in padding]
        if len(pairs) == n:
            return pairs
        if len(pairs) == n + 2:
            return pairs[1:-1] if channel_last else pairs[2:]
        raise ValueError(f"bad padding {padding}")
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def conv_geometry(x_shape, w_shape, stride, padding, dilation, data_format):
    """(stride, dilation, [(top, bottom), (left, right)]) of a 2-D conv of
    an input of ``x_shape`` with OIHW weights of ``w_shape``."""
    stride, dilation = _pair(stride, 2), _pair(dilation, 2)
    channel_last = data_format == "NHWC"
    in_sizes = x_shape[1:3] if channel_last else x_shape[2:4]
    pads = _padding(padding, 2, stride, w_shape[2:4], dilation, in_sizes,
                    channel_last)
    return stride, dilation, pads


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``x`` NCHW or NHWC, ``weight`` [O, I / groups, kh, kw]; the result in
    ``data_format``, in the promoted dtype of ``x`` and ``weight`` (under
    ``amp.auto_cast`` the f32 operands in the autocast dtype first)."""
    x, weight = maybe_cast_inputs("conv2d", x, weight)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    stride, dilation, ((pt, pb), (pl, pr)) = conv_geometry(
        x.shape, weight.shape, stride, padding, dilation, data_format)
    dt = promote(x.dtype, weight.dtype)
    xc = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    xc = xc.to(dt)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc, pad = tF.pad(xc, (pl, pr, pt, pb)), 0
    out = tF.conv2d(xc, weight.to(dt), None, stride, pad, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
