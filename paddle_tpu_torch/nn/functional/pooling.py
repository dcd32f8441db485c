"""2-D max pooling and adaptive average pooling.

Counterpart of ``paddle_tpu/nn/functional/pooling.py``
(``_resolve_padding``, ``max_pool2d``, ``adaptive_avg_pool2d``).  Max
pooling pads with -inf and then pools without padding, as the
reference's ``reduce_window`` does.  Adaptive average pooling reduces one
spatial axis after the other, as the reference does: a reshape-mean where
the input divides evenly, else the reference's bins ``[floor(i * in / o),
ceil((i + 1) * in / o))``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .conv import _pair

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def _resolve_padding(padding, n, kernel, stride, sizes, ceil_mode):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pads = []
        for i in range(n):
            out = -(-sizes[i] // stride[i])
            total = max(0, (out - 1) * stride[i] + kernel[i] - sizes[i])
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, (list, tuple)) and isinstance(padding[0],
                                                         (list, tuple)):
        pads = [tuple(pp) for pp in padding]
    else:
        pads = [(pp, pp) for pp in _pair(padding, n)]
    if ceil_mode:
        pads = [(lo, hi + stride[i] - 1) for i, (lo, hi) in enumerate(pads)]
    return pads


def _spatial_axes(data_format):
    return (1, 2) if data_format == "NHWC" else (2, 3)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    kernel = _pair(kernel_size, 2)
    stride = _pair(stride if stride is not None else kernel_size, 2)
    sizes = [x.shape[a] for a in _spatial_axes(data_format)]
    (pt, pb), (pl, pr) = _resolve_padding(padding, 2, kernel, stride, sizes,
                                          ceil_mode)
    xc = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    if pt or pb or pl or pr:
        xc = tF.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
    out = tF.max_pool2d(xc, kernel, stride)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    out_sizes = _pair(output_size, 2)
    out = x
    for ax, o in zip(_spatial_axes(data_format), out_sizes):
        in_sz = out.shape[ax]
        if in_sz % o == 0:
            shape = out.shape[:ax] + (o, in_sz // o) + out.shape[ax + 1:]
            out = out.reshape(shape).mean(dim=ax + 1)
        else:
            pieces = []
            for i in range(o):
                s, e = (i * in_sz) // o, ((i + 1) * in_sz + o - 1) // o
                pieces.append(out.narrow(ax, s, e - s).mean(dim=ax,
                                                            keepdim=True))
            out = torch.cat(pieces, dim=ax)
    return out
