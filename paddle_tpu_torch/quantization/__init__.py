"""Executed int8 inference: int8-stored weights run through the
``int8_matmul`` kernel.

Counterpart of the executed-int8 part of ``paddle_tpu/quantization``
(``Int8InferenceLinear``, ``Int8InferenceConv2D``,
``convert_to_int8_inference``).  Weights are quantised per output channel
(abs-max / 127, round half to even, clipped to [-127, 127]) into an int8
``qweight`` and an f32 ``w_scale``, under the reference's names and
layouts, so the state dicts match.

``act_quant="dynamic"`` (the default) quantises the activation per call
with one abs-max scale over the whole tensor and runs the integer product
on the int8 tensor cores: exact integer sums rescaled by ``x_scale *
w_scale``.  ``act_quant=None`` keeps float activations (weight-only).

The convolution's dynamic path (``groups == 1``) feeds the kernel with
patch rows of the int8 codes.  The reference extracts patches in (C, kh,
kw) order from NCHW; here they are gathered from NHWC codes in (kh, kw,
C) order, with the weight flattened in the same order once at
conversion.  An integer sum does not depend on its order, so the result
is bitwise the reference's, while a 1x1 stride-1 convolution of a
channels-last activation needs no gather at all and the others gather
one byte per element.  The output comes back NHWC; for NCHW it is
returned as a channels-last NCHW view, which the layers that follow keep.

Each int8 layer routes its kernel by ``kernel_mode`` (``None``: by the
tensor's device, as everywhere in the port; ``"torch_ref"``: the plain
version, to compare against; ``set_kernel_mode``, from the kernel
registry, routes a whole model).

Fake-quant, QAT and PTQ are not ported (see ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF
from torch import nn

from ..framework.dtype import to_torch
from ..nn.functional import conv as Fconv
from ..nn.layer import Conv2D, Linear
from ..ops.kernels.int8_matmul import aligned_rows, int8_matmul, kernel_rows
from ..ops.kernels.registry import set_kernel_mode

__all__ = ["Int8InferenceLinear", "Int8InferenceConv2D",
           "convert_to_int8_inference", "set_kernel_mode"]


def _compute_dtype(compute_dtype) -> torch.dtype:
    try:
        dt = to_torch(compute_dtype)
    except ValueError:
        dt = None
    if dt is None or not dt.is_floating_point:
        raise TypeError(
            f"compute_dtype must be a floating dtype, got {compute_dtype!r} "
            "(an int compute dtype would silently truncate the rescaled "
            "accumulator)")
    return dt


def _quantize_act(x):
    """Per-tensor abs-max codes (f32, integer-valued) and their f32 scale,
    as the reference computes them."""
    xf = x.float()
    xs = torch.clamp_min(xf.abs().amax(), 1e-9) / 127.0
    return torch.div(xf, xs).round_().clamp_(-127, 127), xs


class _Int8Layer(nn.Module):
    """Weights quantised per output channel along ``reduce_dims``, and the
    kernel's K-major copy of them, rebuilt whenever ``qweight`` changes
    (a load of a state dict, a move to another device)."""

    def __init__(self, w, reduce_dims, bias, compute_dtype, act_quant):
        super().__init__()
        if act_quant not in ("dynamic", None):
            raise ValueError(
                f"act_quant must be 'dynamic' or None, got {act_quant!r}"
                " (a typo here silently selects the 2x-slower "
                "weight-only mode)")
        w = w.detach()
        scale = torch.clamp_min(w.abs().amax(dim=reduce_dims) / 127.0, 1e-9)
        shape = [-1 if i not in reduce_dims else 1 for i in range(w.dim())]
        qw = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127
                         ).to(torch.int8)
        self.register_buffer("qweight", qw)
        self.register_buffer("w_scale", scale.float())
        self.register_buffer("bias", None if bias is None
                             else bias.detach().clone())
        self.register_buffer("_w_rows", None, persistent=False)
        self._w_src = None
        self._cdt = compute_dtype
        self._act_quant = act_quant
        self.kernel_mode = None

    def _rows_from_qweight(self) -> torch.Tensor:
        raise NotImplementedError

    def weight_rows(self) -> torch.Tensor:
        """The kernel's [N, K] int8 weight (K contiguous, rows on 16
        bytes, zero from K to the next multiple of 16), derived from
        ``qweight`` once (a view of it where it already has that layout,
        as a 1x1 convolution's has)."""
        src = (self.qweight.data_ptr(), self.qweight._version)
        if self._w_rows is None or self._w_src != src:
            self._w_rows = kernel_rows(self._rows_from_qweight())
            self._w_src = src
        return self._w_rows


class Int8InferenceLinear(_Int8Layer):
    """Linear with int8 ``qweight`` [in, out] and f32 ``w_scale`` [out]
    (see the module docstring); ``bias`` is kept as a buffer."""

    def __init__(self, layer: Linear, compute_dtype=torch.bfloat16,
                 act_quant="dynamic"):
        super().__init__(layer.weight, (0,), layer.bias,
                         _compute_dtype(compute_dtype), act_quant)

    def _rows_from_qweight(self):
        return self.qweight.t()

    def forward(self, x):
        if self._act_quant == "dynamic":
            xq, xs = _quantize_act(x)
            y = int8_matmul(xq.to(torch.int8), self.weight_rows(),
                            self.w_scale, x_scale=xs,
                            compute_dtype=self._cdt, mode=self.kernel_mode)
        else:
            y = int8_matmul(x, self.weight_rows(), self.w_scale,
                            compute_dtype=self._cdt, mode=self.kernel_mode)
        if self.bias is not None:
            y = y + self.bias.to(self._cdt)
        return y


class Int8InferenceConv2D(_Int8Layer):
    """Conv2D with int8 ``qweight`` (OIHW) and f32 ``w_scale`` [out] (see
    the module docstring).  ``groups > 1`` runs the dynamic path as an
    exact f64 convolution of the codes (the reference ran it in XLA, not
    in its kernel); ``act_quant=None`` dequantises and convolves."""

    def __init__(self, layer: Conv2D, compute_dtype=torch.bfloat16,
                 act_quant="dynamic"):
        if not hasattr(layer, "weight") or not hasattr(layer, "_stride"):
            raise TypeError(
                f"Int8InferenceConv2D wraps a Conv2D layer, got "
                f"{type(layer).__name__!r}")
        cdt = _compute_dtype(compute_dtype)
        if layer.weight.dim() != 4:
            raise ValueError(f"expected OIHW conv weights, got shape "
                             f"{tuple(layer.weight.shape)}")
        if int(layer._groups) < 1:
            raise ValueError(f"groups must be >= 1, got {layer._groups}")
        if layer._data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{layer._data_format!r}")
        super().__init__(layer.weight, (1, 2, 3), layer.bias, cdt,
                         act_quant)
        self._inner_cfg = (layer._stride, layer._padding, layer._dilation,
                           layer._groups, layer._data_format)

    def _rows_from_qweight(self):
        # OIHW flattened over (kh, kw, I): the order of the patch rows
        return self.qweight.permute(0, 2, 3, 1).reshape(
            self.qweight.shape[0], -1)

    def forward(self, x):
        st, pad, dil, grp, fmt = self._inner_cfg
        if self._act_quant is None:
            cdt = self._cdt
            w = self.qweight.to(cdt) * self.w_scale.to(cdt)[:, None, None,
                                                            None]
            return Fconv.conv2d(x.to(cdt), w, self.bias, st, pad, dil, grp,
                                fmt)
        stride, dilation, pads = Fconv.conv_geometry(
            x.shape, self.qweight.shape, st, pad, dil, fmt)
        xq, xs = _quantize_act(x)
        if grp == 1:
            y = self._fused(xq.to(torch.int8), xs, stride, dilation, pads,
                            fmt)
        else:
            y = self._grouped(xq, xs, stride, dilation, pads, grp, fmt)
        if self.bias is not None:
            chan = (1, 1, 1, -1) if fmt == "NHWC" else (1, -1, 1, 1)
            y = y + self.bias.to(self._cdt).reshape(chan)
        return y

    def _fused(self, xq, xs, stride, dilation, pads, fmt):
        n_out, _, kh, kw = self.qweight.shape
        xn = xq if fmt == "NHWC" else xq.permute(0, 2, 3, 1)
        (pt, pb), (pl, pr) = pads
        if pt or pb or pl or pr:
            xn = tF.pad(xn, (0, 0, pl, pr, pt, pb))
        B, H, W, C = xn.shape
        ho = (H - (kh - 1) * dilation[0] - 1) // stride[0] + 1
        wo = (W - (kw - 1) * dilation[1] - 1) // stride[1] + 1
        sb, sh, sw, sc = xn.stride()
        patches = xn.as_strided(
            (B, ho, wo, kh, kw, C),
            (sb, sh * stride[0], sw * stride[1], sh * dilation[0],
             sw * dilation[1], sc), xn.storage_offset())
        m, k = B * ho * wo, kh * kw * C
        if patches.is_contiguous():          # 1x1, stride 1, channels last
            rows = patches.view(m, k)
        else:
            rows = aligned_rows(m, k, xq.device)
            rows.view(B, ho, wo, kh, kw, C).copy_(patches)
        # the kernel rounds f32(acc) * scale to the compute dtype: the
        # reference's f32 product cast to it, bit for bit
        y = int8_matmul(rows, self.weight_rows(), self.w_scale, x_scale=xs,
                        compute_dtype=self._cdt, mode=self.kernel_mode)
        y = y.view(B, ho, wo, n_out)
        return y if fmt == "NHWC" else y.permute(0, 3, 1, 2)

    def _grouped(self, xq, xs, stride, dilation, pads, grp, fmt):
        xc = xq.permute(0, 3, 1, 2) if fmt == "NHWC" else xq
        (pt, pb), (pl, pr) = pads
        acc = tF.conv2d(tF.pad(xc.double(), (pl, pr, pt, pb)),
                        self.qweight.double(), None, stride, 0, dilation,
                        grp).to(torch.int32)
        y = (acc.float() * (xs * self.w_scale).reshape(1, -1, 1, 1)
             ).to(self._cdt)
        return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


def convert_to_int8_inference(model: nn.Module, compute_dtype=torch.bfloat16,
                              act_quant="dynamic") -> nn.Module:
    """Swap every ``Linear`` and ``Conv2D`` of ``model`` (and nothing else:
    the parallel linear layers stay, as in the reference) for executed
    int8 layers, in place; returns the model in eval mode."""
    for name, sub in list(model.named_children()):
        if isinstance(sub, Linear):
            setattr(model, name,
                    Int8InferenceLinear(sub, compute_dtype, act_quant))
        elif isinstance(sub, Conv2D):
            setattr(model, name,
                    Int8InferenceConv2D(sub, compute_dtype, act_quant))
        else:
            convert_to_int8_inference(sub, compute_dtype, act_quant)
    return model.eval()
