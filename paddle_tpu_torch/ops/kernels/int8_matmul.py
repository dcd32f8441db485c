"""Int8 matrix product with a per-column rescale: the Hopper kernel and its
plain version.

Counterpart of ``paddle_tpu/ops/pallas/int8_matmul.py`` (kernel 6,
``_int8_matmul_kernel``).  Two modes, as the reference's:

- **dynamic** (``x_scale`` given): ``x`` is int8 codes, the product is an
  int32 sum on the int8 tensor cores, and the epilogue applies
  ``f32(acc) * (x_scale * w_scale)[n]`` (the scale folded once here, in
  PyTorch, as the reference folds it) and stores the compute dtype.
  Integer sums do not depend on their order: the kernel is bitwise equal
  to its plain version.
- **weight-only** (``x_scale=None``): ``x`` is float; the int8 weight is
  dequantised as ``compute_dtype(q) * compute_dtype(w_scale)`` and the
  product summed in f32.  Held to the registered rtol (2e-2 at bf16,
  1e-5 at f32).

The weight operand is ``w_nk`` [N, K]: the transpose of the reference's
[K, N] ``qw``, K contiguous, which is the layout the tensor cores take
for B.  A conv's OIHW weight flattened over (kh, kw, I) is already that;
``Int8InferenceLinear`` keeps a K-major copy of its [K, N] ``qweight``.

The CUDA kernel (``csrc/int8_matmul.cu``) loads 16-byte chunks, so its
int8 operands need rows that start on 16 bytes; :func:`aligned_rows`
makes such a buffer, and the wrapper copies into one when a caller's
rows are not aligned.  Any M, N and K (the K tail is zero-filled in the
kernel); leading batch dims of ``x`` are collapsed to rows.

The plain version multiplies the int8 operands in f64 (exact: every
partial sum is an integer below 2^53) and casts to int32; f32 would not
be exact beyond K ~ 1040.  Weight-only uses the reference's expressions.
"""
from __future__ import annotations

import ctypes

import torch

from ...framework.dtype import to_torch
from . import _build, registry

__all__ = ["int8_matmul", "aligned_rows", "kernel_rows", "CARD_TOL"]

_SOURCE = "int8_matmul.cu"
# Weight-only mode on the card against the plain version, as (atol, rtol,
# row) in the form of flash_attention.CARD_TOL: the registered rtol, plus
# the same share of the row's RMS for outputs that cancel to near zero
# (the two sum K products in different orders).  Dynamic mode is held to
# torch.equal.
CARD_TOL = {torch.float32: (0.0, 1e-5, 1e-5),
            torch.bfloat16: (0.0, 2e-2, 2e-2)}


def aligned_rows(m: int, k: int, device) -> torch.Tensor:
    """An uninitialised [m, k] int8 view whose rows start on 16 bytes (row
    pitch k rounded up to 16), as the kernel loads them."""
    kp = -(-k // 16) * 16
    return torch.empty((m, kp), dtype=torch.int8, device=device)[:, :k]


def kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [m, k] itself when its rows start on 16 bytes with unit
    stride along k, else an int8 copy into :func:`aligned_rows`."""
    m, k = t.shape
    if (t.stride(-1) == 1 and t.stride(0) % 16 == 0 and t.stride(0) >= k
            and t.data_ptr() % 16 == 0):
        return t
    rows = aligned_rows(m, k, t.device)
    rows.copy_(t)
    return rows


def _int8_matmul_plain(x2, w_nk, scale, dynamic, cdt):
    if dynamic:
        acc = (x2.double() @ w_nk.double().t()).to(torch.int32)
        return (acc.float() * scale).to(cdt)
    w = w_nk.to(cdt) * scale.to(cdt)[:, None]
    return x2.to(cdt) @ w.t()


def _eligible(x2, w_nk, scale, dynamic, cdt):
    ts = (x2, w_nk, scale)
    if not all(t.is_cuda for t in ts):
        return "every tensor must be a CUDA tensor"
    if len({t.device for t in ts}) != 1:
        return "tensors on different devices"
    if cdt not in (torch.float32, torch.bfloat16):
        return f"compute dtype {cdt} (takes float32 or bfloat16)"
    if w_nk.dim() != 2 or w_nk.dtype != torch.int8:
        return f"weight {tuple(w_nk.shape)} {w_nk.dtype} (needs [N, K] int8)"
    if x2.dim() != 2 or x2.shape[1] != w_nk.shape[1]:
        return f"x {tuple(x2.shape)} against weight {tuple(w_nk.shape)}"
    if dynamic and x2.dtype != torch.int8:
        return f"dynamic mode takes int8 codes, got {x2.dtype}"
    if not dynamic and not x2.is_floating_point():
        return f"weight-only mode takes float x, got {x2.dtype}"
    if scale.dtype != torch.float32 or tuple(scale.shape) != (w_nk.shape[0],):
        return f"scale {tuple(scale.shape)} {scale.dtype} (needs [N] f32)"
    return None


def _int8_matmul_cuda(x2, w_nk, scale, dynamic, cdt):
    m, k = x2.shape
    n = w_nk.shape[0]
    out = torch.empty((m, n), dtype=cdt, device=x2.device)
    if m == 0:
        return out
    scale, w = scale.contiguous(), kernel_rows(w_nk)
    if dynamic:
        x2 = kernel_rows(x2)
        name, ldx = "int8_matmul_dynamic", x2.stride(0)
    else:
        x2 = x2.to(cdt)
        if x2.stride(-1) != 1 or (m > 1 and x2.stride(0) < k):
            x2 = x2.contiguous()
        # a one-row tensor's row stride is never used and may be anything
        name, ldx = "int8_matmul_weight_only", x2.stride(0) if m > 1 else k
    lib = _build.load(_SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = fn(x2.data_ptr(), ldx, w.data_ptr(), w.stride(0),
                scale.data_ptr(), out.data_ptr(), m, n, k,
                int(cdt == torch.bfloat16), stream)
    _build.check(lib, rc, f"{name} M={m} N={n} K={k} {cdt}")
    _SPEC.launches += 1
    return out


_SPEC = registry.register(
    "int8_matmul", _int8_matmul_cuda, _int8_matmul_plain,
    # copied from the reference's registration
    tolerance="dynamic (int8 activations): bit-exact vs xla_ref "
              "(int32 accumulation is order-free); weight-only: "
              "rtol 2e-2 @ bf16 compute / 1e-5 @ f32 (reduction "
              "blocking differs from XLA's matmul)",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
    replaces="paddle_tpu/ops/pallas/int8_matmul.py:62",
    doc="int8 x int8 -> int32 on the int8 tensor cores with the folded "
        "per-column rescale in the epilogue; weight-only dequantises in "
        "shared memory: no dequantised weight tensor is written",
)


def int8_matmul(x, w_nk, w_scale, x_scale=None, compute_dtype=None, *,
                mode=None):
    """``x`` [..., K] (int8 codes when ``x_scale`` is given, else float),
    ``w_nk`` [N, K] int8, ``w_scale`` [N] f32, ``x_scale`` a scalar (0-dim
    tensor or number) or None.  Returns [..., N] in ``compute_dtype``
    (default bfloat16).  See the module docstring."""
    cdt = torch.bfloat16 if compute_dtype is None else to_torch(compute_dtype)
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if x_scale is None:
        scale = w_scale.float()
    else:
        # folded once, as the reference's wrapper does: one f32 rounding
        scale = torch.as_tensor(x_scale, dtype=torch.float32,
                                device=w_scale.device) * w_scale.float()
    out = registry.dispatch("int8_matmul", x2, w_nk, scale,
                            x_scale is not None, cdt, mode=mode)
    return out.reshape(*x.shape[:-1], w_nk.shape[0])
