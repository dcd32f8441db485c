"""Dequantisation of int8 parameter-server rows: the Hopper kernel and its
plain version.

Counterpart of ``paddle_tpu/ops/pallas/pull_dequant.py`` (kernel 9,
``_pull_dequant_kernel``): ``f32(codes) * scales[:, None]``.  A device
cache on the ``q8`` wire ships int8 codes and one f32 scale per row from
the host table and rebuilds the rows on the card with it, so the
host-to-device copy carries a quarter of the f32 bytes.

The int8 -> f32 conversion is exact and each element is one f32 multiply
in both versions (the kernel uses ``__fmul_rn``, so no FMA can arise):
kernel, plain version and the host's numpy ``dequantize_rows_q8`` are
bitwise equal.  Any ``m`` and ``dim`` >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, registry

__all__ = ["pull_dequant", "pull_dequant_ref"]

_SOURCE = "pull_dequant.cu"


def pull_dequant_ref(codes: torch.Tensor, scales: torch.Tensor):
    """The plain version: the same arithmetic as the kernel."""
    return codes.to(torch.float32) * scales.to(torch.float32)[:, None]


def _eligible(codes, scales):
    if not (codes.is_cuda and scales.is_cuda):
        return "codes and scales must be CUDA tensors"
    if codes.device != scales.device:
        return f"codes on {codes.device}, scales on {scales.device}"
    if codes.dtype != torch.int8 or codes.dim() != 2:
        return f"codes {tuple(codes.shape)} {codes.dtype} (needs [m, dim] int8)"
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            codes.shape[0],):
        return (f"scales {tuple(scales.shape)} {scales.dtype} (needs "
                f"[{codes.shape[0]}] float32)")
    return None


def _pull_dequant_cuda(codes, scales):
    m, dim = codes.shape
    out = torch.empty((m, dim), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    c, s = codes.contiguous(), scales.contiguous()
    lib = _build.load(_SOURCE)
    fn = lib.pull_dequant_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = fn(c.data_ptr(), s.data_ptr(), out.data_ptr(), m, dim, stream)
    _build.check(lib, rc, f"pull_dequant m={m} dim={dim}")
    _SPEC.launches += 1
    return out


_SPEC = registry.register(
    "pull_dequant", _pull_dequant_cuda, pull_dequant_ref,
    # copied from the reference's registration
    tolerance="bit-exact vs xla_ref (exact int8->f32 conversion + one "
              "f32 multiply of identical operands; tolerance 0.0)",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/pull_dequant.cu",
    replaces="paddle_tpu/ops/pallas/pull_dequant.py:44",
    doc="on-device reconstruction of int8 PS pull rows (codes * per-row "
        "scale), one code a thread over a grid-stride loop",
)


def pull_dequant(codes: torch.Tensor, scales: torch.Tensor, *,
                 mode=None) -> torch.Tensor:
    """``codes`` [m, dim] int8, ``scales`` [m] f32 -> [m, dim] f32."""
    return registry.dispatch("pull_dequant", codes, scales, mode=mode)
