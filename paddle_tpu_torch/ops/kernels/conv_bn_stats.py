"""A 1x1 convolution as a matrix product with the batch-norm statistics of
its output: the Hopper kernel and its plain version.

Counterpart of ``tools/exp_conv_bn_kernel.py`` (kernel 10, ``_kernel``,
launched by ``fused_matmul_bn_stats``): ``y = x @ w`` with an f32
accumulator stored in x's dtype, and per output channel the sum and the
sum of squares of that f32 accumulator (``s1``, ``s2``), so that a batch
norm after the convolution would not read the activation again for its
statistics.  The kernel writes one partial sum per 128-row block and
column; the wrapper adds them with ``torch.sum(dim=0)``, as the
reference's ``p1.sum((0, 1))`` leaves that to XLA outside its kernel.

The tile is the kernel's own compile-time choice: 128 rows by 128
columns (64 where N <= 64), K in steps of 32.  There are no tile
arguments; the reference's ``bm`` / ``bn`` sized VMEM blocks.

Takes ``x`` [M, K] and ``w`` [K, N] in bfloat16, both contiguous and
16-byte aligned, any M, K and N multiples of 8.  A CUDA call outside
that raises ``ValueError`` naming the reason; nothing else runs in its
place.  The port's ResNet training does not call it: the reference's
batch norm takes two-pass moments (``nn.functional.common._moments``),
which this kernel's one-pass sums cannot give, and the reference left
ResNet-50 on XLA's convolutions after its A/B.  Its entry point is the
A/B, ``paddle_tpu_torch.tools.exp_conv_bn_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, registry

__all__ = ["fused_matmul_bn_stats", "fused_matmul_bn_stats_ref",
           "card_check", "CARD_TOL", "BLOCK_ROWS"]

_SOURCE = "conv_bn_stats.cu"
BLOCK_ROWS = 128   # rows of one partial (the kernel's tile height)
# The kernel against its plain version on the card (``card_check``):
# - y: (atol, rtol, row, whole) as registry.card_error reads it.  The
#   kernel's bf16 products are exact in f32, so its accumulator differs
#   from the plain f32 product only by the order of its K additions;
#   rounding either to bf16 can then land one bf16 step apart (2^-7 of
#   |y| at most), plus 1e-3 of y's RMS for the order term of outputs
#   that cancel to near zero.
# - s1: 1e-5 of the column's sum of |acc|: f32 sums of M terms in two
#   orders (128-row blocks then partials, against PyTorch's reduction).
# - s2: 1e-5 relative (a sum of squares does not cancel).
CARD_TOL = {"y": (0.0, 2.0 ** -7, 0.0, 1e-3), "s1": 1e-5, "s2": 1e-5}


def fused_matmul_bn_stats_ref(x: torch.Tensor, w: torch.Tensor):
    """The plain version: the f32 product, rounded once to x's dtype, and
    the column sums of the f32 product and of its square."""
    acc = x.float() @ w.float()
    return acc.to(x.dtype), acc.sum(0), (acc * acc).sum(0)


def _eligible(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        return (f"x {tuple(x.shape)} and w {tuple(w.shape)} (needs [M, K] "
                f"and [K, N])")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return f"x {x.dtype}, w {w.dtype} (takes bfloat16)"
    k, n = w.shape
    if k == 0 or n == 0 or k % 8 or n % 8:
        return f"K {k} and N {n} must be positive multiples of 8"
    if not (x.is_contiguous() and w.is_contiguous()):
        return "x and w must be contiguous"
    if not (x.is_cuda and w.is_cuda):
        return "x and w must be CUDA tensors"
    if x.device != w.device:
        return f"x on {x.device}, w on {w.device}"
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        return "x and w must start on 16 bytes"
    if x.shape[0] >= 2 ** 31:
        return f"M {x.shape[0]} does not fit the kernel's int"
    return None


def _fused_cuda(x, w):
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        z = torch.zeros(n, dtype=torch.float32, device=x.device)
        return y, z, z.clone()
    blocks = -(-m // BLOCK_ROWS)
    p = torch.empty((2, blocks, n), dtype=torch.float32, device=x.device)
    lib = _build.load(_SOURCE)
    fn = lib.conv_bn_stats_bf16
    if fn.argtypes is None:
        lib.conv_bn_stats_block_rows.restype = ctypes.c_int
        if lib.conv_bn_stats_block_rows() != BLOCK_ROWS:
            raise RuntimeError("conv_bn_stats.cu's tile height is not "
                               f"BLOCK_ROWS = {BLOCK_ROWS}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), p[0].data_ptr(),
                p[1].data_ptr(), m, n, k, stream)
    _build.check(lib, rc, f"conv_bn_stats M={m} K={k} N={n}")
    registry.note_launch(_SPEC)
    s = p.sum(dim=1)
    return y, s[0], s[1]


_SPEC = registry.register(
    "conv_bn_stats", _fused_cuda, fused_matmul_bn_stats_ref,
    tolerance="y within one bf16 step of the plain version plus 1e-3 of "
              "y's RMS; s1 within 1e-5 of each column's sum of |acc|; s2 "
              "within 1e-5 relative (sums in another order; see CARD_TOL)",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/conv_bn_stats.cu",
    replaces="tools/exp_conv_bn_kernel.py:30",
    doc="1x1 conv as a bf16 mma.sync product with each column's sum and "
        "sum of squares of the f32 accumulator taken in the epilogue; "
        "one partial per 128-row block, no atomics",
)


def fused_matmul_bn_stats(x: torch.Tensor, w: torch.Tensor, *, mode=None):
    """``x`` [M, K] @ ``w`` [K, N] -> ``(y [M, N] in x's dtype, s1 [N],
    s2 [N])``: s1 and s2 are the column sums of the f32 product and of
    its square.  See the module docstring."""
    return registry.dispatch("conv_bn_stats", x, w, mode=mode)


def card_check(x, w, got, ref=None):
    """``got`` (the kernel's ``(y, s1, s2)``) against the plain version on
    the same inputs under :data:`CARD_TOL`.  Returns ``{name: (largest
    |err|, largest share of its limit)}``; every element is within iff
    each share is at most 1."""
    acc = x.float() @ w.float()
    if ref is None:
        ref = (acc.to(x.dtype), acc.sum(0), (acc * acc).sum(0))
    out = {"y": registry.card_error(got[0], ref[0], CARD_TOL["y"])}
    lim1 = CARD_TOL["s1"] * acc.abs().sum(0)
    lim2 = CARD_TOL["s2"] * ref[2].abs()
    for name, g, r, lim in (("s1", got[1], ref[1], lim1),
                            ("s2", got[2], ref[2], lim2)):
        err = (g.float() - r.float()).abs()
        share = torch.where(err > 0, err / lim, torch.zeros_like(err))
        out[name] = (err.max().item(), share.max().item())
    return out
