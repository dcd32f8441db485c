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

The CUDA kernels (``csrc/int8_matmul.cu``) need int8 rows that start
on 16 bytes (the dynamic kernel reads them through TMA tensor maps);
:func:`aligned_rows` makes such a buffer, and the wrapper copies into
one (:func:`kernel_rows`) when a caller's rows are not aligned.  The
dynamic kernel reads both operands up to the next multiple of 16 of K,
so a weight whose K is not one must be zero there: :func:`kernel_rows`'
copies are, and so is ``weight_rows()`` of the int8 layers, which
builds them once.  Any M, N and K (TMA fills the K tail and the M and N
edges with zeros); leading batch dims of ``x`` are collapsed to rows.
Dynamic mode launches on a plan from :func:`int8_mm_plan`: tile, ring
depth and grid, from the card's SM count.

The plain version multiplies the int8 operands in f64 (exact: every
partial sum is an integer below 2^53) and casts to int32; f32 would not
be exact beyond K ~ 1040.  Weight-only uses the reference's expressions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...framework.dtype import to_torch
from . import _build, registry
from .flash_attention import H100_SMS, _sm_count

__all__ = ["int8_matmul", "aligned_rows", "kernel_rows", "CARD_TOL",
           "int8_mm_plan", "Int8MmPlan"]

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
    stride along k, else an int8 copy into rows of that layout that are
    zero from k to the next multiple of 16 (as the dynamic kernel needs
    its weight)."""
    m, k = t.shape
    if (t.stride(-1) == 1 and t.stride(0) % 16 == 0 and t.stride(0) >= k
            and t.data_ptr() % 16 == 0):
        return t
    kp = -(-k // 16) * 16
    rows = torch.zeros((m, kp), dtype=torch.int8, device=t.device)[:, :k]
    rows.copy_(t)
    return rows


# The dynamic kernel's constants (csrc/int8_matmul.cu): int8 bytes of K a
# k-tile (one 128-byte swizzle row), the deepest ring, the dynamic shared
# memory a block may have, and the kernel's own share of it (1,024 bytes
# to align the swizzled tiles, 128 for the ring's mbarriers)
_BK, _MAX_STAGES, _SMEM_LIMIT, _SMEM_FIXED = 128, 8, 232_448, 1024 + 128


class Int8MmPlan(NamedTuple):
    """How the dynamic kernel runs one [M, K] x [N, K] product."""

    block_m: int      # rows a tile: 64 or 128 (one or two consumer
                      # warpgroups of 64 rows)
    block_n: int      # columns a tile: 64 or 128
    k_tiles: int      # 128-byte k-tiles of K, each tile walks them all
    stages: int       # k-tiles in the shared-memory ring
    threads: int      # the consumer warpgroups and one producer warp
    smem_bytes: int   # dynamic shared memory a block
    grid: int         # blocks: at most one an SM, each walks its tiles
    tma_store: bool   # output rows a multiple of 16 bytes: TMA stores

    def launch(self) -> tuple:
        """The seven ints the C entry takes."""
        return (self.block_m, self.block_n, self.stages, self.threads,
                self.smem_bytes, self.grid, int(self.tma_store))


def int8_mm_plan(M: int, N: int, K: int, sm_count: int = H100_SMS,
                 out_bytes: int = 2) -> Int8MmPlan:
    """The dynamic kernel's launch plan for x [M, K] times w [N, K] into
    an [M, N] output of ``out_bytes`` a value, on a card of ``sm_count``
    SMs (at most one block an SM: the ring takes most of its shared
    memory).

    - 64 columns a tile where N <= 64, else 128.
    - 64 or 128 rows a tile, whichever leaves each block the fewer rows
      to walk (waves of tiles over the SMs times the tile's rows); 128 on
      a tie (fewer epilogues, w reloaded less often).
    - The grid is at most one block an SM; where tiles outnumber the SMs
      each block walks its tiles in turn.
    - Each tile walks all of K.  No GEMM of the int8 ResNet-50 gained
      from splitting K across blocks on an H100 (PERF.md section 6: at
      layer4's 3x3 at batch 1, 36 k-tiles on 4 tiles, no split count
      beat none), so no path here sends one.
    - The ring holds as many k-tiles as fit beside the output's staging
      tile, at most 8.

    Pure arithmetic: it runs without a card."""
    if min(M, N, K, sm_count) < 1 or out_bytes not in (2, 4):
        raise ValueError(f"int8_mm_plan: M {M}, N {N}, K {K}, sm_count "
                         f"{sm_count}, out_bytes {out_bytes} (needs "
                         "positive sizes and 2- or 4-byte outputs)")
    bn = 64 if N <= 64 else 128
    tiles_n = -(-N // bn)

    def rows_walked(bm):
        return -(-(-(-M // bm) * tiles_n) // sm_count) * bm

    bm = 128 if rows_walked(128) <= rows_walked(64) else 64
    tiles = -(-M // bm) * tiles_n
    wgs = bm // 64
    staging = wgs * 64 * bn * out_bytes
    stages = min(_MAX_STAGES,
                 (_SMEM_LIMIT - _SMEM_FIXED - staging) // ((bm + bn) * _BK))
    return Int8MmPlan(
        block_m=bm, block_n=bn, k_tiles=-(-K // _BK), stages=stages,
        threads=128 * wgs + 32,
        smem_bytes=_SMEM_FIXED + stages * (bm + bn) * _BK + staging,
        grid=min(tiles, sm_count), tma_store=(N * out_bytes) % 16 == 0)


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


@functools.lru_cache(maxsize=4096)
def _launch_plan(m, n, k, out_bytes, device):
    """The plan of a shape on a card and its seven ints as the C entry
    takes them (which it only reads), made once a shape: at batch 1 an
    int8 forward is bound by the host's time a launch."""
    plan = int8_mm_plan(m, n, k, _sm_count(device), out_bytes)
    return plan, (ctypes.c_int * 7)(*plan.launch())


def _launch_dynamic(x2, w, scale, out) -> None:
    """Launch the dynamic kernel: x2 [M, K] and w [N, K] int8 in 16-byte
    rows (w zero from K to the next multiple of 16), scale [N] f32, out
    [M, N] contiguous f32 or bf16."""
    m, k = x2.shape
    n = w.shape[0]
    dev = x2.device
    plan, ints = _launch_plan(m, n, k, out.element_size(), dev)
    lib = _build.load(_SOURCE)
    fn = lib.int8_matmul_dynamic
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(x2.data_ptr(), x2.stride(0), w.data_ptr(), w.stride(0),
                scale.data_ptr(), out.data_ptr(), m, n, k,
                int(out.dtype == torch.bfloat16), ints,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        _build.check(lib, rc, f"int8_matmul_dynamic M={m} N={n} K={k} "
                              f"{out.dtype} {plan}")
    _SPEC.launches += 1


def _int8_matmul_cuda(x2, w_nk, scale, dynamic, cdt):
    m, k = x2.shape
    n = w_nk.shape[0]
    out = torch.empty((m, n), dtype=cdt, device=x2.device)
    if m == 0:
        return out
    scale, w = scale.contiguous(), kernel_rows(w_nk)
    if dynamic:
        _launch_dynamic(kernel_rows(x2), w, scale, out)
        return out
    x2 = x2.to(cdt)
    if x2.stride(-1) != 1 or (m > 1 and x2.stride(0) < k):
        x2 = x2.contiguous()
    lib = _build.load(_SOURCE)
    fn = lib.int8_matmul_weight_only
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        # a one-row tensor's row stride is never used and may be anything
        rc = fn(x2.data_ptr(), x2.stride(0) if m > 1 else k, w.data_ptr(),
                w.stride(0), scale.data_ptr(), out.data_ptr(), m, n, k,
                int(cdt == torch.bfloat16), stream)
    _build.check(lib, rc, f"int8_matmul_weight_only M={m} N={n} K={k} "
                          f"{cdt}")
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
    doc="int8 x int8 -> int32 by wgmma on TMA-loaded tiles (persistent "
        "blocks) with the folded per-column rescale in the "
        "epilogue; weight-only dequantises in shared memory: no "
        "dequantised weight tensor is written",
)


def int8_matmul(x, w_nk, w_scale, x_scale=None, compute_dtype=None, *,
                mode=None):
    """``x`` [..., K] (int8 codes when ``x_scale`` is given, else float),
    ``w_nk`` [N, K] int8, ``w_scale`` [N] f32, ``x_scale`` a scalar (0-dim
    tensor or number) or None.  Returns [..., N] in ``compute_dtype``
    (default bfloat16).  Where ``w_nk``'s rows already start on 16 bytes
    and K is not a multiple of 16, its bytes from K to the next multiple
    of 16 must be zero (:func:`kernel_rows` gives such rows).  See the
    module docstring."""
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
