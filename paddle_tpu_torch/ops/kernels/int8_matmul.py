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
  1e-5 at f32).  The kernel splits K across the blocks of a cluster on a plan
  from :func:`int8_wonly_plan` and adds the f32 partials in split order
  in the same launch: :func:`int8_matmul_wonly_split_ref` sums in that order.

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
depth and grid, from the card's SM count.  Weight-only mode also needs x's
rows on 16 bytes; the wrapper copies x into such rows where they are not.

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
           "int8_mm_plan", "Int8MmPlan", "int8_wonly_plan", "Int8WonlyPlan",
           "int8_matmul_wonly_split_ref"]

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


# The weight-only kernel's constants (csrc/int8_matmul.cu, namespace
# wonly): weight rows a block, K a chunk, threads, the rows of x a block
# may take, the most splits (a portable cluster), and the f32 pitch of its
# dequantised chunk
_WBN, _WKC, _WTHREADS, _WMAX_SPLITS = 64, 64, 128, 8
_WBMS = (8, 16, 32, 64, 128)
_WCP = _WBN + 4


def _wonly_stages(block_m: int) -> int:
    """Chunks in the kernel's cp.async ring."""
    return 8 if block_m <= 16 else 4


def _wonly_smem(block_m: int, elt: int) -> int:
    """The weight-only kernel's dynamic shared memory (the C entry checks
    the same): the ring of weight and x chunks (x rows padded by 16
    bytes) and, for f32 at 32 rows of x or more, the dequantised chunk;
    wgmma's ring (bf16 at 128 rows) has 80-byte weight rows, 128-byte x
    rows and 1,024 bytes to align it."""
    if elt == 2 and block_m == 128:
        return 1024 + _wonly_stages(block_m) * (_WBN * 80 + block_m * 128)
    return (_wonly_stages(block_m) * (_WBN * _WKC
                                      + block_m * (_WKC * elt + 16))
            + (_WBN * _WCP * 4 if elt == 4 and block_m > 16 else 0))


class Int8WonlyPlan(NamedTuple):
    """How the weight-only kernel runs one [M, K] x [N, K] product."""

    route: str         # "mma_bf16" (mma.sync on the dequantised weight),
                       # "wgmma_bf16" (wgmma, at 128 rows of x) or
                       # "fma_f32" (CUDA-core FMA)
    block_m: int       # rows of x a block: 8, 16, 32, 64 or (bf16) 128
    tiles_n: int       # 64-row tiles of the weight
    tiles_m: int       # block_m-row tiles of x
    splits: int        # blocks of a cluster that share a tile, each a
                       # range of K
    chunks_a_split: int  # 64-wide chunks of K a split (the last may have
                         # fewer)
    stages: int        # chunks in the cp.async ring
    threads: int
    smem_bytes: int    # dynamic shared memory a block
    grid: int          # tiles_n * tiles_m * splits blocks

    def launch(self) -> tuple:
        """The seven ints the C entry takes."""
        return (self.block_m, self.splits, self.chunks_a_split, self.stages,
                self.threads, self.smem_bytes, self.grid)

    def k_bounds(self, K: int) -> list:
        """The [k0, k1) range of K each split sums, in split order."""
        step = self.chunks_a_split * _WKC
        return [(s * step, min(K, (s + 1) * step))
                for s in range(self.splits)]


def int8_wonly_plan(M: int, N: int, K: int, dtype,
                    sm_count: int = H100_SMS) -> Int8WonlyPlan:
    """The weight-only kernel's launch plan for x [M, K] (``dtype``, the
    compute dtype: float32 or bfloat16) times w [N, K] on a card of
    ``sm_count`` SMs.

    - A block takes 64 weight rows and ``block_m`` rows of x: the least of
      8, 16, 32, 64, 128 that holds M (bf16) or of 8, 16, 32, 64 (f32,
      whose FMA tiles ran no faster at 128 rows: PERF.md section 6), and
      the largest above that (more rows of x run in more tiles).
    - K is cut into 64-wide chunks, and the chunks into ``splits`` equal
      runs (the last may be shorter) so that tiles x splits give each SM
      two blocks: ``2 * sm_count // tiles`` splits, at least 1, at most 8
      (a cluster) and at most one a chunk.  The splits of a tile run as
      one cluster and add their f32 partials in split order.
    - bf16 runs mma.sync on the dequantised weight, or wgmma at 128 rows
      of x (faster there: PERF.md section 6); f32 runs FMA on CUDA
      cores.

    What fixes the order of the sums (block_m and the splits) depends on
    M, N, K and the SM count alone.  Pure arithmetic: it runs without a
    card."""
    dt = dtype if isinstance(dtype, torch.dtype) else to_torch(dtype)
    if min(M, N, K, sm_count) < 1 or dt not in (torch.float32,
                                                 torch.bfloat16):
        raise ValueError(
            f"int8_wonly_plan: M {M}, N {N}, K {K}, {dt}, sm_count "
            f"{sm_count} (needs positive sizes and float32 or bfloat16)")
    heights = _WBMS if dt == torch.bfloat16 else _WBMS[:-1]
    bm = next((b for b in heights if b >= M), heights[-1])
    chunks = -(-K // _WKC)
    tiles_n, tiles_m = -(-N // _WBN), -(-M // bm)
    want = 2 * sm_count // (tiles_n * tiles_m)
    cps = -(-chunks // max(1, min(want, chunks, _WMAX_SPLITS)))
    splits = -(-chunks // cps)
    grid = tiles_n * tiles_m * splits
    if grid > 2**31 - 1:
        raise ValueError(
            f"int8_wonly_plan: M {M}, N {N}, K {K}: {grid} blocks, over "
            "the 2^31 - 1 a launch may have")
    route = ("fma_f32" if dt == torch.float32
             else "wgmma_bf16" if bm == 128 else "mma_bf16")
    return Int8WonlyPlan(
        route=route,
        block_m=bm, tiles_n=tiles_n, tiles_m=tiles_m, splits=splits,
        chunks_a_split=cps, stages=_wonly_stages(bm), threads=_WTHREADS,
        smem_bytes=_wonly_smem(bm, dt.itemsize), grid=grid)


def _wonly_weight(w_nk, scale, cdt):
    """The reference's dequantised weight: cdt(q) * cdt(scale)."""
    return w_nk.to(cdt) * scale.to(cdt)[:, None]


def _int8_matmul_plain(x2, w_nk, scale, dynamic, cdt):
    if dynamic:
        acc = (x2.double() @ w_nk.double().t()).to(torch.int32)
        return (acc.float() * scale).to(cdt)
    return x2.to(cdt) @ _wonly_weight(w_nk, scale, cdt).t()


def int8_matmul_wonly_split_ref(x, w_nk, w_scale, compute_dtype=None,
                                plan=None):
    """Weight-only ``int8_matmul`` summed in the kernel's order: the
    reference's dequantised weight, one f32 product a split of K
    (``plan.k_bounds``; default ``int8_wonly_plan`` on an H100), the
    partials added in split order, one rounding to the compute dtype.
    ``x`` [..., K] float, ``w_nk`` [N, K] int8, ``w_scale`` [N] f32."""
    cdt = torch.bfloat16 if compute_dtype is None else to_torch(compute_dtype)
    k = x.shape[-1]
    x2 = x.reshape(-1, k).to(cdt)
    if plan is None:
        plan = int8_wonly_plan(x2.shape[0], w_nk.shape[0], k, cdt)
    w = _wonly_weight(w_nk, w_scale.float(), cdt)
    acc = None
    for k0, k1 in plan.k_bounds(k):
        part = x2[:, k0:k1].float() @ w[:, k0:k1].float().t()
        acc = part if acc is None else acc + part
    return acc.to(cdt).reshape(*x.shape[:-1], w_nk.shape[0])


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
    registry.note_launch(_SPEC, "dynamic")


@functools.lru_cache(maxsize=4096)
def _wonly_launch_plan(m, n, k, cdt, device):
    """The weight-only plan of a shape on a card and its seven ints."""
    plan = int8_wonly_plan(m, n, k, cdt, _sm_count(device))
    return plan, (ctypes.c_int * 7)(*plan.launch())


def _float_rows(x2):
    """``x2`` [m, k] float itself when it starts on 16 bytes with unit
    stride along k and (m > 1) rows a multiple of 16 bytes apart, else a
    copy in such rows (the weight-only kernel reads x by 16-byte copies)."""
    m, k = x2.shape
    elt = x2.element_size()
    if (x2.stride(-1) == 1 and x2.data_ptr() % 16 == 0
            and (m == 1 or (x2.stride(0) >= k
                            and (x2.stride(0) * elt) % 16 == 0))):
        return x2
    kp = -(-k * elt // 16) * 16 // elt
    rows = torch.empty((m, kp), dtype=x2.dtype, device=x2.device)[:, :k]
    rows.copy_(x2)
    return rows


def _launch_wonly(x2, w, scale, out) -> None:
    """Launch the weight-only kernel on its plan: x2 [M, K] float in the
    rows :func:`_float_rows` gives, w [N, K] int8 in 16-byte rows, scale
    [N] f32, out [M, N] contiguous in x2's dtype."""
    m, k = x2.shape
    n = w.shape[0]
    dev = x2.device
    plan, ints = _wonly_launch_plan(m, n, k, x2.dtype, dev)
    lib = _build.load(_SOURCE)
    fn = lib.int8_matmul_weight_only
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # a one-row tensor's row stride is never used and may be anything
        rc = fn(x2.data_ptr(), x2.stride(0) if m > 1 else k, w.data_ptr(),
                w.stride(0), scale.data_ptr(), out.data_ptr(), m, n, k,
                int(x2.dtype == torch.bfloat16), ints, stream)
    if rc:
        _build.check(lib, rc, f"int8_matmul_weight_only M={m} N={n} K={k} "
                              f"{x2.dtype} {plan}")
    registry.note_launch(_SPEC, "weight_only")


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
    _launch_wonly(_float_rows(x2.to(cdt)), w, scale, out)
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
        "epilogue; weight-only splits K across a cluster's blocks and "
        "dequantises into mma.sync or (128 rows of x) wgmma fragments "
        "(bf16) or shared memory "
        "(f32), the partials merged in split order in the launch: no "
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
