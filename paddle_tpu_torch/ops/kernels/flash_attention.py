"""Flash attention, forward and backward: the Hopper kernels and their
plain versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: kernel 1
(``_fwd_kernel``) and kernels 2 and 3 (``_bwd_dkv_kernel``,
``_bwd_dq_kernel``).

- The forward (``csrc/flash_attention_fwd.cu``) is a blockwise
  online-softmax kernel, causal or not, bf16 or f32, head_dim 64/128/256,
  any sequence length.  Grouped-query attention indexes kv head
  ``h // (H // Hkv)`` instead of materialising the repeat.  It can also
  emit the per-row logsumexp (LSE) [B, H, Sq] f32 for the backward.
  bf16 at head_dim 128 -- the route of the serving prefill and of
  training -- takes the Hopper kernel (TMA loads into a 2-stage ring,
  ``wgmma`` for both products, a producer warp and two consumer
  warpgroups, 128-row query and 128-key tiles); the other dtypes and
  head dims take the first kernel (``mma.sync`` or FMA, 64- or 32-row
  tiles).  :func:`flash_fwd_plan` computes the route, tiles, grid and
  TMA strides in Python, and the wrapper passes them to the C entry
  point.
- The backward (``csrc/flash_attention_bwd.cu``) is FlashAttention-2's:
  a dK/dV kernel, one block per (batch, kv head, key tile) looping over
  the query tiles of every head of its group, and a dQ kernel, one block
  per (batch, head, query tile) looping over key tiles.  Both recompute
  P from the saved LSE; ``delta = rowsum(dO * O)`` is plain PyTorch, as
  the reference computes it in plain XLA.  No atomics: bitwise the same
  gradients from run to run.

Numerics follow the Pallas kernels: scores ``(q . k) * scale`` in f32,
masked scores -1e30 (probability 0), online max/denominator in f32, the
denominator clamped at 1e-30; on the bf16 path the probabilities P (and
in the backward dS) are rounded to bf16 before their products.  The
causal mask is top-left aligned (query i sees keys 0..i), as the Pallas
kernels have it.

The plain versions :func:`flash_attention_ref` and
:func:`flash_attention_bwd_dkv_ref` / :func:`flash_attention_bwd_dq_ref`
are chunked f32 PyTorch (the counterpart of ``_ref_chunked`` and of its
autodiff); the ``*_blockwise_ref`` versions round P (and dS) to the
input dtype as the kernels do, and the bf16 kernels are held to them on
the card.

:class:`_FlashAttention` (a ``torch.autograd.Function``) makes
:func:`flash_attention` / :func:`flash_attention_bhsd` differentiable:
its forward dispatches the forward with the LSE, its backward the two
backward kernels, all through the registry (kernels for CUDA tensors,
plain versions for CPU tensors or where ``mode`` says so).

Bias and dropout are not ported (no Llama path uses them).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build, registry

__all__ = ["flash_attention", "flash_attention_bhsd", "flash_attention_ref",
           "flash_attention_blockwise_ref", "flash_fwd_plan", "FwdPlan",
           "flash_attention_bwd_dkv_ref", "flash_attention_bwd_dq_ref",
           "flash_attention_bwd_blockwise_ref", "attention_delta",
           "flash_eligible", "CARD_TOL", "CARD_TOL_BWD", "NEG_INF"]

NEG_INF = -1e30
_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_HEAD_DIMS = (64, 128, 256)
# sequence length from which the Llama attention takes the flash kernels
# (the reference's flash_eligible floor)
FLASH_MIN_SEQ = 1024
# The kernel against its plain version on the card, as (atol, rtol, row):
# |kernel - plain| <= atol + rtol * |plain| + row * (RMS of the plain
# output's row over head_dim).  f32, against flash_attention_ref: the
# registered atol.  bf16, against flash_attention_blockwise_ref (which
# rounds P to bf16 as the kernel does): rtol is one rounding of the bf16
# output (2**-7); the row term covers a probability whose bf16 rounding
# flips on a last-bit difference of its score (the tensor cores sum q.k in
# another order), which moves an output by up to 2**-8 * |v| / l.
CARD_TOL = {torch.float32: (1e-4, 0.0, 0.0),
            torch.bfloat16: (0.0, 8e-3, 0.02)}
# The backward kernels' dQ, dK and dV against the plain versions, in the
# same form; the row term is per query row (dQ) or per key row (dK, dV).
# f32, against the chunked f32 version: the registered atol, plus 1e-4 of
# |plain| for sums over up to S query or key terms.  bf16, against
# flash_attention_bwd_blockwise_ref (P and dS rounded to bf16 as in the
# kernels): rtol is one rounding of the bf16 output (2**-7); the row term
# covers P or dS elements whose bf16 rounding flips on a last-bit
# difference of a score or of dO.v (summed in another order on the tensor
# cores).  One flip moves a dK/dV/dQ row by 2**-8 of one of its terms, at
# most 2**-8 of the row's scale, so 0.02 leaves room for several.  The
# fourth term, 1e-3 of the whole output's RMS, covers rows that cancel to
# rounding noise: query 0 under the causal mask sees only key 0, so its
# dS = P * (dO.v - dO.o) is zero up to rounding and both versions give
# dQ row 0 as noise of ~1e-7 in their own summation orders.
CARD_TOL_BWD = {torch.float32: (1e-4, 1e-4, 0.0),
                torch.bfloat16: (0.0, 8e-3, 0.02, 1e-3)}


def flash_eligible(seq_len: int, head_dim: int) -> bool:
    """Whether the Llama attention takes the flash kernels: head_dim 64,
    128 or 256 and at least ``FLASH_MIN_SEQ`` positions (the reference's
    rule without its TPU-backend test -- the registry routes by device --
    and without its environment override)."""
    return head_dim in _HEAD_DIMS and seq_len >= FLASH_MIN_SEQ


def flash_attention_ref(q, k, v, causal=False, scale=None, return_lse=False,
                        chunk=512):
    """Plain attention on (B, H, S, D) tensors, queries in chunks of
    ``chunk`` rows so the score block stays [B, H, chunk, Sk]."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    if Hkv != H:
        kf = kf.repeat_interleave(H // Hkv, dim=1)
        vf = vf.repeat_interleave(H // Hkv, dim=1)
    kpos = torch.arange(Sk, device=q.device)
    outs, lses = [], []
    for q0 in range(0, Sq, chunk):
        qc = q[:, :, q0:q0 + chunk].float()
        s = torch.matmul(qc * sc, kf.transpose(-1, -2))
        if causal:
            qpos = torch.arange(q0, q0 + qc.shape[2], device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        if return_lse:
            lses.append(torch.logsumexp(s, dim=-1))
        outs.append(torch.matmul(torch.softmax(s, dim=-1), vf))
    o = torch.cat(outs, dim=2).to(q.dtype)
    return (o, torch.cat(lses, dim=2)) if return_lse else o


def flash_attention_blockwise_ref(q, k, v, causal=False, scale=None,
                                  block_k=64):
    """The Pallas kernel's online softmax in plain PyTorch, on (B, H, S, D)
    tensors: keys in blocks of ``block_k``, scores ``(q . k) * scale`` in
    f32, running max and denominator in f32, and the probabilities cast to
    the value dtype against the running max before P.V.  With bf16 inputs
    that cast rounds P as the kernel does when ``block_k`` is the
    kernel's key tile (``flash_fwd_plan(q, k, v).block_k``: 128 at
    head_dim 128, 64 otherwise), so the bf16 kernel is held to this
    version; with f32 inputs it equals :func:`flash_attention_ref` up to
    summation order."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    qf = q.float()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[-1]), device=q.device)
    for k0 in range(0, Sk, block_k):
        kb, vb = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = torch.matmul(qf, kb.float().transpose(-1, -2)) * sc
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = s.masked_fill(qpos < kpos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                    vb.float())
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _eligible(q, k, v, causal=False, scale=None, return_lse=False):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        return "q, k and v must all be CUDA tensors"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return f"expects (B, H, S, D) tensors, got {tuple(q.shape)}"
    if q.dtype not in (torch.bfloat16, torch.float32):
        return f"dtype {q.dtype} (takes bfloat16 or float32)"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return f"mixed dtypes q={q.dtype} k={k.dtype} v={v.dtype}"
    B, H, _, D = q.shape
    if D not in _HEAD_DIMS:
        return f"head_dim {D} (takes {_HEAD_DIMS})"
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        return (f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                f"q {tuple(q.shape)}")
    if H % k.shape[1]:
        return f"query heads {H} not a multiple of kv heads {k.shape[1]}"
    return None


def _takes_as_is(t):
    """Whether the kernels read ``t`` where it lies: unit stride on D, a
    16-byte aligned start, and 16-byte multiples as the strides of every
    dimension longer than one (what TMA's tensor maps need; the first
    kernel needs no more)."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % vec == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])
                    if n > 1))


def _rowmajor(t):
    """``t`` itself if the kernels take it as is, else a contiguous
    copy."""
    return t if _takes_as_is(t) else t.contiguous()


# the Hopper route's tiles, as compiled in csrc/flash_attention_fwd.cu
# (namespace sm90): 128 query rows (two consumer warpgroups of 64) and
# 128-key K/V tiles in a 2-stage ring, 384 threads; shared memory is
# 1024 bytes of alignment slack, Q, both stages of K and V and the O
# staging tile (32 KB each) and 10 mbarriers.  The grid is one block per
# SM at most; each block loops over its share of the (query tile, head,
# batch) work items.
_SM90 = dict(block_q=128, block_k=128, stages=2, threads=384,
             smem_bytes=1024 + 32768 * (2 + 2 * 2) + 8 * (2 + 4 * 2))
# SMs of an H100 SXM: the grid's bound where no card is at hand to ask
H100_SMS = 132


def _sm_count(device):
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel runs on given q, k, v (B, H, S, D)."""

    route: str          # "tma_wgmma" (bf16, D=128), "mma_sync" or "fma"
    block_q: int        # query rows per block
    block_k: int        # keys per tile: the rounding tile of P
    stages: int         # K/V tiles in flight (1: loaded synchronously)
    threads: int        # per block
    smem_bytes: int     # dynamic shared memory per block
    grid: tuple         # (x, y, z) as launched
    # tma_wgmma only: the byte strides (seq, head, batch) of q, k, v and
    # the output, as their 4-D (D, S, H, B) tensor maps take them
    tma_strides: tuple
    # per tensor: taken where it lies (else _rowmajor copies it first)
    as_is: dict


def _tma_strides(t):
    """(seq, head, batch) byte strides of a (B, H, S, D) tensor for its
    tensor map; a dimension of length one is never stepped, so it gets
    the (valid) stride of the whole tensor's span instead of whatever
    PyTorch left there."""
    elt = t.element_size()
    span = -(-t.numel() * elt // 16) * 16
    return tuple(t.stride(i) * elt if t.shape[i] > 1 else span
                 for i in (2, 1, 0))


def flash_fwd_plan(q, k, v):
    """The launch plan of the forward kernel for (B, H, S, D) q, k, v:
    the route, tiles, grid and, on the Hopper route, the TMA strides.
    bf16 at head_dim 128 always takes the Hopper route; a tensor it
    cannot take as is (``as_is`` False) is made row-major by
    :func:`_rowmajor` first, never sent to the other kernel.  Pure shape
    arithmetic: it runs on CPU tensors too."""
    B, H, Sq, D = q.shape
    as_is = {n: _takes_as_is(t) for n, t in (("q", q), ("k", k), ("v", v))}
    if q.dtype == torch.bfloat16 and D == 128:
        route, bq, bk, stages, threads, smem = (
            "tma_wgmma", _SM90["block_q"], _SM90["block_k"],
            _SM90["stages"], _SM90["threads"], _SM90["smem_bytes"])
        # q, k, v as given; o as the wrapper allocates it, (B, Sq, H, D)
        tma = tuple(x for t in (q, k, v) for x in _tma_strides(t)) + (
            H * D * 2, D * 2, Sq * H * D * 2)
    elif q.dtype == torch.bfloat16:
        route, bq, bk, stages, threads = "mma_sync", 64, 64, 1, 128
        smem = (bq + 2 * bk) * (D + 8) * 2
        tma = ()
    else:
        route, bq, bk, stages, threads = "fma", 32, 32, 1, 128
        smem = (bq * D + bk * (D + 1) + bk * D + 4 * 8 * bk) * 4
        tma = ()
    n_qt = -(-Sq // bq)
    if route == "tma_wgmma":
        grid = (min(n_qt * H * B, _sm_count(q.device)), 1, 1)
    else:
        grid = (n_qt, H, B)
    return FwdPlan(route, bq, bk, stages, threads, smem, grid, tma, as_is)


def _flash_fwd_cuda(q, k, v, causal=False, scale=None, return_lse=False):
    q, k, v = _rowmajor(q), _rowmajor(k), _rowmajor(v)
    plan = flash_fwd_plan(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.load(_SOURCE)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if lse is not None else None)
        if plan.route == "tma_wgmma":
            fn = lib.flash_attention_fwd_sm90
            if fn.argtypes is None:
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                  ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            launch = (plan.block_q, plan.block_k, plan.stages, plan.threads,
                      plan.smem_bytes, *plan.grid)
            rc = fn(*ptrs, B, H, Hkv, Sq, Sk,
                    (ctypes.c_longlong * 12)(*plan.tma_strides),
                    (ctypes.c_int * 8)(*launch), int(bool(causal)),
                    float(sc), stream)
        else:
            fn = lib.flash_attention_fwd
            if fn.argtypes is None:
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                               + [ctypes.c_longlong] * 12
                               + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
            rc = fn(*ptrs, B, H, Hkv, Sq, Sk, D,
                    q.stride(0), q.stride(1), q.stride(2),
                    k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    o.stride(0), o.stride(1), o.stride(2),
                    int(bool(causal)), float(sc),
                    int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, f"flash_attention_fwd ({plan.route}) "
                          f"q={tuple(q.shape)} k={tuple(k.shape)} {q.dtype}")
    _SPEC.launches += 1
    return (o, lse) if return_lse else o


# copied from the reference's registration (its one flash entry covers
# the forward and the custom-vjp backward)
_TOLERANCE = ("atol ~1e-4 vs the chunked XLA reference (blockwise "
              "online softmax vs full softmax; measured in BENCH_r04); "
              "fwd+bwd self-parity pinned by tests/test_flash_attention")

_SPEC = registry.register(
    "flash_attention", _flash_fwd_cuda, flash_attention_ref,
    tolerance=_TOLERANCE,
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
    replaces="paddle_tpu/ops/pallas/flash_attention.py:72",
    doc="blockwise flash attention forward (+ optional LSE), causal or "
        "not, GQA by head index",
)


# ---------------------------------------------------------------------
# backward: plain versions
# ---------------------------------------------------------------------

def attention_delta(o, do):
    """``rowsum(dO * O)`` in f32, [B, H, Sq]: the backward's per-row
    correction (plain PyTorch, as the reference computes it in XLA)."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_chunked(q, k, v, do, lse, delta, causal, scale, want, round_p,
                 chunk=512):
    """FlashAttention-2's backward from the saved LSE, queries in chunks
    of ``chunk`` rows against all keys, in f32.  ``round_p`` rounds P and
    dS to the input dtype before their products, as the kernels do (the
    rounding is per element against the final LSE, so the chunking does
    not change what is rounded).  Returns the f32 gradients named in
    ``want`` ("dq", "dk", "dv"), dk/dv summed over each kv head's group
    of query heads."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    R = H // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    if R != 1:
        kf = kf.repeat_interleave(R, dim=1)
        vf = vf.repeat_interleave(R, dim=1)
    dev = q.device

    def rnd(x):
        return x.to(q.dtype).float() if round_p else x

    kpos = torch.arange(Sk, device=dev)
    dqs = []
    dk = torch.zeros((B, H, Sk, D), device=dev) if "dk" in want else None
    dv = torch.zeros((B, H, Sk, D), device=dev) if "dv" in want else None
    for q0 in range(0, Sq, chunk):
        qc = q[:, :, q0:q0 + chunk].float()
        doc = do[:, :, q0:q0 + chunk].float()
        s = torch.matmul(qc, kf.transpose(-1, -2)) * sc
        if causal:
            qpos = torch.arange(q0, q0 + qc.shape[2], device=dev)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        p = torch.exp(s - lse[:, :, q0:q0 + chunk, None])
        del s
        if dv is not None:
            dv += torch.matmul(rnd(p).transpose(-1, -2), doc)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = rnd(p * (dp - delta[:, :, q0:q0 + chunk, None]) * sc)
        del p, dp
        if "dq" in want:
            dqs.append(torch.matmul(ds, kf))
        if dk is not None:
            dk += torch.matmul(ds.transpose(-1, -2), qc)
    out = {}
    if dqs:
        out["dq"] = torch.cat(dqs, dim=2)
    for name, g in (("dk", dk), ("dv", dv)):
        if g is not None:
            out[name] = g.view(B, Hkv, R, Sk, D).sum(dim=2) if R != 1 else g
    return out


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False,
                                scale=None):
    """Plain dK, dV (input dtype) from the saved LSE and ``delta``:
    chunked f32, P and dS unrounded."""
    g = _bwd_chunked(q, k, v, do, lse, delta, causal, scale, ("dk", "dv"),
                     round_p=False)
    return g["dk"].to(k.dtype), g["dv"].to(v.dtype)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=False,
                               scale=None):
    """Plain dQ (input dtype) from the saved LSE and ``delta``: chunked
    f32, P and dS unrounded."""
    g = _bwd_chunked(q, k, v, do, lse, delta, causal, scale, ("dq",),
                     round_p=False)
    return g["dq"].to(q.dtype)


def flash_attention_bwd_blockwise_ref(q, k, v, do, lse, delta, causal=False,
                                      scale=None):
    """The Pallas backward kernels' arithmetic in plain PyTorch: P and dS
    rounded to the input dtype before their products, f32 sums.  With
    bf16 inputs the bf16 kernels are held to this version; with f32
    inputs it equals the chunked plain versions.  Returns (dq, dk, dv)."""
    g = _bwd_chunked(q, k, v, do, lse, delta, causal, scale,
                     ("dq", "dk", "dv"), round_p=True)
    return g["dq"].to(q.dtype), g["dk"].to(k.dtype), g["dv"].to(v.dtype)


# ---------------------------------------------------------------------
# backward: kernels
# ---------------------------------------------------------------------

def _bwd_eligible(q, k, v, do, lse, delta, causal=False, scale=None):
    reason = _eligible(q, k, v)
    if reason:
        return reason
    if not do.is_cuda or do.shape != q.shape or do.dtype != q.dtype:
        return (f"dO {tuple(do.shape)} {do.dtype} does not match q "
                f"{tuple(q.shape)} {q.dtype}")
    want = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if (not t.is_cuda or t.dtype != torch.float32
                or tuple(t.shape) != want):
            return (f"{name} must be a CUDA float32 {want} tensor, got "
                    f"{tuple(t.shape)} {t.dtype}")
    return None


def _bwd_launch(entry, spec, q, k, v, do, lse, delta, outs, causal, scale):
    """Launch ``entry`` of the backward library.  ``outs``: (dq, dk, dv)
    with None where the kernel does not write."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    strides = []
    for t in (q, k, v, do) + tuple(outs):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    lib = _build.load(_BWD_SOURCE)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        # q, k, v, dO, lse, delta, the outputs; B, H, Hkv, Sq, Sk, D;
        # strides; causal, scale, is_bf16, stream
        n_ptr = 6 + sum(o is not None for o in outs)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                *[o.data_ptr() for o in outs if o is not None],
                B, H, Hkv, Sq, Sk, D, (ctypes.c_longlong * 21)(*strides),
                int(bool(causal)), float(sc), int(q.dtype == torch.bfloat16),
                stream)
    _build.check(lib, rc, f"{entry} q={tuple(q.shape)} k={tuple(k.shape)} "
                          f"{q.dtype}")
    spec.launches += 1


def _like_bshd(t):
    """An empty (B, H, S, D) tensor laid out as (B, S, H, D) memory, so
    that the gradient of a transposed (B, S, H, D) input is contiguous
    once transposed back."""
    B, H, S, D = t.shape
    return torch.empty((B, S, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False, scale=None):
    q, k, v, do = (_rowmajor(t) for t in (q, k, v, do))
    dk, dv = _like_bshd(k), _like_bshd(v)
    _bwd_launch("flash_attention_bwd_dkv", _DKV_SPEC, q, k, v, do,
                lse.contiguous(), delta.contiguous(), (None, dk, dv),
                causal, scale)
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal=False, scale=None):
    q, k, v, do = (_rowmajor(t) for t in (q, k, v, do))
    dq = _like_bshd(q)
    _bwd_launch("flash_attention_bwd_dq", _DQ_SPEC, q, k, v, do,
                lse.contiguous(), delta.contiguous(), (dq, None, None),
                causal, scale)
    return dq


_DKV_SPEC = registry.register(
    "flash_attention_bwd_dkv", _bwd_dkv_cuda, flash_attention_bwd_dkv_ref,
    tolerance=_TOLERANCE,
    eligible=_bwd_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas/flash_attention.py:208",
    doc="flash attention backward dK, dV from the saved LSE and delta; "
        "GQA sums the group's query heads in the kernel",
)

_DQ_SPEC = registry.register(
    "flash_attention_bwd_dq", _bwd_dq_cuda, flash_attention_bwd_dq_ref,
    tolerance=_TOLERANCE,
    eligible=_bwd_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas/flash_attention.py:258",
    doc="flash attention backward dQ from the saved LSE and delta",
)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the FlashAttention-2 backward (counterpart of
    the reference's ``_fa_impl`` custom vjp).  The forward keeps q, k,
    v, o and the LSE; under activation checkpointing the recompute's
    forward saves them anew, and the backward reads those."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mode):
        o, lse = registry.dispatch("flash_attention", q, k, v,
                                   causal=causal, scale=scale,
                                   return_lse=True, mode=mode)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.mode = causal, scale, mode
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(o, do)
        kw = dict(causal=ctx.causal, scale=ctx.scale, mode=ctx.mode)
        dk, dv = registry.dispatch("flash_attention_bwd_dkv", q, k, v, do,
                                   lse, delta, **kw)
        dq = registry.dispatch("flash_attention_bwd_dq", q, k, v, do, lse,
                               delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention_bhsd(q, k, v, causal=False, scale=None,
                         return_lse=False, mode=None):
    """Flash attention on (B, H, S, D) tensors (k/v may have fewer heads:
    grouped-query attention).  Returns ``o`` or ``(o, lse)``.
    Differentiable in q, k and v (through :class:`_FlashAttention`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, causal, scale, mode)
        return (o, lse) if return_lse else o
    return registry.dispatch("flash_attention", q, k, v, causal=causal,
                             scale=scale, return_lse=return_lse, mode=mode)


def flash_attention(q, k, v, causal=False, scale=None, mode=None):
    """Flash attention on paddle-layout (B, S, H, D) tensors."""
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, scale=scale,
                             mode=mode)
    return o.transpose(1, 2)
