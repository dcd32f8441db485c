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
  bf16 at head_dim 128 without options -- the route of the serving
  prefill and of the proxy's training -- and at head_dim 64 with or
  without them -- ERNIE-3.0-base pretraining, the translation encoder's
  bias row in bf16 -- takes the Hopper kernel (TMA loads into a ring of
  2 or 4 stages, ``wgmma`` for both products, a producer warp and two
  consumer warpgroups, 128-row query and 128-key tiles); other bf16
  head dims take the first kernel (``mma.sync``, 64-row tiles); f32
  takes both products on the tensor cores as 3xTF32 (each operand split
  into two TF32 parts, three ``mma.sync`` products summed in f32; 64-row
  query tiles, a ``cp.async`` ring of key tiles).  :func:`flash_fwd_plan`
  computes the route, tiles, grid and TMA strides in Python, and the
  wrapper passes them to the C entry point.
- The backward (``csrc/flash_attention_bwd.cu``) is FlashAttention-2's:
  a dK/dV kernel, whose work item is (key tile, kv head, batch) looping
  over the query tiles of every head of its group, and a dQ kernel,
  whose work item is (query tile, head, batch) looping over key tiles.
  Both recompute P from the saved LSE; ``delta = rowsum(dO * O)`` is
  plain PyTorch, as the reference computes it in plain XLA.  No atomics:
  bitwise the same gradients from run to run.  bf16 at head_dim 128
  without dropout and at head_dim 64 with or without it takes the
  Hopper kernels (128 resident keys or query rows an item in two
  consumer warpgroups, 64-row tiles streamed by TMA through a ring of 2
  or 4 stages, every product a ``wgmma``, persistent blocks); the other
  dtypes and head dims take the first kernels (one block per item).
  :func:`flash_bwd_plan` computes both kernels' plans in Python.

Numerics follow the Pallas kernels: scores ``(q . k) * scale`` in f32,
masked scores -1e30 (probability 0), online max/denominator in f32, the
denominator clamped at 1e-30; on the bf16 path the probabilities P (and
in the backward dS) are rounded to bf16 before their products.  The
causal mask is top-left aligned (query i sees keys 0..i), as the Pallas
kernels have it.

:func:`chunked_attention` is the reference's memory-efficient attention
for flash-ineligible long sequences (``_ref_chunked``): plain PyTorch,
as the reference computes it in XLA with no Pallas kernel.

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

The reference's two options run on the Hopper routes at bf16 head_dim
64 (forward and backward), on the 3xTF32 forward for f32, and on the
first kernels otherwise (``mma.sync`` for bf16 at head_dim 128 and 256,
FMA for the f32 backward; ``flash_fwd_plan`` / ``flash_bwd_plan`` record
the route):

- **bias**: an additive row in q's dtype (padding masks) that
  broadcasts to [B, 1, 1, Sk] (a row shared by the batch is read with
  batch stride 0), added in f32 to the scaled scores, forward only.
  With a bias the backward is plain PyTorch, the chunked backward from
  the saved LSE (the reference's is the vjp of its XLA
  ``_ref_chunked``, no Pallas kernel), which also returns the bias's
  gradient;
- **dropout** of the normalised weights, inside kernels 1-3: the
  denominator and the LSE keep the undropped P, P * keep / (1 - p) (P
  rounded after the division on the bf16 path; the Hopper routes
  multiply by f32(1 / f32(1 - p)) instead) multiplies V, and the
  backward drops dP alike; delta comes from the dropped output.  The
  keep mask is Philox4x32-10 of (seed, b, h, q, k) (``csrc/dropout.cuh``;
  plain version :func:`dropout_keep_mask`), not of a tile, so the
  backward kernels, whose tiles differ from the forward's, and a
  recomputed forward regenerate it (on the Hopper route dK/dV writes it
  for dQ to read: :func:`keep_bits_buffer`); the seed is an int64
  tensor on the device (:func:`dropout_seed` draws it from a generator,
  no host sync).
  The TPU's bits cannot be matched: parity with the reference goes
  through its injected ``test_mask``, which the plain versions take too.

The reference's checks are ported as they are (``_check_dropout_args``,
``_dropout_blocks_ok``, ``_resolve_blocks``, the full
:func:`flash_eligible`), so dispatch takes the kernels on the calls
where the reference takes its Pallas kernel.  Launches with an option
are counted by mode (``registry.spec(name).mode_launches["bias"]`` or
``["dropout"]``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build, registry

__all__ = ["flash_attention", "flash_attention_bhsd", "flash_attention_ref",
           "chunked_attention",
           "flash_attention_blockwise_ref", "flash_fwd_plan", "FwdPlan",
           "flash_bwd_plan", "BwdPlan", "BwdKernelPlan", "keep_bits_numel",
           "keep_bits_buffer",
           "flash_attention_bwd_dkv_ref", "flash_attention_bwd_dq_ref",
           "flash_attention_bwd_blockwise_ref",
           "attention_delta", "flash_eligible", "dropout_seed",
           "dropout_keep_mask", "dropout_keep_mask_cuda", "philox4x32_10",
           "CARD_TOL", "CARD_TOL_BWD", "NEG_INF"]

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


# ---------------------------------------------------------------------
# the options: the reference's checks, and the dropout keep mask
# ---------------------------------------------------------------------

def _blocks_ok(sq, sk, block_q, block_k):
    return (sq % min(block_q, sq) == 0 and sk % min(block_k, sk) == 0)


def _dropout_blocks_ok(sq, sk, block_q, block_k):
    """Shapes the reference's dropout path takes: block-divisible lengths
    and at most 256 blocks a side (its generator packs block coordinates
    into 8 bits).  The port's keep mask has no such limit; the predicate
    is kept so that dispatch and the entry points take exactly the calls
    the reference takes (copied from the reference)."""
    if not _blocks_ok(sq, sk, block_q, block_k):
        return False
    return max(sq // min(block_q, sq), sk // min(block_k, sk)) <= 256


def _resolve_blocks(sq, sk, block_q, block_k):
    """The reference's ``block_q=block_k=None`` defaults: 512, 256 from
    8,192 positions; an explicit size is kept (copied from the reference;
    the port's kernels pick their own tiles, so its default blocks only
    feed :func:`_dropout_blocks_ok`)."""
    if block_q is None:
        block_q = 256 if sq >= 8192 else 512
    if block_k is None:
        block_k = 256 if sk >= 8192 else 512
    return block_q, block_k


def _check_dropout_args(dropout_p, seed, test_mask, sq, sk, block_q,
                        block_k, bias=None):
    """The reference's checks of a dropout call."""
    if dropout_p > 0.0:
        if bias is not None:
            raise ValueError(
                "flash attention dropout does not compose with an "
                "additive bias (the fused backward has no dbias path "
                "and the fallback backward would silently ignore the "
                "dropout)")
        if seed is None and test_mask is None:
            raise ValueError(
                "flash attention dropout needs a seed (an int64 [1] tensor, "
                "see dropout_seed) or an injected test mask")
        if not _dropout_blocks_ok(sq, sk, block_q, block_k):
            raise ValueError(
                "flash attention dropout requires block-divisible "
                "sequence lengths with <=256 blocks per side (the "
                f"reference's rule), got sq={sq} sk={sk} "
                f"blocks=({block_q},{block_k})")


def flash_eligible(seq_len: int, head_dim: int, *, has_mask: bool = False,
                   dropout: float = 0.0, mask_shape=None, mask_dtype=None,
                   kv_seq_len=None) -> bool:
    """Whether attention takes the flash kernels (the reference's rule):
    head_dim 64, 128 or 256 and at least ``FLASH_MIN_SEQ`` positions; with
    dropout only without a mask and at shapes :func:`_dropout_blocks_ok`
    takes; with a mask only a vettable [B, 1, 1, S] floating row
    (``mask_shape``, ``mask_dtype``: a torch dtype).  Without the
    reference's TPU-backend test (the registry routes by device) and its
    environment override."""
    if not (head_dim in _HEAD_DIMS and seq_len >= FLASH_MIN_SEQ):
        return False
    if dropout > 0.0:
        if has_mask or mask_shape is not None:
            return False
        sk = kv_seq_len if kv_seq_len is not None else seq_len
        return _dropout_blocks_ok(seq_len, sk,
                                  *_resolve_blocks(seq_len, sk, None, None))
    if not has_mask and mask_shape is None:
        return True
    if mask_shape is None:      # a mask that cannot be vetted
        return False
    return (len(mask_shape) == 4 and mask_shape[1] == 1
            and mask_shape[2] == 1
            and (mask_dtype is None or mask_dtype.is_floating_point))


_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m):
    """(hi, lo) 32-bit halves of ``a * m`` for an int64 tensor ``a`` of
    32-bit values and a 32-bit constant ``m``: ``m`` is split into 16-bit
    halves, so no product passes 2^48."""
    lo_p, hi_p = a * (m & 0xFFFF), a * (m >> 16)
    lo = (lo_p + ((hi_p & 0xFFFF) << 16)) & _M32
    return (hi_p + (lo_p >> 16)) >> 16, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Random123's Philox4x32-10 on int64 tensors (or ints) holding 32-bit
    words, which broadcast; key words ``k0``, ``k1`` are Python ints.
    Returns the four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _threshold(p):
    """The keep threshold: kept iff the 32 bits are >= floor(p * 2^32)
    (the reference's ``_keep_mask``)."""
    return int(p * float(2 ** 32)) & _M32


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


# 2 x 2 groups of scores the plain mask computes at once
_MASK_GROUPS = 1 << 22


def dropout_keep_mask(seed, B, H, Sq, Sk, p, q0=0, k0=0, device=None):
    """The kernels' keep mask in plain PyTorch: bool [B, H, Sq, Sk], True
    where score (q0 + i, k0 + j) of head h in batch b is kept.  Its bits
    are Philox4x32-10 with key (seed & 0xffffffff, seed >> 32), counter
    (k >> 1, q >> 1, h, b) and word 2 (q & 1) + (k & 1); kept iff bits >=
    floor(p * 2^32).  ``seed``: an int or an int64 tensor (read on the
    host); ``q0``, ``k0`` select a block, which equals the same slice of
    the whole mask.  Computed in int64, a block of rows at a time."""
    s = _seed_int(seed)
    if device is None:
        device = seed.device if torch.is_tensor(seed) else "cpu"
    key = (s & _M32, (s >> 32) & _M32)
    th = _threshold(p)
    qa, ka = q0 >> 1, k0 >> 1
    nq, nk = ((q0 + Sq + 1) >> 1) - qa, ((k0 + Sk + 1) >> 1) - ka
    c0 = torch.arange(ka, ka + nk, device=device, dtype=torch.int64)
    c2 = torch.arange(H, device=device, dtype=torch.int64)[:, None, None]
    rows = max(1, _MASK_GROUPS // (H * nk))
    out = []
    for b in range(B):
        blocks = []        # [H, 2 * rows, 2 * nk] each
        for r0 in range(0, nq, rows):
            c1 = torch.arange(qa + r0, qa + min(nq, r0 + rows),
                              device=device, dtype=torch.int64)[:, None]
            x, y, z, w = philox4x32_10(c0, c1, c2, b, *key)
            even = torch.stack((x, y), dim=-1).flatten(-2)    # q even
            odd = torch.stack((z, w), dim=-1).flatten(-2)     # q odd
            blocks.append(torch.stack((even, odd), dim=-2).flatten(-3, -2)
                          >= th)
        out.append(torch.cat(blocks, dim=1))
    full = torch.stack(out)
    i0, j0 = q0 & 1, k0 & 1
    return full[:, :, i0:i0 + Sq, j0:j0 + Sk]


def dropout_seed(generator: torch.Generator) -> torch.Tensor:
    """The kernels' seed: one int64 drawn from ``generator``, a [1] tensor
    on the generator's device (no host sync; a generator restored to the
    same state draws the same seed).  The counterpart of the reference's
    ``dropout_seed(key)``."""
    return torch.randint(0, 2 ** 63 - 1, (1,), dtype=torch.int64,
                         generator=generator, device=generator.device)


def _keep_block(dropout_p, seed, test_mask, B, H, q0, nq, k0, nk, device):
    """The keep mask of queries q0 .. q0 + nq and keys k0 .. k0 + nk: the
    injected ``test_mask`` (nonzero keeps) or the generated one; None
    without dropout."""
    if not dropout_p > 0.0:
        return None
    if test_mask is not None:
        return test_mask[:, :, q0:q0 + nq, k0:k0 + nk].to(device) != 0
    return dropout_keep_mask(seed, B, H, nq, nk, dropout_p, q0=q0, k0=k0,
                             device=device)


def _keep_p(dropout_p, device):
    """f32(1 - p) as a 0-d tensor on ``device``: kept values are divided
    by it, correctly rounded as the kernels divide (PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal)."""
    return torch.full((), 1.0 - dropout_p, dtype=torch.float32,
                      device=device)


def flash_attention_ref(q, k, v, bias=None, causal=False, scale=None,
                        return_lse=False, chunk=512, dropout_p=0.0,
                        seed=None, test_mask=None):
    """Plain attention on (B, H, S, D) tensors, queries in chunks of
    ``chunk`` rows so the score block stays [B, H, chunk, Sk].  ``bias``
    ([B, 1, 1, Sk]) is added to the scaled scores; with ``dropout_p`` the
    normalised weights are dropped (the LSE keeps the undropped ones)."""
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
        if bias is not None:
            s = s + bias.float()
        if causal:
            qpos = torch.arange(q0, q0 + qc.shape[2], device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        if return_lse:
            lses.append(torch.logsumexp(s, dim=-1))
        w = torch.softmax(s, dim=-1)
        keep = _keep_block(dropout_p, seed, test_mask, B, H, q0,
                           qc.shape[2], 0, Sk, q.device)
        if keep is not None:
            w = torch.where(keep, w / _keep_p(dropout_p, q.device), 0.0)
        outs.append(torch.matmul(w, vf))
    o = torch.cat(outs, dim=2).to(q.dtype)
    return (o, torch.cat(lses, dim=2)) if return_lse else o


def _ref_chunked(q, k, v, bias, causal, scale, chunk=512):
    """Attention on (B, H, S, D) tensors with the queries in chunks, each
    chunk under its own ``torch.utils.checkpoint``: neither the forward
    nor the backward holds more than one chunk's [B, H, chunk, Sk] score
    block (without the checkpoint autograd would keep every chunk's
    softmax, as much memory as the whole score matrix).  The chunk
    divides Sq: the largest divisor up to ``chunk``, or all of Sq when
    that divisor is under 128.  The products, the masked scores (-1e30)
    and the softmax in the inputs' dtype, as the reference's einsums and
    ``jax.nn.softmax``; chunks run one after another."""
    from torch.utils.checkpoint import checkpoint
    sq, sk = q.shape[2], k.shape[2]
    kpos = torch.arange(sk, device=q.device)

    def one_chunk(qc, q0, kk, vv):
        s = torch.einsum("bhqd,bhkd->bhqk", qc * scale, kk)
        if bias is not None:
            s = s + bias.to(s.dtype)
        if causal:
            qpos = q0 + torch.arange(qc.shape[2], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, vv)

    c = min(chunk, sq)
    while c > 1 and sq % c:
        c -= 1
    chunk = c if c >= 128 else sq
    outs = [checkpoint(one_chunk, q[:, :, q0:q0 + chunk], q0, k, v,
                       use_reentrant=False) for q0 in range(0, sq, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def chunked_attention(q, k, v, bias=None, causal=False, scale=None,
                      chunk=512):
    """Memory-efficient attention on paddle-layout (B, S, H, D) tensors,
    the reference's long-sequence path where flash does not run (see
    :func:`_ref_chunked`).  Plain PyTorch: no kernel, no SDPA."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = _ref_chunked(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), bias, causal, sc, chunk=chunk)
    return out.transpose(1, 2)


def flash_attention_blockwise_ref(q, k, v, bias=None, causal=False,
                                  scale=None, block_k=64, dropout_p=0.0,
                                  seed=None, test_mask=None):
    """The Pallas kernel's online softmax in plain PyTorch, on (B, H, S, D)
    tensors: keys in blocks of ``block_k``, scores ``(q . k) * scale`` in
    f32, running max and denominator in f32, and the probabilities cast to
    the value dtype against the running max before P.V.  With bf16 inputs
    that cast rounds P as the kernel does when ``block_k`` is the
    kernel's key tile (``flash_fwd_plan(q, k, v).block_k``: 128 on the
    Hopper route, 64 on ``mma.sync``), so the bf16 kernel is held to this
    version; with f32 inputs it equals :func:`flash_attention_ref` up to
    summation order.  The options as in the kernels: the bias added to
    the scaled scores, and P * keep / (1 - p) cast before P.V while the
    denominator keeps the undropped P."""
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
        if bias is not None:
            s = s + bias[..., k0:k0 + block_k].float()
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = s.masked_fill(qpos < kpos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        keep = _keep_block(dropout_p, seed, test_mask, B, H, 0, Sq, k0,
                           kb.shape[2], q.device)
        if keep is not None:
            p = torch.where(keep, p / _keep_p(dropout_p, q.device), 0.0)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                    vb.float())
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _options_eligible(q, k, bias, dropout_p, seed, test_mask):
    """Why the kernels do not take these options on CUDA tensors, or
    None."""
    if bias is not None:
        if (not bias.is_cuda or bias.dtype != q.dtype
                or tuple(bias.shape) != (q.shape[0], 1, 1, k.shape[2])):
            return (f"bias must be a CUDA {q.dtype} [B, 1, 1, Sk] row, got "
                    f"{tuple(bias.shape)} {bias.dtype}")
    if dropout_p > 0.0:
        if not dropout_p < 1.0:
            return f"dropout_p {dropout_p} (takes 0 <= p < 1)"
        if test_mask is not None:
            return "an injected test_mask is for the plain version only"
        if (not torch.is_tensor(seed) or seed.device != q.device
                or seed.dtype != torch.int64 or seed.numel() != 1):
            return ("dropout needs its seed as an int64 [1] tensor on q's "
                    "device (dropout_seed)")
    return None


def _eligible(q, k, v, bias=None, causal=False, scale=None,
              return_lse=False, dropout_p=0.0, seed=None, test_mask=None):
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
    return _options_eligible(q, k, bias, dropout_p, seed, test_mask)


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


# the forward's Hopper route, as compiled in csrc/flash_attention_fwd.cu
# (namespace sm90, Tiles<D, bias, dropout>): 128 query rows (two
# consumer warpgroups of 64) and 128-key K/V tiles in a ring of 2 stages
# at head_dim 128, 4 at head_dim 64, 384 threads; shared memory is 1024
# bytes of alignment slack, Q, every stage of K and V and the O staging
# tile (128 x D bf16 each), beside each K stage the bias row's 128 f32
# values or half the keep mask's group words (256), and the mbarriers (8
# bytes each: 2 for Q, 4 a stage).  The grid is one block per SM at
# most; each block loops over its share of the (query tile, head, batch)
# work items.
_SM90_FWD_STAGES = {128: 2, 64: 4}


def _sm90_fwd(D, bias=False, dropout=False):
    stages = _SM90_FWD_STAGES[D]
    tile = 128 * D * 2
    side = 128 * 4 if bias else 256 * 4 if dropout else 0
    return dict(block_q=128, block_k=128, stages=stages, threads=384,
                smem_bytes=1024 + tile * (2 + 2 * stages) + stages * side
                + 8 * (2 + 4 * stages))


# the forward's f32 route, as compiled in csrc/flash_attention_fwd.cu
# (namespace tf32, Tiles<D>): 64 query rows (four warps of 16) against
# key tiles of 64 at head_dim 64 and 32 above, in a ring of 2 stages
# filled by cp.async; 128 threads.  Shared memory (f32): above head_dim
# 64 Q (64 rows of D + 16; at 64 Q's fragments stay in registers), then
# each stage's K (rows of D + 16), V (rows of D + 4) and, with the bias
# row, its key tile's values.  One block per (query tile, head, batch).
def _tf32x3_fwd(D, bias=False):
    bk = 64 if D == 64 else 32
    q = 0 if D == 64 else 64 * (D + 16)
    stage = bk * ((D + 16) + (D + 4)) + (bk if bias else 0)
    return dict(block_q=64, block_k=bk, stages=2, threads=128,
                smem_bytes=4 * (q + 2 * stage))


# SMs of an H100 SXM: the grid's bound where no card is at hand to ask
H100_SMS = 132


def _sm_count(device):
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel runs on given q, k, v (B, H, S, D)."""

    route: str          # "tma_wgmma" (bf16: D=64, D=128 without an
                        # option), "mma_sync" (other bf16) or "tf32x3"
                        # (f32)
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


def flash_fwd_plan(q, k, v, bias=None, dropout_p=0.0):
    """The launch plan of the forward kernel for (B, H, S, D) q, k, v:
    the route, tiles, grid and, on the Hopper route, the TMA strides.
    bf16 takes the Hopper route at head_dim 64, with or without the bias
    row or dropout, and at head_dim 128 without them (with one the
    ``mma.sync`` route takes head_dim 128, and head_dim 256 always); f32
    the 3xTF32 route.  A tensor it cannot take as is (``as_is`` False) is
    made row-major by :func:`_rowmajor` first, never sent to the other
    kernel.  Pure shape arithmetic: it runs on CPU tensors too."""
    B, H, Sq, D = q.shape
    opts = bias is not None or dropout_p > 0.0
    as_is = {n: _takes_as_is(t) for n, t in (("q", q), ("k", k), ("v", v))}
    if q.dtype == torch.bfloat16 and (D == 64 or (D == 128 and not opts)):
        cfg = _sm90_fwd(D, bias is not None, dropout_p > 0.0)
        route, bq, bk, stages, threads, smem = (
            "tma_wgmma", cfg["block_q"], cfg["block_k"], cfg["stages"],
            cfg["threads"], cfg["smem_bytes"])
        # q, k, v as given; o as the wrapper allocates it, (B, Sq, H, D)
        tma = tuple(x for t in (q, k, v) for x in _tma_strides(t)) + (
            H * D * 2, D * 2, Sq * H * D * 2)
    elif q.dtype == torch.bfloat16:
        route, bq, bk, stages, threads = "mma_sync", 64, 64, 1, 128
        # with an option: the tile's bias row, f32
        smem = (bq + 2 * bk) * (D + 8) * 2 + (bk * 4 if opts else 0)
        tma = ()
    else:
        cfg = _tf32x3_fwd(D, bias is not None)
        route, bq, bk, stages, threads, smem = (
            "tf32x3", cfg["block_q"], cfg["block_k"], cfg["stages"],
            cfg["threads"], cfg["smem_bytes"])
        tma = ()
    n_qt = -(-Sq // bq)
    if route == "tma_wgmma":
        grid = (min(n_qt * H * B, _sm_count(q.device)), 1, 1)
    else:
        grid = (n_qt, H, B)
    return FwdPlan(route, bq, bk, stages, threads, smem, grid, tma, as_is)


def _option_args(dropout_p, seed):
    """The C entries' dropout arguments: seed pointer (None: no
    dropout), keep threshold, f32(1 - p)."""
    if not dropout_p > 0.0:
        return None, 0, 1.0
    return seed.data_ptr(), _threshold(dropout_p), 1.0 - dropout_p


def _inv_keep_p(dropout_p):
    """f32(1 / f32(1 - p)), the factor the forward's Hopper route
    multiplies kept values by (1 without dropout)."""
    if not dropout_p > 0.0:
        return 1.0
    one = torch.ones((), dtype=torch.float32)
    return float(one / torch.full((), 1.0 - dropout_p, dtype=torch.float32))


def _flash_fwd_cuda(q, k, v, bias=None, causal=False, scale=None,
                    return_lse=False, dropout_p=0.0, seed=None,
                    test_mask=None):
    q, k, v = _rowmajor(q), _rowmajor(k), _rowmajor(v)
    if bias is not None and bias.stride(-1) != 1:
        bias = bias.contiguous()
    plan = flash_fwd_plan(q, k, v, bias=bias, dropout_p=dropout_p)
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
                # q, k, v, o, lse; B, H, Hkv, Sq, Sk; TMA strides; plan;
                # causal, scale, D; bias and its batch stride; seed,
                # threshold, 1 / (1 - p); stream
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p, ctypes.c_uint,
                                  ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            launch = (plan.block_q, plan.block_k, plan.stages, plan.threads,
                      plan.smem_bytes, *plan.grid)
            seed_ptr, thresh, _ = _option_args(dropout_p, seed)
            rc = fn(*ptrs, B, H, Hkv, Sq, Sk,
                    (ctypes.c_longlong * 12)(*plan.tma_strides),
                    (ctypes.c_int * 8)(*launch), int(bool(causal)),
                    float(sc), D,
                    bias.data_ptr() if bias is not None else None,
                    bias.stride(0) if bias is not None else 0,
                    seed_ptr, thresh, _inv_keep_p(dropout_p), stream)
        else:
            fn = lib.flash_attention_fwd
            if fn.argtypes is None:
                # q, k, v, o, lse; B, H, Hkv, Sq, Sk, D; bias and its batch
                # stride; seed, threshold, 1 - p; strides; causal, scale,
                # is_bf16, stream
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p, ctypes.c_uint,
                                  ctypes.c_float]
                               + [ctypes.c_longlong] * 12
                               + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
            rc = fn(*ptrs, B, H, Hkv, Sq, Sk, D,
                    bias.data_ptr() if bias is not None else None,
                    bias.stride(0) if bias is not None else 0,
                    *_option_args(dropout_p, seed),
                    q.stride(0), q.stride(1), q.stride(2),
                    k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    o.stride(0), o.stride(1), o.stride(2),
                    int(bool(causal)), float(sc),
                    int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, f"flash_attention_fwd ({plan.route}) "
                          f"q={tuple(q.shape)} k={tuple(k.shape)} {q.dtype}")
    registry.note_launch(_SPEC, _launch_mode(bias, dropout_p))
    return (o, lse) if return_lse else o


def _launch_mode(bias, dropout_p):
    """The mode a launch is counted under: "bias", "dropout" or None."""
    return ("bias" if bias is not None
            else "dropout" if dropout_p > 0.0 else None)


def dropout_keep_mask_cuda(seed, B, H, Sq, Sk, p, q0=0, k0=0):
    """The kernels' keep mask from the device header's debug entry
    (``flash_dropout_keep_mask`` in ``csrc/flash_attention_fwd.cu``), one
    element a thread: bool [B, H, Sq, Sk] on ``seed``'s card.  Not on a
    model's path: the card checks hold it bitwise against
    :func:`dropout_keep_mask`."""
    if not (torch.is_tensor(seed) and seed.is_cuda
            and seed.dtype == torch.int64 and seed.numel() == 1):
        raise ValueError("dropout_keep_mask_cuda needs an int64 [1] CUDA "
                         "seed tensor")
    out = torch.empty((B, H, Sq, Sk), dtype=torch.uint8, device=seed.device)
    lib = _build.load(_SOURCE)
    fn = lib.flash_dropout_keep_mask
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        rc = fn(seed.data_ptr(), B, H, Sq, Sk, q0, k0, _threshold(p),
                out.data_ptr(), stream)
    _build.check(lib, rc, f"flash_dropout_keep_mask B={B} H={H} Sq={Sq} "
                          f"Sk={Sk}")
    return out.bool()


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
        "not, GQA by head index; optional [B, 1, 1, Sk] bias row or "
        "in-kernel dropout",
)


# ---------------------------------------------------------------------
# backward: plain versions
# ---------------------------------------------------------------------

def attention_delta(o, do):
    """``rowsum(dO * O)`` in f32, [B, H, Sq]: the backward's per-row
    correction (plain PyTorch, as the reference computes it in XLA)."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_chunked(q, k, v, do, lse, delta, causal, scale, want, round_p,
                 chunk=512, dropout_p=0.0, seed=None, test_mask=None,
                 bias=None):
    """FlashAttention-2's backward from the saved LSE, queries in chunks
    of ``chunk`` rows against all keys, in f32.  ``round_p`` rounds P and
    dS to the input dtype before their products, as the kernels do (the
    rounding is per element against the final LSE, so the chunking does
    not change what is rounded).  With dropout the forward's mask is
    regenerated: dV takes P * keep / (1 - p), dP is dropped alike, and
    dS = P (dP - delta) scale keeps the undropped P.  ``bias`` (a row
    that broadcasts to [B, 1, 1, Sk]) is added to the scaled scores, as
    the forward added it (its LSE includes it).  Returns the f32
    gradients named in ``want`` ("dq", "dk", "dv", "dbias"), dk/dv summed
    over each kv head's group of query heads, dbias ([B, 1, 1, Sk]: the
    sum of P (dP - delta) over heads and queries) over nothing else."""
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
    db = (torch.zeros((B, 1, 1, Sk), device=dev) if "dbias" in want
          else None)
    for q0 in range(0, Sq, chunk):
        qc = q[:, :, q0:q0 + chunk].float()
        doc = do[:, :, q0:q0 + chunk].float()
        s = torch.matmul(qc, kf.transpose(-1, -2)) * sc
        if bias is not None:
            s = s + bias.float()
        if causal:
            qpos = torch.arange(q0, q0 + qc.shape[2], device=dev)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        p = torch.exp(s - lse[:, :, q0:q0 + chunk, None])
        del s
        keep = _keep_block(dropout_p, seed, test_mask, B, H, q0,
                           qc.shape[2], 0, Sk, dev)
        if keep is not None:
            kp = _keep_p(dropout_p, dev)
        if dv is not None:
            pd = p if keep is None else torch.where(keep, p / kp, 0.0)
            dv += torch.matmul(rnd(pd).transpose(-1, -2), doc)
            del pd
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        if keep is not None:
            dp = torch.where(keep, dp / kp, 0.0)
        ds = p * (dp - delta[:, :, q0:q0 + chunk, None])
        del p, dp
        if db is not None:
            db += ds.sum(dim=(1, 2), keepdim=True)
        ds = rnd(ds * sc)
        if "dq" in want:
            dqs.append(torch.matmul(ds, kf))
        if dk is not None:
            dk += torch.matmul(ds.transpose(-1, -2), qc)
    out = {}
    if dqs:
        out["dq"] = torch.cat(dqs, dim=2)
    if db is not None:
        out["dbias"] = db
    for name, g in (("dk", dk), ("dv", dv)):
        if g is not None:
            out[name] = g.view(B, Hkv, R, Sk, D).sum(dim=2) if R != 1 else g
    return out


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False,
                                scale=None, dropout_p=0.0, seed=None,
                                test_mask=None, keep_bits_out=None):
    """Plain dK, dV (input dtype) from the saved LSE and ``delta``:
    chunked f32, P and dS unrounded.  ``keep_bits_out`` (the kernel's
    output of its keep mask for dQ) is not written: the plain versions
    regenerate the mask."""
    g = _bwd_chunked(q, k, v, do, lse, delta, causal, scale, ("dk", "dv"),
                     round_p=False, dropout_p=dropout_p, seed=seed,
                     test_mask=test_mask)
    return g["dk"].to(k.dtype), g["dv"].to(v.dtype)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=False,
                               scale=None, dropout_p=0.0, seed=None,
                               test_mask=None, keep_bits=None):
    """Plain dQ (input dtype) from the saved LSE and ``delta``: chunked
    f32, P and dS unrounded.  ``keep_bits`` (the mask dK/dV's kernel
    wrote) is not read: the plain version regenerates the mask."""
    g = _bwd_chunked(q, k, v, do, lse, delta, causal, scale, ("dq",),
                     round_p=False, dropout_p=dropout_p, seed=seed,
                     test_mask=test_mask)
    return g["dq"].to(q.dtype)


def flash_attention_bwd_blockwise_ref(q, k, v, do, lse, delta, causal=False,
                                      scale=None, dropout_p=0.0, seed=None,
                                      test_mask=None):
    """The Pallas backward kernels' arithmetic in plain PyTorch: P and dS
    rounded to the input dtype before their products, f32 sums.  With
    bf16 inputs the bf16 kernels are held to this version; with f32
    inputs it equals the chunked plain versions.  Returns (dq, dk, dv)."""
    g = _bwd_chunked(q, k, v, do, lse, delta, causal, scale,
                     ("dq", "dk", "dv"), round_p=True, dropout_p=dropout_p,
                     seed=seed, test_mask=test_mask)
    return g["dq"].to(q.dtype), g["dk"].to(k.dtype), g["dv"].to(v.dtype)


# ---------------------------------------------------------------------
# backward: kernels
# ---------------------------------------------------------------------

def _bwd_eligible(q, k, v, do, lse, delta, causal=False, scale=None,
                  dropout_p=0.0, seed=None, test_mask=None, keep_bits=None,
                  keep_bits_out=None):
    reason = _eligible(q, k, v, dropout_p=dropout_p, seed=seed,
                       test_mask=test_mask)
    if reason:
        return reason
    for bits in (keep_bits, keep_bits_out):
        if bits is not None and (
                bits.device != q.device or bits.dtype != torch.int32
                or bits.numel() != keep_bits_numel(q, k)):
            return (f"keep bits must be a {keep_bits_numel(q, k)}-element "
                    f"int32 tensor on {q.device} (keep_bits_numel), got "
                    f"{bits.numel()} {bits.dtype} on {bits.device}")
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


# the backward's Hopper route, as compiled in csrc/flash_attention_bwd.cu
# (namespace sm90, Tiles<D>): a work item holds 128 resident rows (keys
# for dK/dV, query rows for dQ) in two consumer warpgroups of 64 and
# streams 64-row tiles of the other pair through a ring of 2 stages at
# head_dim 128, 4 at head_dim 64, 384 threads; shared memory is 1024
# bytes of alignment slack, two buffers of the resident pair (128 x D
# bf16 a tile), every stage of the streamed pair (64 x D a tile), 2 KB
# of LSE and delta rows, at head_dim 64 the keep mask's 256 group words
# a stage, and the mbarriers (8 bytes each: 4 for the resident buffers,
# 2 a stage).
_SM90_BWD_STAGES = {128: 2, 64: 4}


def _sm90_bwd(D):
    stages = _SM90_BWD_STAGES[D]
    return dict(block_res=128, block_str=64, stages=stages, threads=384,
                smem_bytes=1024 + 4 * 128 * D * 2 + stages * 2 * 64 * D * 2
                + 2048 + (stages * 1024 if D == 64 else 0)
                + 8 * (4 + 2 * stages))


@dataclasses.dataclass(frozen=True)
class BwdKernelPlan:
    """How one backward kernel (dK/dV or dQ) runs."""

    block_res: int      # rows an item keeps: keys (dK/dV), queries (dQ)
    block_str: int      # rows a streamed tile holds: queries, keys
    stages: int         # streamed tiles in flight (1: loaded synchronously)
    threads: int        # per block
    smem_bytes: int     # dynamic shared memory per block
    grid: tuple         # (x, y, z) as launched
    items: int          # work items: (resident tile, head, batch)
    tiles: int          # streamed tiles over all items (the causal skip)
    # tma_wgmma only: the byte strides (seq, head, batch) of q, k, v, dO
    # and the outputs (dK, dV or dQ), as their tensor maps take them
    tma_strides: tuple


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward kernels run on given q, k, v, dO (B, H, S, D)."""

    route: str          # "tma_wgmma" (bf16: D=64, D=128 without
                        # dropout), "mma_sync" (other bf16) or "fma" (f32)
    dkv: BwdKernelPlan
    dq: BwdKernelPlan
    # per tensor: taken where it lies (else _rowmajor copies it first)
    as_is: dict


def _bwd_tiles(n_res, block_res, block_str, n_other, causal, dkv, heads,
               R, B):
    """Streamed tiles summed over the work items: dK/dV walks the query
    tiles from its diagonal (of each of the R heads of its group), dQ the
    key tiles up to its diagonal."""
    tiles = 0
    for rt in range(n_res):
        r0 = rt * block_res
        if dkv:
            n_qt = -(-n_other // block_str)
            first = min(r0 // block_str, n_qt) if causal else 0
            tiles += R * (n_qt - first)
        else:
            end = min(n_other, r0 + block_res) if causal else n_other
            tiles += -(-end // block_str)
    return tiles * heads * B


def flash_bwd_plan(q, k, v, do, causal=False, dropout_p=0.0):
    """The launch plans of both backward kernels for (B, H, S, D) q, k,
    v, dO: the route, tiles, stages, grid, work and, on the Hopper route,
    the TMA strides.  bf16 takes the Hopper route at head_dim 64, with
    or without dropout, and at head_dim 128 without it (with dropout the
    ``mma.sync`` route takes head_dim 128, dK/dV with 64 keys a block,
    and head_dim 256 always); a tensor it cannot take as is (``as_is``
    False) is made row-major by :func:`_rowmajor` first, never sent to
    the other kernels.  Pure shape arithmetic: it runs on CPU tensors
    too."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    R = H // Hkv
    as_is = {n: _takes_as_is(t)
             for n, t in (("q", q), ("k", k), ("v", v), ("do", do))}
    elt = q.element_size()
    plans = {}
    for name, n_res, heads, n_other in (("dkv", Sk, Hkv, Sq),
                                         ("dq", Sq, H, Sk)):
        dkv = name == "dkv"
        if q.dtype == torch.bfloat16 and (
                D == 64 or (D == 128 and not dropout_p > 0.0)):
            route = "tma_wgmma"
            t = _sm90_bwd(D)
            br, bs, stages, threads, smem = (
                t["block_res"], t["block_str"], t["stages"], t["threads"],
                t["smem_bytes"])
            # q, k, v, dO as given; the outputs as the wrappers allocate
            # them, (B, S, heads, D)
            outs = ((Sk, Hkv), (Sk, Hkv)) if dkv else ((Sq, H),)
            tma = tuple(x for t in (q, k, v, do) for x in _tma_strides(t))
            for s, h in outs:
                tma += (h * D * elt, D * elt, s * h * D * elt)
        elif q.dtype == torch.bfloat16:
            route, bs, stages, threads, tma = "mma_sync", 64, 1, 128, ()
            if dkv:
                br = 64 if D <= 128 else 32
                smem = (2 * br + 2 * bs) * (D + 8) * 2 + 2 * bs * 4
            else:
                br = 64
                smem = (2 * br + 2 * bs) * (D + 8) * 2
        else:
            route, br, bs, stages, threads, tma = "fma", 32, 32, 1, 128, ()
            smem = (2 * br * D + 2 * bs * (D + 1) + (2 if dkv else 1)
                    * 4 * 8 * bs + (2 * bs if dkv else 0)) * 4
        n_rt = -(-n_res // br)
        items = n_rt * heads * B
        grid = ((min(items, _sm_count(q.device)), 1, 1)
                if route == "tma_wgmma" else (n_rt, heads, B))
        tiles = _bwd_tiles(n_rt, br, bs, n_other, causal, dkv, heads,
                           R if dkv else 1, B)
        plans[name] = BwdKernelPlan(br, bs, stages, threads, smem, grid,
                                    items, tiles, tma)
    return BwdPlan(route, plans["dkv"], plans["dq"], as_is)


def keep_bits_numel(q, k):
    """int32 words of the keep mask dK/dV's Hopper kernel writes for dQ
    (``keep_bits_out`` / ``keep_bits``): 128 group words for each 64 x 64
    (query block, key block) of each (batch, query head), B H Sq Sk / 32
    at multiples of 64."""
    B, H, Sq = q.shape[:3]
    Sk = k.shape[2]
    return B * H * -(-Sq // 64) * -(-Sk // 64) * 128


def keep_bits_buffer(q, k, v, do, causal, dropout_p, seed, mode):
    """The keep-mask buffer a backward with dropout on the Hopper route
    passes from dK/dV to dQ (dQ then reads the mask instead of
    regenerating it), or None: no dropout, CPU tensors, the plain
    versions, or another route."""
    if (not dropout_p > 0.0 or seed is None or not q.is_cuda
            or mode == "torch_ref"
            or flash_bwd_plan(q, k, v, do, causal,
                              dropout_p=dropout_p).route != "tma_wgmma"):
        return None
    return torch.empty(keep_bits_numel(q, k), dtype=torch.int32,
                       device=q.device)


def _bwd_launch(kernel, spec, q, k, v, do, lse, delta, outs, causal, scale,
                dropout_p=0.0, seed=None, keep_bits=None):
    """Launch backward ``kernel`` ("dkv" or "dq") on row-major q, k, v,
    dO (:func:`_rowmajor`) and contiguous lse, delta, into ``outs``:
    (dk, dv) or (dq,).  ``keep_bits``: on the Hopper route with dropout,
    the keep mask dK/dV writes (optional) and dQ reads (required)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    plan = flash_bwd_plan(q, k, v, do, causal, dropout_p=dropout_p)
    kplan = getattr(plan, kernel)
    lib = _build.load(_BWD_SOURCE)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta) + tuple(outs)]
    if plan.route == "tma_wgmma":
        if kernel == "dq" and dropout_p > 0.0 and keep_bits is None:
            raise ValueError(
                f"flash_attention_bwd_dq q={tuple(q.shape)} {q.dtype} with "
                f"dropout on the Hopper route reads the keep mask "
                f"flash_attention_bwd_dkv wrote: pass keep_bits")
        entry = f"flash_attention_bwd_{kernel}_sm90"
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # q, k, v, dO, lse, delta, the outputs; B, H, Hkv, Sq, Sk;
            # TMA strides; plan; causal, scale, D; seed, threshold,
            # 1 - p; keep bits; stream
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                           + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        launch = (kplan.block_res, kplan.block_str, kplan.stages,
                  kplan.threads, kplan.smem_bytes, *kplan.grid)
        args = (B, H, Hkv, Sq, Sk,
                (ctypes.c_longlong * len(kplan.tma_strides))(
                    *kplan.tma_strides),
                (ctypes.c_int * 8)(*launch), int(bool(causal)), float(sc),
                D, *_option_args(dropout_p, seed),
                keep_bits.data_ptr() if keep_bits is not None
                and dropout_p > 0.0 else None)
    else:
        entry = f"flash_attention_bwd_{kernel}"
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # q, k, v, dO, lse, delta, the outputs; B, H, Hkv, Sq, Sk, D;
            # seed, threshold, 1 - p; strides; causal, scale, is_bf16,
            # stream
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                           + [ctypes.c_int] * 6
                           + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_float]
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        # element strides (batch, head, seq) of q, k, v, dO, dq, dk, dv
        full = (None, *outs) if kernel == "dkv" else (*outs, None, None)
        strides = []
        for t in (q, k, v, do) + full:
            strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
        args = (B, H, Hkv, Sq, Sk, D, *_option_args(dropout_p, seed),
                (ctypes.c_longlong * 21)(*strides),
                int(bool(causal)), float(sc), int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, *args, stream)
    _build.check(lib, rc, f"{entry} q={tuple(q.shape)} k={tuple(k.shape)} "
                          f"{q.dtype}")
    registry.note_launch(spec, _launch_mode(None, dropout_p))


def _like_bshd(t):
    """An empty (B, H, S, D) tensor laid out as (B, S, H, D) memory, so
    that the gradient of a transposed (B, S, H, D) input is contiguous
    once transposed back."""
    B, H, S, D = t.shape
    return torch.empty((B, S, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                  dropout_p=0.0, seed=None, test_mask=None,
                  keep_bits_out=None):
    q, k, v, do = (_rowmajor(t) for t in (q, k, v, do))
    dk, dv = _like_bshd(k), _like_bshd(v)
    _bwd_launch("dkv", _DKV_SPEC, q, k, v, do, lse.contiguous(),
                delta.contiguous(), (dk, dv), causal, scale, dropout_p, seed,
                keep_bits_out)
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                 dropout_p=0.0, seed=None, test_mask=None, keep_bits=None):
    q, k, v, do = (_rowmajor(t) for t in (q, k, v, do))
    dq = _like_bshd(q)
    _bwd_launch("dq", _DQ_SPEC, q, k, v, do, lse.contiguous(),
                delta.contiguous(), (dq,), causal, scale, dropout_p, seed,
                keep_bits)
    return dq


_DKV_SPEC = registry.register(
    "flash_attention_bwd_dkv", _bwd_dkv_cuda, flash_attention_bwd_dkv_ref,
    tolerance=_TOLERANCE,
    eligible=_bwd_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas/flash_attention.py:208",
    doc="flash attention backward dK, dV from the saved LSE and delta; "
        "GQA sums the group's query heads in the kernel; optional "
        "in-kernel dropout (the forward's mask regenerated)",
)

_DQ_SPEC = registry.register(
    "flash_attention_bwd_dq", _bwd_dq_cuda, flash_attention_bwd_dq_ref,
    tolerance=_TOLERANCE,
    eligible=_bwd_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas/flash_attention.py:258",
    doc="flash attention backward dQ from the saved LSE and delta; "
        "optional in-kernel dropout (the forward's mask regenerated)",
)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the FlashAttention-2 backward (counterpart of
    the reference's ``_fa_impl`` custom vjp).  The forward keeps q, k,
    v, o, the LSE and the options (the dropout seed, not a mask); under
    activation checkpointing the recompute's forward saves them anew, and
    the backward reads those.  With a bias the backward is the plain
    chunked one from the saved LSE (:func:`_bwd_chunked`, which also
    gives the bias's gradient), as the reference's is the vjp of its XLA
    composition."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, test_mask, causal, scale,
                dropout_p, mode):
        opts = dict(dropout_p=dropout_p, seed=seed, test_mask=test_mask)
        o, lse = registry.dispatch("flash_attention", q, k, v, bias=bias,
                                   causal=causal, scale=scale,
                                   return_lse=True, mode=mode, **opts)
        ctx.save_for_backward(q, k, v, o, lse, bias, seed, test_mask)
        ctx.causal, ctx.scale, ctx.mode = causal, scale, mode
        ctx.dropout_p = dropout_p
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias, seed, test_mask = ctx.saved_tensors
        delta = attention_delta(o, do)
        if bias is not None:
            want = ("dq", "dk", "dv") + (
                ("dbias",) if ctx.needs_input_grad[3] else ())
            g = _bwd_chunked(q, k, v, do, lse, delta, ctx.causal, ctx.scale,
                             want, round_p=False, bias=bias)
            db = g.get("dbias")
            return (g["dq"].to(q.dtype), g["dk"].to(k.dtype),
                    g["dv"].to(v.dtype),
                    db.to(bias.dtype) if db is not None else None,
                    None, None, None, None, None, None)
        kw = dict(causal=ctx.causal, scale=ctx.scale, mode=ctx.mode,
                  dropout_p=ctx.dropout_p, seed=seed, test_mask=test_mask)
        # with dropout on the Hopper route dK/dV writes its keep mask and
        # dQ reads it; the buffer lives for this backward only
        bits = (None if test_mask is not None else keep_bits_buffer(
            q, k, v, do, ctx.causal, ctx.dropout_p, seed, ctx.mode))
        dk, dv = registry.dispatch("flash_attention_bwd_dkv", q, k, v, do,
                                   lse, delta, keep_bits_out=bits, **kw)
        dq = registry.dispatch("flash_attention_bwd_dq", q, k, v, do, lse,
                               delta, keep_bits=bits, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_bhsd(q, k, v, bias=None, seed=None, test_mask=None,
                         causal=False, scale=None, dropout_p=0.0,
                         return_lse=False, mode=None):
    """Flash attention on (B, H, S, D) tensors (k/v may have fewer heads:
    grouped-query attention).  Returns ``o`` or ``(o, lse)``.
    Differentiable in q, k, v and ``bias`` (through
    :class:`_FlashAttention`).

    ``bias``: an additive row (padding masks) that broadcasts to [B, 1, 1,
    Sk], in q's dtype on the kernel path; a row shared by the batch is
    read in place (batch stride 0).  ``dropout_p`` drops the normalised weights inside
    the kernels, the keep mask regenerated from ``seed`` (an int64 [1]
    tensor, :func:`dropout_seed`); ``test_mask`` (a full [B, H, Sq, Sk]
    keep mask) replaces the generated one in the plain versions, for
    parity with the reference.  Dropout is taken at the shapes the
    reference's default blocks take (:func:`_check_dropout_args`)."""
    sq, sk = q.shape[2], k.shape[2]
    _check_dropout_args(dropout_p, seed, test_mask, sq, sk,
                        *_resolve_blocks(sq, sk, None, None), bias)
    if bias is not None:
        try:
            bias = bias.expand(q.shape[0], 1, 1, sk)
        except RuntimeError:
            raise ValueError(
                f"flash attention takes a bias row that broadcasts to "
                f"[B, 1, 1, Sk], got {tuple(bias.shape)} for q "
                f"{tuple(q.shape)}") from None
    opts = dict(bias=bias, dropout_p=dropout_p, seed=seed,
                test_mask=test_mask)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        o, lse = _FlashAttention.apply(q, k, v, bias, seed, test_mask,
                                       causal, scale, dropout_p, mode)
        return (o, lse) if return_lse else o
    return registry.dispatch("flash_attention", q, k, v, causal=causal,
                             scale=scale, return_lse=return_lse, mode=mode,
                             **opts)


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    mode=None, dropout_p=0.0, seed=None):
    """Flash attention on paddle-layout (B, S, H, D) tensors; ``bias``
    stays [B, 1, 1, Sk]."""
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), bias=bias, seed=seed,
                             causal=causal, scale=scale, dropout_p=dropout_p,
                             mode=mode)
    return o.transpose(1, 2)
