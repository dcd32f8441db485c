"""Int8 paged decode/verify attention: the Hopper kernel and its plain
version.

Counterpart of ``paddle_tpu/ops/pallas/kv_attention.py`` (kernel 4,
``_int8_kv_attn_kernel``).  K/V live in int8 pools [nb, bs, KH, D] with
per-(block, slot) f32 scales [nb, bs]; each sequence's block table row
maps logical block ``pos // bs`` to a physical pool block.  A slot is
valid iff ``slot <= position``; a masked slot adds an exact 0.

Every call, whatever S -- a decode or draft step (S = 1), a speculative
verify block, a prefix-sharing suffix prefill of up to
``max_model_len`` rows -- takes one kernel (``csrc/int8_kv_attention.cu``,
``int8_kv_rows``), so a query row has one arithmetic.  The S*R query
rows of a kv head are tiled over the grid in 16-row slabs, 1, 2, 4 or 8
a block, so no S is too large.  Keys come in 64-slot tiles at fixed
absolute slots from slot 0, gathered through the table by ``cp.async``
into a ring of int8 tiles and converted once a block into exact bf16
codes in shared memory.  Scores and P.V run on the tensor cores
(``mma.sync`` bf16 with f32 sums): a bf16 query and a code are exact in
bf16; an f32 query is split into three bf16 pieces and P * v_scale into
two, each piece a product of its own.  The keys are cut into chunks of
``KV_ROW_CHUNK`` absolute slots (four key tiles).  Each chunk's state
(m, l, acc) starts fresh, and a row's result is its chunks' states
folded in chunk order by one formula (:func:`_fold`), in the block that
computed them or, where a row tile's chunks are spread over blocks
(``KvRowsPlan.chunks_a_block``: decode steps and verify blocks), in the
last of those blocks, read back from a workspace the wrapper keeps per
device and stream (grown, never shrunk: a steady decode step allocates
nothing; where a block folds its chunks itself, its running acc lives
in the workspace too).  What bounds it: the bf16 tensor-core rate at a
prefill, the int8 K/V's bytes at a verify block or a decode step; it
runs latency-bound, each part of a tile's chain (the loads, the
conversion, the products) adding to its time (PERF.md section 6).
The first fold and the fold of a chunk wholly past a row's position are
exact identities, and every operation of a row runs in an order fixed
by the fragment layout alone, so a row's output bits depend only on its
q, its position and its sequence's blocks -- not on S, the batch, the
suffix's start, the row tile it lands in or the split (a decode step, a
cold prefill, a warm suffix prefill and a verify block agree bitwise
where they overlap, and speculative decoding emits what plain decode
emits).  :func:`int8_kv_plan` gives the launch's tiles, ring, split,
grid, shared memory and workspace from the shape alone; it is pure
arithmetic.

:func:`paged_attention_ref` is a line-for-line port of the reference's
``paged_attention_ref`` (the gather/dequant/attend path); it is the
plain version and the oracle.  :func:`paged_attention_rows_ref` runs the
kernel's order of operations in plain PyTorch.  Documented tolerance:
atol 2e-5 / rtol 1e-4 (the online softmax and the chunk folds
re-associate the f32 sums; the dequant itself is exact).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build, registry
from .flash_attention import H100_SMS, _sm_count

__all__ = ["paged_attention_ref", "paged_attention_rows_ref",
           "int8_paged_attention", "int8_kv_plan", "KvRowsPlan",
           "KV_ROW_KEYS", "KV_ROW_CHUNK", "CARD_TOL"]

_SOURCE = "int8_kv_attention.cu"
_HEAD_DIMS = (64, 128, 256)
# The kernel against its plain version on the card, as (atol, rtol, row)
# in the form of flash_attention.CARD_TOL: the registered tolerance for
# f32; for bf16 one rounding of the bf16 output (rtol 2**-7), the f32
# work in between being the same
CARD_TOL = {torch.float32: (2e-5, 1e-4, 0.0),
            torch.bfloat16: (1e-4, 8e-3, 0.0)}

# The kernel's dynamic shared memory a block at most, and the shared
# memory of an SM (each block also takes 1,024 bytes)
_SMEM_LIMIT, _SM_SMEM = 232_448, 233_472
# The key tile (slots, at absolute slots 64 t ..) and its chunk (slots, at absolute slots 256 c ..: four key tiles)
KV_ROW_KEYS, KV_ROW_CHUNK = 64, 256
_ROW_THREADS = 128   # threads a block below 8 slabs


class KvRowsPlan(NamedTuple):
    """How the kernel runs one call."""

    q_tile: int         # query rows a block: 16 a slab
    warps: int          # 16-row slabs a block, 1, 2, 4 or 8 (a slab's
    #                     dims split over 4 / warps warps below 8)
    key_tile: int       # slots a key tile (KV_ROW_KEYS)
    chunk: int          # slots a chunk (KV_ROW_CHUNK)
    q_pieces: int       # bf16 pieces of a query: 1 (bf16), 3 (f32)
    stages: int         # int8 key tiles in the cp.async ring
    threads: int        # 256 with 8 slabs, else 128
    smem_bytes: int     # dynamic shared memory a block
    chunks: int         # chunks of the table: ceil(M * bs / chunk)
    chunks_a_block: int  # consecutive chunks of a row tile one block runs
    grid: Tuple[int, int, int]   # (row tiles * chunk groups, KH, B)
    ws_floats: int      # f32 chunk states when split, else running accs
    #                     where the table has more than one chunk
    tickets: int        # int32 tickets when split (one a row tile), else 0

    @property
    def route(self) -> str:
        return "rows"

    def launch(self) -> tuple:
        """The seven ints ``int8_kv_attention_rows`` takes."""
        return (self.q_tile, self.stages, self.threads, self.smem_bytes,
                self.chunks, self.chunks_a_block, self.grid[0])


def _rows_smem(D, warps, pieces, stages):
    """``rows_layout(D, warps, pieces, stages).total`` of the kernel: the
    ring's stages (K and V codes [64][D] int8, their two scale rows), the
    converted tile (bf16 K and V [64][D + 8], two scale rows), the
    queries' bf16 pieces [pieces][16 warps][D + 8] (none where a bf16
    query of head_dim <= 128 stays in registers) and 16 bytes."""
    q = 0 if pieces == 1 and D <= 128 else pieces * 32 * warps * (D + 8)
    return (stages * (2 * KV_ROW_KEYS * D + 8 * KV_ROW_KEYS)
            + 4 * KV_ROW_KEYS * (D + 8) + 8 * KV_ROW_KEYS + q + 16)


def _rows_plan(B, S, H, KH, D, bs, M, sm_count, pieces,
               chunks_a_block=None):
    SR = S * (H // KH)
    warps = 8 if SR > 64 else 4 if SR > 32 else 2 if SR > 16 else 1
    if D == 256:
        warps = min(warps, 2)
    threads = 2 * _ROW_THREADS if warps == 8 else _ROW_THREADS

    # registers a thread at most, as the kernel's launch bounds allow: a
    # one-slab block below head_dim 256 asks for three blocks an SM
    regs = 168 if warps == 1 and D <= 128 else 256

    def per_sm(smem):
        return min(_SM_SMEM // (smem + 1024), 2048 // threads,
                   65536 // (regs * threads), 32)

    # the deepest ring that keeps the blocks an SM of a two-stage one
    fit = per_sm(_rows_smem(D, warps, pieces, 2))
    stages = max(st for st in (2, 3, 4)
                 if _rows_smem(D, warps, pieces, st) <= _SMEM_LIMIT
                 and per_sm(_rows_smem(D, warps, pieces, st)) == fit)
    smem = _rows_smem(D, warps, pieces, stages)
    qt = 16 * warps
    row_tiles = -(-SR // qt)
    chunks = -(-(M * bs) // KV_ROW_CHUNK)
    # split the keys only where the row tiles alone leave the card's
    # resident blocks idle (a decode step, a verify block): one chunk a
    # block.  A row's bits do not depend on the split; ``chunks_a_block``
    # forces it (phase 36 (a) of chip_smoke.py times the other fold
    # beside the plan's)
    items = row_tiles * KH * B
    K = chunks_a_block or (chunks if items >= sm_count * fit else 1)
    groups = -(-chunks // K)
    split = groups > 1
    return KvRowsPlan(
        q_tile=qt, warps=warps, key_tile=KV_ROW_KEYS, chunk=KV_ROW_CHUNK,
        q_pieces=pieces, stages=stages, threads=threads, smem_bytes=smem,
        chunks=chunks, chunks_a_block=K, grid=(row_tiles * groups, KH, B),
        ws_floats=(items * chunks * qt * (D + 2) if split
                   else items * qt * D if chunks > 1 else 0),
        tickets=items if split else 0)


def int8_kv_plan(B: int, S: int, H: int, KH: int, D: int, bs: int, M: int,
                 sm_count: int = H100_SMS, q_dtype=torch.bfloat16):
    """The launch plan (:class:`KvRowsPlan`) for queries [B, S, H, D]
    over pools of block size ``bs`` and kv heads ``KH`` through a table
    of ``M`` blocks a sequence, whatever S, H and D: warps own 16-row
    slabs of the S*R query rows of a kv head (two warps a slab at
    head_dim 256), 8 slabs a block above 64 rows (256 threads), 4 above
    32, 2 above 16, else 1 (128 threads; at most 2 at head_dim 256);
    64-slot key tiles and 256-slot chunks at fixed absolute slots; the
    deepest ring (2-4 stages) that keeps a two-stage ring's blocks an
    SM; a query of ``q_dtype`` float32 in three bf16 pieces, else one.
    The keys are split, one chunk a block, where the row tiles alone are
    fewer than the blocks ``sm_count`` SMs hold at once (decode steps and
    verify blocks), else a block runs all its row tile's chunks.  Grid
    (row tiles x chunk groups, KH, B).  No S raises.

    What fixes a row's order of operations (the key tile, the chunk,
    the fragment layout) depends on nothing but the kernel's constants;
    the slabs, ring, split and grid follow the shape and the card and
    change no row's bits.  Pure arithmetic: it runs without a card."""
    if min(B, S, H, KH, M, bs) < 1 or bs % 8 or H % KH or \
            D not in _HEAD_DIMS:
        raise ValueError(
            f"int8_kv_plan: B {B}, S {S}, H {H}, KH {KH}, D {D}, bs {bs}, "
            f"M {M} (needs positive sizes, bs % 8 == 0, H % KH == 0, D in "
            f"{_HEAD_DIMS})")
    return _rows_plan(B, S, H, KH, D, bs, M, sm_count,
                      3 if q_dtype == torch.float32 else 1)


def paged_attention_ref(qh, kpool, vpool, kscale, vscale, tbl, pos,
                        kv_heads):
    """``qh`` [B, S, H, D] roped queries; pools [nb, bs, KH, D] (int8 when
    ``kscale``/``vscale`` are given, else the compute dtype); ``tbl``
    [B, M] int; ``pos`` [B, S] int.  Returns [B, S, G, R, D] in ``qh``'s
    dtype."""
    B, S, H, D = qh.shape
    bs = kpool.shape[1]
    T = tbl.shape[1] * bs
    tbl = tbl.long()
    kg = kpool[tbl].reshape(B, T, kv_heads, D)
    vg = vpool[tbl].reshape(B, T, kv_heads, D)
    kgf = kg.float()
    vgf = vg.float()
    if kscale is not None:
        kgf = kgf * kscale[tbl].reshape(B, T)[:, :, None, None]
        vgf = vgf * vscale[tbl].reshape(B, T)[:, :, None, None]
    G = kv_heads
    R = H // G
    qg = qh.reshape(B, S, G, R, D)
    scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                          kgf) * scale                   # [B,G,R,S,T]
    valid = (torch.arange(T, device=qh.device)[None, None, None, None, :]
             <= pos[:, None, None, :, None])
    logits = torch.where(valid, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bgrst,btgd->bsgrd", w, vgf).to(qh.dtype)


_NEG = -1e30


def _bf16_pieces(x, n):
    """f32 ``x`` as ``n`` bf16 pieces (as f32), the smallest first, as
    the kernel splits an f32 query (three pieces: their sum is ``x``
    exactly) and p * v_scale (two): hi = x rounded to bf16, then the
    rest likewise."""
    out, rest = [], x
    for _ in range(n):
        hi = rest.to(torch.bfloat16).float()
        out.insert(0, hi)
        rest = rest - hi
    return out


def _mma_dot(a, b):
    """One ``mma.sync`` step's sums over the last axis: the products of
    two bf16 operands are exact, and so (in f64) is their sum over 16
    terms; rounded to f32 once.  The model's stand-in for the tensor
    cores' sum, whose bits it does not claim."""
    return (a.double() * b.double()).sum(dim=-1).float()


def _exp(x):
    """e^x in the model: ``torch.exp``, exp(0) = 1 and exp(-1e30 - m) = 0
    exactly, as in the kernel, which takes 2^(x log2 e) on the
    special-function unit (the model holds its order, not its bits).
    Not ``torch.exp2``: on the CPU its vector and scalar paths give a
    value different bits by where it sits in a tensor."""
    return torch.exp(x)


def _fold(M, L, A, m, l, acc):
    """A chunk's state (m, l, acc) folded into the running state (M, L,
    A) in chunk order: M' = max(M, m), f = exp(M - M'), g = exp(m - M'),
    L' = L f + l g, A' = A f + acc g (each product and sum rounded).
    From (-1e30, 0, 0) the first fold gives the chunk's state exactly;
    a chunk wholly past a row's position (-1e30, 0, 0) leaves the state
    exactly as it was."""
    Mn = torch.maximum(M, m)
    f = _exp(M - Mn)
    g = _exp(m - Mn)
    return Mn, L * f + l * g, A * f[..., None] + acc * g[..., None]


def paged_attention_rows_ref(qh, kpool, vpool, kscale, vscale, tbl, pos,
                             kv_heads):
    """The kernel's order of operations in plain PyTorch, an oracle for
    it (every S).  Every query row walks its sequence's
    keys in chunks of ``KV_ROW_CHUNK`` absolute slots, each folded from a
    fresh state over its 64-slot key tiles:

    - s = sum over 16-dim steps, and in each over the query's bf16
      pieces smallest first, of the piece . codes (:func:`_mma_dot`);
      s = (s * k_scale) * 1/sqrt(D); a slot past the row's position
      (or the table) s = -1e30 and p exactly 0;
    - m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m') (exp as
      :func:`_exp`);
    - l as four lanes' sums (lane t: slots 8 j + 2 t, 8 j + 2 t + 1, j
      ascending), l_t = l_t * alpha + the tile's sum; a chunk's l is
      (l_0 + l_1) + (l_2 + l_3);
    - acc = acc * alpha, then over 16-slot steps the two bf16 pieces of
      p * v_scale against the codes, the smaller first.

    The chunks' states fold in chunk order by :func:`_fold` from (-1e30,
    0, 0); out = acc / max(l, 1e-30).  Only elementwise operations and
    exact sums, so a row's bits depend on its q, its position and its
    blocks alone, never on S or the other rows.  The model holds the
    kernel's order, not the tensor cores' bits.  Same arguments and
    result as :func:`paged_attention_ref` (int8 pools with their
    scales)."""
    B, S, H, D = qh.shape
    bs = kpool.shape[1]
    M = tbl.shape[1]
    G = kv_heads
    R = H // G
    T, C = KV_ROW_KEYS, KV_ROW_CHUNK
    dev = qh.device
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=torch.float32)
    neg = torch.tensor(_NEG)
    out = torch.empty(B, S, G, R, D, dtype=torch.float32, device=dev)
    for b in range(B):
        q = qh[b].reshape(S, G, R, D)
        qp = _bf16_pieces(q.float(), 3 if q.dtype == torch.float32 else 1)
        qlim = torch.clamp(pos[b].long(), max=M * bs - 1)[:, None, None,
                                                          None]
        lim = min(M, max(0, int(pos[b].max())) // bs + 1) * bs
        Mr = torch.full((S, G, R), _NEG, device=dev)
        Lr = torch.zeros(S, G, R, device=dev)
        Ar = torch.zeros(S, G, R, D, device=dev)
        for c0 in range(0, lim, C):
            m = torch.full((S, G, R), _NEG, device=dev)
            lanes = torch.zeros(S, G, R, 4, device=dev)
            acc = torch.zeros(S, G, R, D, device=dev)
            for t0 in range(c0, min(c0 + C, lim), T):
                slot = t0 + torch.arange(T, device=dev)
                live = slot < lim
                sl = torch.where(live, slot, 0)
                phys = tbl[b].long()[sl // bs]
                k = torch.where(live[:, None, None],
                                kpool[phys, sl % bs].float(), 0.0)
                v = torch.where(live[:, None, None],
                                vpool[phys, sl % bs].float(), 0.0)
                ks = torch.where(live, kscale[phys, sl % bs], 0.0)
                vs = torch.where(live, vscale[phys, sl % bs], 0.0)
                kt = k.permute(1, 0, 2)[None, :, None]    # [1, G, 1, T, D]
                s = torch.zeros(S, G, R, T, device=dev)
                for d0 in range(0, D, 16):
                    for piece in qp:
                        s = s + _mma_dot(piece[..., None, d0:d0 + 16],
                                         kt[..., d0:d0 + 16])
                valid = slot[None, None, None, :] <= qlim
                s = torch.where(valid, s * ks * scale, neg)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.where(valid, _exp(s - m_new[..., None]), 0.0)
                alpha = _exp(m - m_new)
                rs = torch.zeros_like(lanes)
                for j in range(0, T, 8):
                    for e in range(8):
                        rs[..., e // 2] += p[..., j + e]
                lanes = lanes * alpha[..., None] + rs
                m = m_new
                acc = acc * alpha[..., None]
                pv = _bf16_pieces(p * vs, 2)
                vt = v.permute(1, 2, 0)[None, :, None]    # [1, G, 1, D, T]
                for j0 in range(0, T, 16):
                    for piece in pv:
                        acc = acc + _mma_dot(piece[..., None, j0:j0 + 16],
                                             vt[..., j0:j0 + 16])
            l_c = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2]
                                                    + lanes[..., 3])
            Mr, Lr, Ar = _fold(Mr, Lr, Ar, m, l_c, acc)
        out[b] = Ar / torch.clamp(Lr, min=1e-30)[..., None]
    return out.to(qh.dtype)


def _eligible(qh, kpool, vpool, kscale, vscale, tbl, pos, kv_heads):
    ts = (qh, kpool, vpool, kscale, vscale, tbl, pos)
    if any(t is None for t in ts):
        return "int8 pools need their k_scale/v_scale tensors"
    if not all(t.is_cuda for t in ts):
        return "every tensor must be a CUDA tensor"
    if qh.dim() != 4 or qh.dtype not in (torch.bfloat16, torch.float32):
        return f"qh {tuple(qh.shape)} {qh.dtype} (takes 4-D bf16/f32)"
    B, S, H, D = qh.shape
    if kpool.dtype != torch.int8 or vpool.dtype != torch.int8:
        return f"pools are {kpool.dtype}/{vpool.dtype}, not int8"
    if kpool.dim() != 4 or kpool.shape != vpool.shape:
        return f"pools {tuple(kpool.shape)} / {tuple(vpool.shape)}"
    nb, bs, KH, Dk = kpool.shape
    if D not in _HEAD_DIMS or Dk != D:
        return f"head_dim {D} (pool {Dk}; takes {_HEAD_DIMS})"
    if bs % 8:
        return f"block_size {bs} is not a multiple of 8"
    if KH != kv_heads or H % KH:
        return f"heads H={H}, pool kv heads {KH}, kv_heads={kv_heads}"
    for name, t in (("k_scale", kscale), ("v_scale", vscale)):
        if t.dtype != torch.float32 or tuple(t.shape) != (nb, bs):
            return f"{name} {tuple(t.shape)} {t.dtype} (needs ({nb}, {bs}) f32)"
    if tbl.dim() != 2 or tbl.shape[0] != B:
        return f"block table {tuple(tbl.shape)} for batch {B}"
    if tuple(pos.shape) != (B, S):
        return f"positions {tuple(pos.shape)} for queries ({B}, {S})"
    for name, t in (("block table", tbl), ("positions", pos)):
        if t.dtype not in (torch.int32, torch.int64):
            return f"{name} dtype {t.dtype}"
    return None


@functools.lru_cache(maxsize=1024)
def _launch_plan(B, S, H, KH, D, bs, M, device, q_dtype):
    """The plan of a shape on a card and its ints as the route's C entry
    takes them (which it only reads), made once a shape."""
    plan = int8_kv_plan(B, S, H, KH, D, bs, M, _sm_count(device), q_dtype)
    ints = plan.launch()
    return plan, (ctypes.c_int * len(ints))(*ints)


# (device, stream) -> (f32 partials, int32 tickets).  The tickets are
# zero between launches (the kernel's merging block resets its own), and
# launches on one stream run in order, so one pair serves every launch
# of a stream; it grows to the largest call seen
_workspaces: dict = {}


def _workspace(device, stream, floats, tickets):
    ws = _workspaces.get((device, stream))
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tickets:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(floats, have[0], 1), dtype=torch.float32,
                          device=device),
              torch.zeros(max(tickets, have[1], 1), dtype=torch.int32,
                          device=device))
        _workspaces[(device, stream)] = ws
    return ws


def _on_16_bytes(t):
    """``t`` contiguous and starting on 16 bytes (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _int8_kv_cuda(qh, kpool, vpool, kscale, vscale, tbl, pos, kv_heads):
    """Launch the kernel; a plan with more than one chunk takes the
    stream's workspace (chunk states and tickets where it splits, else
    running accs).  Launches count by call: ``decode`` (S = 1) and
    ``rows`` (S > 1), one arithmetic."""
    B, S, H, D = qh.shape
    nb, bs, KH, _ = kpool.shape
    M = tbl.shape[1]
    plan, ints = _launch_plan(B, S, H, KH, D, bs, M, qh.device, qh.dtype)
    if qh.stride(-1) != 1:
        qh = qh.contiguous()
    kpool, vpool, kscale, vscale = (_on_16_bytes(t) for t in
                                    (kpool, vpool, kscale, vscale))
    tbl = tbl.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, D), dtype=qh.dtype, device=qh.device)
    return _rows_cuda(_build.load(_SOURCE), plan, ints, qh, kpool, vpool,
                      kscale, vscale, tbl, pos, out)


def _rows_cuda(lib, plan, ints, qh, kpool, vpool, kscale, vscale, tbl, pos,
               out):
    """Launch ``plan`` on prepared tensors (contiguous int32 table and
    positions, pools on 16 bytes) into ``out``."""
    B, S, H, D = qh.shape
    nb, bs, KH, _ = kpool.shape
    fn = lib.int8_kv_attention_rows
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    dev = qh.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = tickets = None
        if plan.ws_floats:
            ws, tickets = _workspace(dev, stream, plan.ws_floats,
                                     plan.tickets)
        rc = fn(qh.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                kscale.data_ptr(), vscale.data_ptr(), tbl.data_ptr(),
                pos.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), B, S, H,
                KH, D, bs, tbl.shape[1], nb, qh.stride(0), qh.stride(1),
                qh.stride(2), ints, 1.0 / (D ** 0.5),
                int(qh.dtype == torch.bfloat16), stream)
    if rc:
        _build.check(lib, rc, f"int8_kv_attention_rows q={tuple(qh.shape)} "
                              f"pool={tuple(kpool.shape)} "
                              f"table={tuple(tbl.shape)} {plan}")
    registry.note_launch(_SPEC, "decode" if S == 1 else "rows")
    return out.view(B, S, KH, H // KH, D)


_SPEC = registry.register(
    "int8_kv_attention", _int8_kv_cuda, paged_attention_ref,
    # copied from the reference's registration
    tolerance="atol 2e-5 / rtol 1e-4 vs xla_ref (f32 online softmax "
              "re-association; the int8 dequant itself is exact)",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/int8_kv_attention.cu",
    replaces="paddle_tpu/ops/pallas/kv_attention.py:84",
    doc="paged decode/verify attention reading int8 KV pools once, one "
        "arithmetic for every S: the query rows tiled over the grid "
        "against 64-slot key tiles at fixed absolute slots gathered "
        "through the table, per-(block,slot) scales, scores and P.V on "
        "the tensor cores, 256-slot chunks folded in order (split over "
        "blocks for decode steps and verify blocks) (launches by call: "
        "decode for S = 1, rows for S > 1)",
)


def int8_paged_attention(qh, kpool, vpool, kscale, vscale, tbl, pos,
                         kv_heads, mode=None):
    """Attention of ``qh`` [B, S, H, D] over int8 paged pools; returns
    [B, S, G, R, D] in ``qh``'s dtype (see the module docstring)."""
    return registry.dispatch("int8_kv_attention", qh, kpool, vpool, kscale,
                             vscale, tbl, pos, kv_heads, mode=mode)
