"""Int8 paged decode/verify attention: the Hopper kernels and their plain
version.

Counterpart of ``paddle_tpu/ops/pallas/kv_attention.py`` (kernel 4,
``_int8_kv_attn_kernel``).  K/V live in int8 pools [nb, bs, KH, D] with
per-(block, slot) f32 scales [nb, bs]; each sequence's block table row
maps logical block ``pos // bs`` to a physical pool block.  A slot is
valid iff ``slot <= position``; a masked slot adds an exact 0.

The CUDA kernel (``csrc/int8_kv_attention.cu``) splits each sequence into
chunks of ``C = ceil(KV_CHUNK_SLOTS / bs) * bs`` slots (flash-decoding):
one thread block per (chunk, kv head, sequence) streams its chunk's int8
blocks through shared memory by TMA, dequantises with the stored scales
and folds them into an f32 online softmax over the S*R query rows that
share the kv head; a chunk past the sequence's largest position exits at
once.  The last live chunk of a (sequence, kv head) merges the chunks'
partial states in chunk order in the same launch, through a workspace
the wrapper keeps per device and stream (grown, never shrunk: a steady
decode step allocates nothing).  C depends on nothing but ``bs``, so a
sequence's output bits do not depend on the batch it is served in.
:func:`int8_kv_plan` gives the launch's chunk, tiles, ring, grid,
shared memory and workspace; it is pure arithmetic.

Every call with more than one query position a sequence (S > 1: a
speculative verify block, a prefix-sharing suffix prefill of up to
``max_model_len`` rows) takes the source's second kernel, the many-row
route (``int8_kv_rows``): the S*R query rows of a kv head are tiled over
the grid, 16, 32 or 64 a block, so no S is too large; keys come in
64-slot tiles at fixed absolute slots from slot 0, and every operation of
a row runs in an order fixed by the row alone, so a row's output bits
depend only on its q, its position and its sequence's blocks -- not on S,
the suffix's start or the tile it lands in (a cold prefill and a warm
suffix prefill agree bitwise where they overlap).  Scores and P.V run on
the FMA pipe with the decode route's numerics.  :func:`int8_kv_plan`
picks the route by S alone (``KvRowsPlan`` for S > 1), never by whether
the rows would fit the decode route.

:func:`paged_attention_ref` is a line-for-line port of the reference's
``paged_attention_ref`` (the gather/dequant/attend path); it is the
plain version and the oracle.  :func:`paged_attention_split_ref` runs
the kernel's chunks and chunk-order merge in plain PyTorch, an oracle for
the split.  Documented tolerance: atol 2e-5 / rtol 1e-4 (the online
softmax and the merge re-associate the f32 sums; the dequant itself is
exact).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build, registry
from .flash_attention import H100_SMS, _sm_count

__all__ = ["paged_attention_ref", "paged_attention_split_ref",
           "paged_attention_rows_ref", "int8_paged_attention",
           "int8_kv_plan", "KvPlan", "KvRowsPlan", "KV_CHUNK_SLOTS",
           "KV_ROW_KEYS", "CARD_TOL"]

_SOURCE = "int8_kv_attention.cu"
_HEAD_DIMS = (64, 128, 256)
# The kernel against its plain version on the card, as (atol, rtol, row)
# in the form of flash_attention.CARD_TOL: the registered tolerance for
# f32; for bf16 one rounding of the bf16 output (rtol 2**-7), the f32
# work in between being the same
CARD_TOL = {torch.float32: (2e-5, 1e-4, 0.0),
            torch.bfloat16: (1e-4, 8e-3, 0.0)}

# The chunk's slot target C0, chosen on the card from 128, 256 and 512
# (PERF.md section 6).  A chunk is the whole table blocks that cover it.
KV_CHUNK_SLOTS = 256
# The kernel's constants (csrc/int8_kv_attention.cu): slots a tile and a
# TMA box at most, ring stages and consumer warps at most, the dynamic
# shared memory a block may have, the blocks an SM its launch bounds ask
# for, and the shared memory of an SM (each block also takes 1,024 bytes)
_TILE_SLOTS, _BOX_SLOTS, _MAX_STAGES, _MAX_WARPS = 32, 32, 4, 4
_SMEM_LIMIT, _BLOCKS_AN_SM, _SM_SMEM = 232_448, 4, 233_472
# The many-row route's key tile (slots, at absolute slots 64 t ..) and
# threads a block (16 row groups of 8 lanes)
KV_ROW_KEYS, _ROW_THREADS = 64, 128


class KvPlan(NamedTuple):
    """How the kernel runs one call."""

    chunk: int          # slots a chunk: ceil(target / bs) * bs
    chunk_blocks: int   # table blocks a chunk
    box_slots: int      # slots a TMA box: a block, or 32 slots of one
    boxes_a_block: int  # boxes a block (1 while bs <= 32)
    tile_slots: int     # slots a tile (whole boxes, at most 32)
    tiles: int          # tiles a whole chunk
    warps: int          # consumer warps (each folds whole tiles)
    stages: int         # tiles in the shared-memory ring
    threads: int        # consumer warps and one producer warp
    smem_bytes: int     # dynamic shared memory a block
    chunks: int         # chunks a sequence: ceil(M / chunk_blocks)
    chunks_a_block: int  # consecutive chunks of a sequence one block runs
    grid: Tuple[int, int, int]   # (chunk groups, kv heads, sequences)
    ws_floats: int      # f32 partials: B * KH * chunks * S*R * (D + 2)
    tickets: int        # int32 tickets: B * KH

    @property
    def route(self) -> str:
        return "decode"

    def launch(self) -> tuple:
        """The seven ints the C entry takes."""
        return (self.chunk, self.warps, self.stages, self.threads,
                self.smem_bytes, self.chunks, self.chunks_a_block)


class KvRowsPlan(NamedTuple):
    """How the many-row route runs one S > 1 call."""

    q_tile: int         # query rows a block: 16 * rows_a_thread
    rows_a_thread: int  # rows a thread (each of 16 row groups of 8 lanes)
    key_tile: int       # slots a key tile (KV_ROW_KEYS)
    threads: int        # 128
    smem_bytes: int     # dynamic shared memory a block
    grid: Tuple[int, int, int]   # (row tiles, kv heads, sequences)

    @property
    def route(self) -> str:
        return "rows"

    def launch(self) -> tuple:
        """The five ints ``int8_kv_attention_rows`` takes."""
        return (self.q_tile, self.key_tile, self.threads, self.smem_bytes,
                self.grid[0])


def _rows_smem(D, q_tile):
    """``rows_layout(D, q_tile).total`` of the kernel: q, K and V codes
    as f32 rows of D + 4, p * v_scale rows of 68, two scale rows, the
    block's largest position."""
    row = 4 * (D + 4)
    return (q_tile * row + 2 * KV_ROW_KEYS * row
            + 4 * q_tile * (KV_ROW_KEYS + 4) + 2 * 4 * KV_ROW_KEYS + 16)


def _rows_plan(B, S, H, KH, D):
    SR = S * (H // KH)
    rm = 4 if SR >= 64 else 2 if SR >= 32 else 1
    if D == 256:
        rm = min(rm, 2)
    qt = 16 * rm
    return KvRowsPlan(q_tile=qt, rows_a_thread=rm, key_tile=KV_ROW_KEYS,
                      threads=_ROW_THREADS, smem_bytes=_rows_smem(D, qt),
                      grid=(-(-SR // qt), KH, B))


def _smem_bytes(D, SR, warps, stages, tile_units, box_slots, scale_row,
                tile_slots, chunk_blocks):
    """The kernel's ``layout_of(...).total``: the ring, q, the warps'
    acc, p rows, slot rows and (m, l), the rows' positions, the chunk's
    table entries, the barriers and the ticket's verdict, plus 128 bytes
    to align the base."""
    stage = 2 * tile_units * box_slots * D + 2 * tile_units * scale_row
    o = (stages * stage + 4 * SR * D + 4 * warps * SR * D
         + 12 * warps * tile_slots + 8 * warps * SR + 4 * SR
         + 4 * chunk_blocks)
    o = -(-o // 8) * 8 + 16 * stages + 16
    return o + 128


def int8_kv_plan(B: int, S: int, H: int, KH: int, D: int, bs: int, M: int,
                 sm_count: int = H100_SMS):
    """The launch plan for queries [B, S, H, D] over pools of block size
    ``bs`` and kv heads ``KH`` through a table of ``M`` blocks a
    sequence.

    S > 1 takes the many-row route (:class:`KvRowsPlan`), whatever S, H
    and D: row tiles of 64 query rows (32 at head_dim 256; 32 or 16 where
    the S*R rows of a kv head are fewer), 128 threads, 64-slot key tiles,
    grid (row tiles, KH, B).  No S raises.  The rest describes the decode
    route (:class:`KvPlan`), which takes S = 1:

    - A chunk is ``ceil(KV_CHUNK_SLOTS / bs)`` whole blocks.
    - A block runs K consecutive chunks of one (sequence, kv head): 2
      where the chunks outnumber the blocks resident on ``sm_count`` SMs
      at once, else 1 (small batches, where the chunks are the card's
      parallelism).  More would serialise a long sequence behind its own
      chunks (PERF.md section 6).  The grid is (ceil(chunks / K), KH,
      B).  Each chunk is computed the same whatever K is.
    - A TMA box is one block (``bs <= 32``) or 32 slots of one; a tile is
      as many boxes as fit in 32 slots (at least one).
    - Four consumer warps and a ring of four tiles, fewer of either where
      the S*R query rows' state would not fit beside them; a shape that
      fits with none raises.  The ring is a multiple of the warps, so
      each stage serves one warp.
    - The workspace holds one f32 partial (acc, m, l) a (sequence, kv
      head, chunk) when a sequence can have more than one chunk.

    What fixes the kernel's order of operations (the chunk, tiles, warps)
    depends on ``bs``, ``D``, ``S * H / KH`` and the target alone, never
    on B, M or the card.  Pure arithmetic: it runs without a card."""
    if min(B, S, H, KH, M, bs) < 1 or bs % 8 or H % KH or \
            D not in _HEAD_DIMS:
        raise ValueError(
            f"int8_kv_plan: B {B}, S {S}, H {H}, KH {KH}, D {D}, bs {bs}, "
            f"M {M} (needs positive sizes, bs % 8 == 0, H % KH == 0, D in "
            f"{_HEAD_DIMS})")
    if S > 1:
        return _rows_plan(B, S, H, KH, D)
    chunk = -(-KV_CHUNK_SLOTS // bs) * bs
    cb = chunk // bs
    bx = min(bs, _BOX_SLOTS)
    ppb = -(-bs // bx)
    tu = _TILE_SLOTS // bx
    ts = tu * bx
    sp = -(-bx * 4 // 128) * 128
    tiles = -(-(cb * ppb) // tu)
    SR = S * (H // KH)
    # a stage is always refilled for the warp that emptied it (stages a
    # multiple of the warps, each chunk's tiles padded to one): a warp
    # waiting on a stage's second fill before its first landed would pass
    # the parity wait at once
    top = min(_MAX_STAGES, -(-tiles // _MAX_WARPS) * _MAX_WARPS)
    cands = [(w, st) for w in (_MAX_WARPS, 2, 1)
             for st in range(top, 0, -1) if st % w == 0]
    for warps, stages in cands:
        smem = _smem_bytes(D, SR, warps, stages, tu, bx, sp, ts, cb)
        if smem <= _SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"int8_kv_attention: {SR} query rows a kv head (S {S}, H {H}, "
            f"KH {KH}) at head_dim {D}, block size {bs}: their softmax "
            f"state needs {smem} bytes of shared memory with one warp and "
            f"one stage, over the {_SMEM_LIMIT} a block has")
    chunks = -(-M // cb)
    threads = 32 * (warps + 1)
    resident = sm_count * max(1, min(_SM_SMEM // (smem + 1024),
                                     2048 // threads, _BLOCKS_AN_SM))
    K = 2 if chunks > 1 and chunks * KH * B >= resident else 1
    return KvPlan(
        chunk=chunk, chunk_blocks=cb, box_slots=bx, boxes_a_block=ppb,
        tile_slots=ts, tiles=tiles, warps=warps, stages=stages,
        threads=threads, smem_bytes=smem, chunks=chunks, chunks_a_block=K,
        grid=(-(-chunks // K), KH, B),
        ws_floats=B * KH * chunks * SR * (D + 2) if chunks > 1 else 0,
        tickets=B * KH)


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


def paged_attention_split_ref(qh, kpool, vpool, kscale, vscale, tbl, pos,
                              kv_heads, chunk_target=KV_CHUNK_SLOTS):
    """The kernel's split in plain PyTorch, an oracle for it: each
    sequence's live chunks (``ceil(chunk_target / bs)`` whole blocks, as
    ``int8_kv_plan`` cuts them at the default target, up to the block
    holding its largest position) give (m, l, acc) as the online softmax
    leaves them (masked scores -1e30, masked p exactly 0), merged in chunk
    order as M = max m_c, l = sum l_c exp(m_c - M), acc = sum acc_c
    exp(m_c - M); out = acc / max(l, 1e-30).  A smaller ``chunk_target``
    puts chunk boundaries inside the short sequences of a test.  Same
    arguments and result as :func:`paged_attention_ref` (int8 pools with
    their scales)."""
    B, S, H, D = qh.shape
    bs = kpool.shape[1]
    M = tbl.shape[1]
    G = kv_heads
    R = H // G
    C = -(-chunk_target // bs) * bs
    cb = C // bs
    scale = 1.0 / (D ** 0.5)
    q = qh.reshape(B, S, G, R, D).float()
    out = torch.empty(B, S, G, R, D, dtype=torch.float32, device=qh.device)
    for b in range(B):
        p_b = pos[b].long()
        n_blocks = min(M, max(0, int(p_b.max())) // bs + 1)
        parts = []
        for c in range(-(-n_blocks // cb)):
            blk = tbl[b, c * cb:min((c + 1) * cb, n_blocks)].long()
            k = (kpool[blk].float() * kscale[blk][:, :, None, None]
                 ).reshape(-1, G, D)                       # [T_c, G, D]
            v = (vpool[blk].float() * vscale[blk][:, :, None, None]
                 ).reshape(-1, G, D)
            slot = c * C + torch.arange(k.shape[0], device=qh.device)
            valid = slot[None, :] <= p_b[:, None]                 # [S, T_c]
            s = torch.einsum("sgrd,tgd->sgrt", q[b], k) * scale
            s = torch.where(valid[:, None, None, :], s, _NEG)
            m = s.amax(dim=-1)                                    # [S, G, R]
            p = torch.where(valid[:, None, None, :],
                            torch.exp(s - m[..., None]), 0.0)
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("sgrt,tgd->sgrd", p, v)))
        m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l = torch.zeros_like(m_all)
        acc = torch.zeros_like(out[b])
        for m, l_c, acc_c in parts:           # in chunk order
            f = torch.exp(m - m_all)
            l = l + l_c * f
            acc = acc + acc_c * f[..., None]
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(qh.dtype)


def paged_attention_rows_ref(qh, kpool, vpool, kscale, vscale, tbl, pos,
                             kv_heads, key_tile=KV_ROW_KEYS):
    """The many-row route's arithmetic in plain PyTorch, an oracle for it
    (S > 1 calls): every query row walks key tiles of ``key_tile`` slots
    at fixed absolute slots from slot 0 up to the table block holding its
    sequence's largest position, in order, each tile folded into the
    row's (m, l, acc) as the kernel folds it: the dot over d ascending,
    s = (dot * k_scale) * 1/sqrt(D), masked s = -1e30; the tile's sum as
    8 lanes' sums over slots lane + 8 i, i ascending, added in the
    xor-1, 2, 4 tree; P.V over the tile's slots ascending with (p *
    v_scale) * code; out = acc / max(l, 1e-30).  Only elementwise
    operations in a fixed order, so a row's bits depend on its q, its
    position and its blocks alone, never on S or the other rows (the
    kernel fuses the multiply-adds the model rounds twice: the model
    holds the kernel's order, not its bits).  Same arguments and result
    as :func:`paged_attention_ref` (int8 pools with their scales)."""
    B, S, H, D = qh.shape
    bs = kpool.shape[1]
    M = tbl.shape[1]
    G = kv_heads
    R = H // G
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=torch.float32)
    lanes = 8
    out = torch.empty(B, S, G, R, D, dtype=torch.float32, device=qh.device)
    for b in range(B):
        q = qh[b].reshape(S, G, R, D).float()
        p_b = pos[b].long()
        lim = min(M, max(0, int(p_b.max())) // bs + 1) * bs
        m = torch.full((S, G, R), _NEG, device=qh.device)
        l = torch.zeros(S, G, R, device=qh.device)
        acc = torch.zeros(S, G, R, D, device=qh.device)
        for t0 in range(0, lim, key_tile):
            slot = t0 + torch.arange(key_tile, device=qh.device)
            live = slot < lim
            sl = torch.where(live, slot, 0)
            phys = tbl[b].long()[sl // bs]
            k = torch.where(live[:, None, None],
                            kpool[phys, sl % bs].float(), 0.0)   # [T, G, D]
            v = torch.where(live[:, None, None],
                            vpool[phys, sl % bs].float(), 0.0)
            ks = torch.where(live, kscale[phys, sl % bs], 0.0)
            vs = torch.where(live, vscale[phys, sl % bs], 0.0)
            kt = k.permute(1, 0, 2)                               # [G, T, D]
            dot = torch.zeros(S, G, R, key_tile, device=qh.device)
            for d in range(D):
                dot = dot + q[..., d, None] * kt[None, :, None, :, d]
            valid = (slot[None, :] <= p_b[:, None])[:, None, None, :]
            sc = torch.where(valid, dot * ks * scale, _NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pe = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
            lane = torch.zeros(S, G, R, lanes, device=qh.device)
            for i in range(key_tile // lanes):
                lane = lane + pe[..., i * lanes:(i + 1) * lanes]
            idx = torch.arange(lanes, device=qh.device)
            for x in (1, 2, 4):
                lane = lane + lane[..., idx ^ x]
            alpha = torch.exp(m - m_new)
            l = l * alpha + lane[..., 0]
            m = m_new
            acc = acc * alpha[..., None]
            pv = torch.where(valid, pe * vs, 0.0)
            for j in range(key_tile):
                acc = acc + pv[..., j, None] * v[j][None, :, None, :]
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
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
def _launch_plan(B, S, H, KH, D, bs, M, device):
    """The plan of a shape on a card and its ints as the route's C entry
    takes them (which it only reads), made once a shape."""
    plan = int8_kv_plan(B, S, H, KH, D, bs, M, _sm_count(device))
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
    B, S, H, D = qh.shape
    nb, bs, KH, _ = kpool.shape
    M = tbl.shape[1]
    plan, ints = _launch_plan(B, S, H, KH, D, bs, M, qh.device)
    if qh.stride(-1) != 1:
        qh = qh.contiguous()
    kpool, vpool, kscale, vscale = (_on_16_bytes(t) for t in
                                    (kpool, vpool, kscale, vscale))
    tbl = tbl.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, D), dtype=qh.dtype, device=qh.device)
    lib = _build.load(_SOURCE)
    if plan.route == "rows":
        return _rows_cuda(lib, plan, ints, qh, kpool, vpool, kscale, vscale,
                          tbl, pos, out)
    fn = lib.int8_kv_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    dev = qh.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, tickets = _workspace(dev, stream, plan.ws_floats, plan.tickets)
        rc = fn(qh.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                kscale.data_ptr(), vscale.data_ptr(), tbl.data_ptr(),
                pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
                tickets.data_ptr(), B, S, H, KH, D, bs, M, nb,
                qh.stride(0), qh.stride(1), qh.stride(2), ints,
                1.0 / (D ** 0.5), int(qh.dtype == torch.bfloat16), stream)
    if rc:
        _build.check(lib, rc, f"int8_kv_attention q={tuple(qh.shape)} "
                              f"pool={tuple(kpool.shape)} "
                              f"table={tuple(tbl.shape)} {plan}")
    registry.note_launch(_SPEC, "decode")
    return out.view(B, S, KH, H // KH, D)


def _rows_cuda(lib, plan, ints, qh, kpool, vpool, kscale, vscale, tbl, pos,
               out):
    """Launch the many-row route (S > 1); no workspace."""
    B, S, H, D = qh.shape
    nb, bs, KH, _ = kpool.shape
    fn = lib.int8_kv_attention_rows
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    dev = qh.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qh.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                kscale.data_ptr(), vscale.data_ptr(), tbl.data_ptr(),
                pos.data_ptr(), out.data_ptr(), B, S, H, KH, D, bs,
                tbl.shape[1], nb, qh.stride(0), qh.stride(1), qh.stride(2),
                ints, 1.0 / (D ** 0.5), int(qh.dtype == torch.bfloat16),
                stream)
    if rc:
        _build.check(lib, rc, f"int8_kv_attention_rows q={tuple(qh.shape)} "
                              f"pool={tuple(kpool.shape)} "
                              f"table={tuple(tbl.shape)} {plan}")
    registry.note_launch(_SPEC, "rows")
    return out.view(B, S, KH, H // KH, D)


_SPEC = registry.register(
    "int8_kv_attention", _int8_kv_cuda, paged_attention_ref,
    # copied from the reference's registration
    tolerance="atol 2e-5 / rtol 1e-4 vs xla_ref (f32 online softmax "
              "re-association; the int8 dequant itself is exact)",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/int8_kv_attention.cu",
    replaces="paddle_tpu/ops/pallas/kv_attention.py:84",
    doc="paged decode/verify attention reading int8 KV pools once: "
        "S = 1 splits sequences into fixed chunks loaded by TMA, "
        "per-(block,slot) scales applied inside the table-driven gather, "
        "online softmax, chunks merged in order in the same launch; S > 1 "
        "tiles the query rows over the grid against 64-slot key tiles at "
        "fixed absolute slots (launches by route: decode, rows)",
)


def int8_paged_attention(qh, kpool, vpool, kscale, vscale, tbl, pos,
                         kv_heads, mode=None):
    """Attention of ``qh`` [B, S, H, D] over int8 paged pools; returns
    [B, S, G, R, D] in ``qh``'s dtype (see the module docstring)."""
    return registry.dispatch("int8_kv_attention", qh, kpool, vpool, kscale,
                             vscale, tbl, pos, kv_heads, mode=mode)
