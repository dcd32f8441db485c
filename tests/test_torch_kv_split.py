"""Kernel 4's split (flash-decoding) and many-row route in plain PyTorch,
and their launch plans.

``paged_attention_split_ref`` runs the CUDA kernel's chunks and its
chunk-order merge.  Here it is held to the reference's Pallas kernel
(``_int8_kv_attn_kernel``, interpret mode) and to the reference's XLA
``paged_attention_ref`` at the registered tolerance, atol 2e-5 / rtol
1e-4, on the cases the split makes hard: a chunk boundary inside a
sequence, sequences of one chunk and of several, a verify row whose
position lies before a live chunk, idle trash rows, GQA, every head dim.
``int8_kv_plan`` is pure arithmetic, and the launcher is checked with a
recording library in place of the CUDA one.  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``, marked ``cuda``).

S > 1 calls (verify blocks, prefix-sharing suffix prefills) take the
many-row route: ``paged_attention_rows_ref`` models its order of
operations (256-slot chunks, each folded from a fresh state over 64-slot
key tiles at fixed absolute slots, then folded in chunk order; the
query's and p * v_scale's bf16 pieces as f32 sums of their products; the
quad lanes' order of sums) and is held to the Pallas kernel in interpret
mode within ``CARD_TOL[f32]``, rows crossing chunk boundaries and verify
blocks whose plan splits the keys over blocks included; a row's bits do
not depend on S.  The split is picked from the shape alone, and the
S = 1 plan is compared field by field with the plan the decode route had
before the many-row route existed.
"""
import contextlib
import importlib
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops.kernels import _build, registry
from paddle_tpu_torch.ops.kernels import kv_attention as kva

jkv = importlib.import_module("paddle_tpu.ops.pallas.kv_attention")

ATOL, RTOL = 2e-5, 1e-4


def _case(seed, last, S, G, R, D, bs, M):
    """Sequences whose S queries end at positions ``last`` (-1: an idle
    decode slot, all-zero table and position 0), over random blocks."""
    rng = np.random.default_rng(seed)
    B = len(last)
    nb = B * M + 1
    qh = rng.standard_normal((B, S, G * R, D)).astype(np.float32)
    kpool = rng.integers(-127, 128, (nb, bs, G, D)).astype(np.int8)
    vpool = rng.integers(-127, 128, (nb, bs, G, D)).astype(np.int8)
    ks = (rng.random((nb, bs)) * 0.01 + 1e-3).astype(np.float32)
    vs = (rng.random((nb, bs)) * 0.01 + 1e-3).astype(np.float32)
    tbl = (rng.permutation(nb - 1)[:B * M] + 1).reshape(B, M).astype(np.int32)
    pos = np.zeros((B, S), np.int32)
    for i, n in enumerate(last):
        if n < 0:
            tbl[i] = 0
        else:
            pos[i] = np.arange(n - S + 1, n + 1)
    return [qh, kpool, vpool, ks, vs, tbl, pos], G


# (last positions, S, G, R, D, bs, M, chunk target): with bs 8 and a
# target of 16 a chunk is two blocks, 16 slots
_SPLIT_CASES = {
    "boundary_inside_a_sequence": ([20, 40], 1, 2, 2, 64, 8, 6, 16),
    "one_chunk_and_several": ([15, 47], 1, 2, 2, 64, 8, 6, 16),
    "verify_row_masked_in_a_live_chunk": ([16, 33], 3, 2, 1, 64, 8, 6, 16),
    "trash_rows": ([30, -1, -1], 3, 2, 2, 64, 8, 6, 16),
    "gqa_r4": ([23, 9], 1, 1, 4, 64, 8, 5, 16),
    "d128": ([40, 17], 2, 2, 2, 128, 16, 4, 32),
    "d256": ([25, 3], 1, 1, 2, 256, 8, 4, 24),
    "chunk_target_not_a_multiple": ([44, 30], 2, 2, 1, 64, 24, 2, 40),
}


@pytest.mark.parametrize("name", sorted(_SPLIT_CASES))
def test_split_ref_matches_jax(name):
    last, S, G, R, D, bs, M, target = _SPLIT_CASES[name]
    args, G = _case(3, last, S, G, R, D, bs, M)
    jargs = [jnp.asarray(a) for a in args]
    ker = np.asarray(jkv.int8_paged_attention(*jargs, G, interpret=True))
    xref = np.asarray(jkv.paged_attention_ref(*jargs, G))
    got = kva.paged_attention_split_ref(*[torch.from_numpy(a) for a in args],
                                        G, chunk_target=target)
    assert got.shape == ker.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ker, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), xref, atol=ATOL, rtol=RTOL)


def test_split_ref_splits_where_the_plan_does(monkeypatch):
    """The oracle's chunks are the plan's: with a target below one block
    a chunk is one block, and the result still agrees with the unsplit
    plain version."""
    args, G = _case(4, [31, 12], 1, 2, 2, 64, 8, 4)
    t = [torch.from_numpy(a) for a in args]
    monkeypatch.setattr(kva, "KV_CHUNK_SLOTS", 3)
    assert kva.int8_kv_plan(2, 1, 4, 2, 64, 8, 4).chunk == 8
    got = kva.paged_attention_split_ref(*t, G, chunk_target=3)
    ref = kva.paged_attention_ref(*t, G)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_split_ref_is_batch_invariant():
    """A sequence's result does not depend on its batch or on the table's
    width: alone through a table just wide enough, it is bitwise equal to
    its row inside the batch."""
    args, G = _case(5, [60, 17, 33], 2, 2, 2, 64, 8, 10)
    t = [torch.from_numpy(a) for a in args]
    full = kva.paged_attention_split_ref(*t, G, chunk_target=16)
    for i, m in ((0, 8), (1, 3), (2, 5)):
        alone = kva.paged_attention_split_ref(
            t[0][i:i + 1], t[1], t[2], t[3], t[4], t[5][i:i + 1, :m],
            t[6][i:i + 1], G, chunk_target=16)
        assert torch.equal(alone[0], full[i])


# ---------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------

@pytest.mark.parametrize("target", [128, 256, 512])
@pytest.mark.parametrize("bs", [8, 16, 24, 40, 64, 72, 128, 256])
def test_plan_chunk_is_whole_blocks(bs, target, monkeypatch):
    """At each chunk target the constant was chosen from."""
    B, S, H, KH, D, M = 3, 1, 8, 4, 128, 50
    monkeypatch.setattr(kva, "KV_CHUNK_SLOTS", target)
    p = kva.int8_kv_plan(B, S, H, KH, D, bs, M)
    assert p.chunk % bs == 0 and target <= p.chunk < target + bs
    assert p.chunk_blocks == p.chunk // bs
    assert p.chunks == -(-M // p.chunk_blocks)
    assert p.grid == (-(-p.chunks // p.chunks_a_block), KH, B)
    assert p.box_slots == min(bs, 32)
    assert p.boxes_a_block * p.box_slots >= bs
    assert p.tile_slots <= 32 and p.tile_slots % p.box_slots == 0
    assert p.tiles * p.tile_slots >= p.chunk_blocks * p.boxes_a_block \
        * p.box_slots
    # a stage always serves one warp
    assert 1 <= p.stages <= 4 and 1 <= p.warps <= 4
    assert p.stages % p.warps == 0
    assert p.threads == 32 * (p.warps + 1)
    assert p.smem_bytes <= 232_448
    SR = S * H // KH
    want = B * KH * p.chunks * SR * (D + 2) if p.chunks > 1 else 0
    assert (p.ws_floats, p.tickets) == (want, B * KH)
    assert p.launch() == (p.chunk, p.warps, p.stages, p.threads,
                          p.smem_bytes, p.chunks, p.chunks_a_block)


def test_plan_at_the_7b_decode():
    """B 8, one query, 32 heads and kv heads, head_dim 128, bs 16, a
    2,048-token table: 8 chunks of 16 blocks, two a block (the 2,048
    chunks outnumber the 4 x 132 resident blocks); eight 32-slot tiles
    each through a four-stage ring, four consumer warps (each stage
    serves one warp); the shared memory counted by hand from the
    kernel's layout.  At batch 1 a block runs one chunk."""
    p = kva.int8_kv_plan(8, 1, 32, 32, 128, 16, 128)
    assert kva.KV_CHUNK_SLOTS == 256
    assert (p.chunk, p.chunk_blocks, p.box_slots, p.tile_slots, p.tiles) \
        == (256, 16, 16, 32, 8)
    assert (p.warps, p.stages, p.threads) == (4, 4, 160)
    assert (p.chunks, p.chunks_a_block, p.grid) == (8, 2, (4, 32, 8))
    ring = 4 * (2 * 32 * 128 + 2 * 2 * 128)      # K, V, 2 scale rows a side
    rest = (4 * 128 + 4 * 4 * 128 + 4 * 4 * 32 + 4 * 2 * 4 * 32 + 8 * 4
            + 4 + 4 * 16)       # q, acc, p rows, slot rows, (m, l), ...
    aligned = -(-(ring + rest) // 8) * 8            # the barriers' 8 bytes
    assert p.smem_bytes == aligned + 4 * 16 + 16 + 128 == 39224
    assert (p.ws_floats, p.tickets) == (8 * 32 * 8 * 130, 256)
    one = kva.int8_kv_plan(1, 1, 32, 32, 128, 16, 128)
    assert (one.chunks_a_block, one.grid) == (1, (8, 32, 1))


@pytest.mark.parametrize("S,H,KH,D", [(1, 32, 32, 128), (4, 32, 8, 128),
                                      (3, 8, 2, 256), (1, 8, 8, 64)])
def test_plan_of_a_sequence_ignores_batch_and_table_width(S, H, KH, D):
    """Only the chunk count, the chunks a block, the grid and the
    workspace follow B, M and the card: the chunk, tiles, warps and ring
    (which fix the kernel's order of operations) do not, so a sequence's
    bits do not depend on its batch.  The many-row route (S > 1) follows
    B, M and the card in the same fields alone (its tiles, chunk, warps
    and ring do not)."""
    plans = [kva.int8_kv_plan(B, S, H, KH, D, 16, M, sm_count=sms)
             for B, M, sms in ((1, 9, 132), (8, 128, 132), (33, 300, 66))]
    if S > 1:
        assert {p.route for p in plans} == {"rows"}
        assert len({p._replace(chunks=None, chunks_a_block=None, grid=None,
                               ws_floats=None, tickets=None)
                    for p in plans}) == 1
        assert [p.grid[1:] for p in plans] == [(KH, 1), (KH, 8), (KH, 33)]
        assert [p.chunks for p in plans] == [1, 8, 19]
        return
    same = [p._replace(chunks=None, chunks_a_block=None, grid=None,
                       ws_floats=None, tickets=None) for p in plans]
    assert same[0] == same[1] == same[2]
    assert [p.chunks for p in plans] == [1, 8, 19]
    assert plans[0].ws_floats == 0 and plans[2].chunks_a_block == 2


def test_plan_trades_warps_and_stages_for_many_query_rows():
    """The decode route (S = 1) with many query rows a kv head (a wide
    GQA group) at head_dim 256 keeps fewer warps or stages so the rows'
    softmax state fits; one that fits with none raises, naming the
    shape.  The same rows as S > 1 take the many-row route, which no
    shape overflows."""
    p = kva.int8_kv_plan(2, 1, 64, 1, 256, 16, 64)       # 64 rows a head
    assert p.route == "decode"
    assert p.smem_bytes <= 232_448 and (p.warps, p.stages) < (4, 4)
    assert p.stages % p.warps == 0
    with pytest.raises(ValueError, match="query rows a kv head"):
        kva.int8_kv_plan(2, 1, 512, 1, 256, 16, 64)       # 512 rows
    for S in (8, 64):
        r = kva.int8_kv_plan(2, S, 64, 8, 256, 16, 64)
        assert r.route == "rows" and r.smem_bytes <= 232_448
    with pytest.raises(ValueError, match="bs % 8"):
        kva.int8_kv_plan(2, 1, 8, 8, 128, 12, 64)


# (B, S, H, KH, D, bs, M, sm_count) -> the decode route's plan before the
# many-row route existed, every field
_S1_PLANS = {
    (8, 1, 32, 32, 128, 16, 128, 132): (256, 16, 16, 1, 32, 8, 4, 4, 160,
                                        39224, 8, 2, (4, 32, 8), 266240, 256),
    (1, 1, 32, 32, 128, 16, 128, 132): (256, 16, 16, 1, 32, 8, 4, 4, 160,
                                        39224, 8, 1, (8, 32, 1), 33280, 32),
    (8, 1, 32, 8, 128, 16, 128, 132): (256, 16, 16, 1, 32, 8, 4, 4, 160,
                                       47008, 8, 1, (8, 8, 8), 266240, 64),
    (3, 1, 8, 8, 64, 8, 40, 132): (256, 32, 8, 1, 32, 8, 4, 4, 160, 23672,
                                   2, 1, (2, 8, 3), 3168, 24),
    (2, 1, 64, 8, 256, 16, 64, 132): (256, 16, 16, 1, 32, 8, 4, 4, 160,
                                      110640, 4, 1, (4, 8, 2), 132096, 16),
    (4, 1, 4, 2, 64, 72, 9, 132): (288, 4, 32, 3, 32, 12, 4, 4, 160, 21800,
                                   3, 1, (3, 2, 4), 3168, 8),
    (33, 1, 8, 2, 256, 24, 300, 66): (264, 11, 24, 1, 24, 11, 4, 4, 160,
                                      72208, 28, 2, (14, 2, 33), 1907136,
                                      66),
}


@pytest.mark.parametrize("shape", sorted(_S1_PLANS))
def test_s1_plan_is_unchanged_field_by_field(shape):
    """S = 1 keeps the decode route with exactly its earlier plan (the 7B
    decode and the serving mix at batch 8 and 1 among the shapes)."""
    p = kva.int8_kv_plan(*shape)
    assert isinstance(p, kva.KvPlan) and p.route == "decode"
    assert p._fields == ("chunk", "chunk_blocks", "box_slots",
                         "boxes_a_block", "tile_slots", "tiles", "warps",
                         "stages", "threads", "smem_bytes", "chunks",
                         "chunks_a_block", "grid", "ws_floats", "tickets")
    for name, got, want in zip(p._fields, tuple(p), _S1_PLANS[shape]):
        assert got == want, (name, got, want)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [2, 5, 17, 64, 256, 2048])
def test_rows_plan_takes_every_s_above_one(S, R, D):
    """Every S > 1 plans the many-row route: a 16-row slab a warp (two
    at head_dim 256), 8 slabs a block above 64 query rows a kv head (256
    threads), 4 above 32, 2 above 16, else 1 (128 threads; at most 2 at
    head_dim 256); 64-slot key tiles, 256-slot chunks; a grid that
    covers the S*R rows of each kv head once for every chunk group;
    shared memory as the kernel lays it out, within a block's 232,448
    bytes, for bf16 queries (one piece, in registers up to head_dim 128)
    and f32 (three pieces in shared memory)."""
    KH, B, bs, M = 4, 3, 16, 129
    SR = S * R
    for dt, pieces in ((torch.bfloat16, 1), (torch.float32, 3)):
        w = 8 if SR > 64 else 4 if SR > 32 else 2 if SR > 16 else 1
        w = min(w, 2) if D == 256 else w
        p = kva.int8_kv_plan(B, S, KH * R, KH, D, bs, M, q_dtype=dt)
        assert p.route == "rows"
        assert (p.q_tile, p.warps, p.threads, p.q_pieces) == (
            16 * w, w, 256 if w == 8 else 128, pieces)
        assert (p.key_tile, p.chunk) == (kva.KV_ROW_KEYS, kva.KV_ROW_CHUNK) \
            == (64, 256)
        assert p.chunks == -(-(M * bs) // 256) == 9
        groups = -(-p.chunks // p.chunks_a_block)
        assert p.chunks_a_block in (1, p.chunks)
        assert p.grid == (-(-SR // p.q_tile) * groups, KH, B)
        q = 0 if pieces == 1 and D <= 128 else pieces * 32 * w * (D + 8)
        assert 2 <= p.stages <= 4
        assert p.smem_bytes == (p.stages * (128 * D + 512)
                                + 256 * (D + 8) + 512 + q + 16)
        assert p.smem_bytes <= 232_448
        assert p.launch() == (p.q_tile, p.stages, p.threads, p.smem_bytes,
                              9, p.chunks_a_block, p.grid[0])


def test_rows_plan_splits_verify_blocks_from_the_shape_alone():
    """The split is pure arithmetic on the shape: the 7B's verify block
    (B 8, S 5: 256 row tiles, fewer than the 396 blocks three an SM fill)
    runs one chunk a block over a workspace of chunk states and a ticket
    a row tile; its cold prefill (B 1, S 2,048) and warm suffix (B 4, S
    256) run every chunk of a row tile in one block, with no workspace.
    At head_dim 128 a bf16 prefill block of 8 slabs (one an SM: its
    registers) takes a four-stage ring and 102,928 bytes; a verify block
    of one slab a two-stage ring and 69,136 bytes (three an SM, at most
    168 registers a thread); a row tile of more than one chunk keeps its
    running acc in the workspace."""
    verify = kva.int8_kv_plan(8, 5, 32, 32, 128, 16, 128)
    assert (verify.q_tile, verify.warps, verify.stages) == (16, 1, 2)
    assert verify.smem_bytes == 69_136
    assert (verify.chunks, verify.chunks_a_block) == (8, 1)
    assert verify.grid == (8, 32, 8)
    assert verify.ws_floats == 8 * 32 * 8 * 16 * 130
    assert verify.tickets == 8 * 32
    cold = kva.int8_kv_plan(1, 2048, 32, 32, 128, 16, 128)
    assert (cold.q_tile, cold.threads, cold.stages, cold.smem_bytes) == (
        128, 256, 4, 102_928)
    assert (cold.chunks, cold.chunks_a_block, cold.grid) == (8, 8,
                                                             (16, 32, 1))
    assert (cold.ws_floats, cold.tickets) == (16 * 32 * 128 * 128, 0)
    warm = kva.int8_kv_plan(4, 256, 32, 32, 128, 16, 128)
    assert (warm.chunks_a_block, warm.grid, warm.ws_floats) == (
        8, (2, 32, 4), 2 * 32 * 4 * 128 * 128)
    # the same shapes plan the same whatever the data: the function
    # takes no positions, and a card of fewer SMs splits sooner
    assert kva.int8_kv_plan(8, 5, 32, 32, 128, 16, 128) == verify
    small = kva.int8_kv_plan(4, 256, 32, 32, 128, 16, 128, sm_count=600)
    assert small.chunks_a_block == 1 and small.grid == (16, 32, 4)
    assert small._replace(chunks_a_block=None, grid=None, ws_floats=None,
                          tickets=None) == warm._replace(
        chunks_a_block=None, grid=None, ws_floats=None, tickets=None)



@pytest.mark.parametrize("B,S", [(8, 5), (1, 2048), (4, 256)])
def test_rows_plan_other_fold_changes_only_the_split(B, S):
    """``_rows_plan``'s ``chunks_a_block`` (phase 36 (a) times the fold
    the plan does not pick): forced to the plan's own value it gives the
    plan; forced the other way it changes the chunks a block, the grid,
    the workspace and the tickets, and nothing else."""
    plan = kva.int8_kv_plan(B, S, 32, 32, 128, 16, 128)
    args = (B, S, 32, 32, 128, 16, 128, kva.H100_SMS, 1)
    assert kva._rows_plan(*args, chunks_a_block=plan.chunks_a_block) == plan
    K = 1 if plan.chunks_a_block > 1 else plan.chunks
    other = kva._rows_plan(*args, chunks_a_block=K)
    row_tiles = -(-S // plan.q_tile)
    items = row_tiles * 32 * B
    assert other.chunks_a_block == K
    assert other.grid == (row_tiles * -(-plan.chunks // K), 32, B)
    split = K < plan.chunks
    assert other.tickets == (items if split else 0)
    assert other.ws_floats == (items * plan.chunks * plan.q_tile * 130
                               if split else items * plan.q_tile * 128)
    assert other._replace(chunks_a_block=None, grid=None, ws_floats=None,
                          tickets=None) == plan._replace(
        chunks_a_block=None, grid=None, ws_floats=None, tickets=None)

# (last positions, S, G, R, D, bs, M): a suffix starting past 0, GQA, a
# ragged last block, a block size that does not divide the key tile
_ROWS_CASES = {
    "suffix_s64_start_above_0": ([150, 100], 64, 2, 1, 64, 16, 12),
    "rows_cross_chunk_boundaries": ([530, 600], 48, 2, 1, 64, 16, 40),
    "verify_block_split_over_blocks": ([700, 300], 5, 2, 1, 128, 16, 48),
    "gqa_r4": ([77, 40], 16, 1, 4, 64, 8, 12),
    "ragged_last_block": ([60, 33], 20, 2, 2, 128, 16, 5),
    "bs24_crosses_key_tiles": ([140, 71], 8, 2, 2, 64, 24, 7),
    "verify_and_idle_row": ([90, -1], 5, 2, 2, 256, 16, 7),
}


@pytest.mark.parametrize("name", sorted(_ROWS_CASES))
def test_rows_ref_matches_jax(name):
    last, S, G, R, D, bs, M = _ROWS_CASES[name]
    args, G = _case(8, last, S, G, R, D, bs, M)
    plan = kva.int8_kv_plan(len(last), S, G * R, G, D, bs, M,
                            q_dtype=torch.float32)
    if name == "verify_block_split_over_blocks":
        assert plan.chunks == 3 and plan.chunks_a_block == 1
    if name == "rows_cross_chunk_boundaries":
        assert last[0] - S + 1 < 512 < last[0]
    jargs = [jnp.asarray(a) for a in args]
    ker = np.asarray(jkv.int8_paged_attention(*jargs, G, interpret=True))
    xref = np.asarray(jkv.paged_attention_ref(*jargs, G))
    got = kva.paged_attention_rows_ref(*[torch.from_numpy(a) for a in args],
                                       G)
    atol, rtol, _ = kva.CARD_TOL[torch.float32]
    assert got.shape == ker.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ker, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.numpy(), xref, atol=atol, rtol=rtol)


def test_rows_ref_row_bits_do_not_depend_on_s():
    """A row gives the same bits whether it comes in a cold call (all
    positions from 0), a warm suffix or a verify block: the model's
    chunks and key tiles sit at absolute slots and its order is the
    row's own.  The second case's rows reach into a third chunk, and its
    verify block of 5 is one the plan splits over blocks (one chunk a
    block)."""
    for seed, S, M, los in ((9, 100, 13, (40, 97)),
                            (11, 560, 72, (300, 555))):
        args, G = _case(seed, [S - 1, S - 1], S, 2, 2 if S == 100 else 1,
                        64, 8, M)
        t = [torch.from_numpy(a) for a in args]
        cold = kva.paged_attention_rows_ref(*t, G)
        for lo in los:
            if S - lo == 5:
                plan = kva.int8_kv_plan(2, 5, 2, 2, 64, 8, M,
                                        q_dtype=torch.float32)
                assert plan.chunks == 3 and plan.chunks_a_block == 1
            part = kva.paged_attention_rows_ref(
                t[0][:, lo:].clone(), *t[1:6], t[6][:, lo:].clone(), G)
            assert torch.equal(part, cold[:, lo:]), (S, lo)


# ---------------------------------------------------------------------
# the launcher, with a recording library
# ---------------------------------------------------------------------

class _RecordingLib:
    def __init__(self):
        self.calls = []
        outer = self

        class _Fn:
            argtypes = None

            def __call__(self, *args):
                outer.calls.append(args)
                return 0

        self.int8_kv_attention = _Fn()


@pytest.fixture
def recording_lib(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kva, "_workspaces", {})
    registry.reset_counts()
    return lib


def test_launcher_passes_the_plan_and_keeps_its_workspace(recording_lib):
    """Each call reaches ``int8_kv_attention`` with the tensors, sizes,
    q's strides, the plan's six ints (one array a shape) and one
    workspace a stream: a second call of the shape allocates none; its
    tickets start at zero."""
    args, G = _case(6, [600, 40, -1], 1, 2, 2, 128, 16, 40)
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].transpose(1, 2).contiguous().transpose(1, 2)   # strided q
    B, S, H, D = t[0].shape
    outs = [kva._int8_kv_cuda(*t, G) for _ in range(2)]
    plan = kva.int8_kv_plan(B, S, H, G, D, 16, 40)
    first, second = recording_lib.calls
    assert first[21] is second[21]
    assert tuple(first[21]) == plan.launch() == (256, 4, 4, 160,
                                                 plan.smem_bytes, 3, 1)
    assert first[8:10] == second[8:10]           # the same workspace
    ws, tickets = kva._workspaces[(t[0].device, 0)]
    assert (ws.data_ptr(), tickets.data_ptr()) == first[8:10]
    assert ws.numel() == plan.ws_floats == B * G * 3 * 2 * 130
    assert tickets.numel() == B * G and not tickets.any()
    for call in recording_lib.calls:
        assert len(call) == 25
        assert len(recording_lib.int8_kv_attention.argtypes) == 25
        assert call[10:18] == (B, S, H, G, D, 16, 40, args[1].shape[0])
        assert call[18:21] == t[0].stride()[:3]
        assert call[22] == pytest.approx(D ** -0.5) and call[23] == 0
        assert call[0] == t[0].data_ptr()
    assert outs[0].shape == (B, S, G, H // G, D)
    assert registry.launch_counts()["int8_kv_attention"] == 2


def test_launcher_grows_its_workspace_for_a_wider_table(recording_lib):
    small, G = _case(7, [600, 40], 1, 2, 2, 128, 16, 40)
    wide, _ = _case(7, [1500, 40], 1, 2, 2, 128, 16, 96)
    for args in (small, wide, small):
        kva._int8_kv_cuda(*[torch.from_numpy(a) for a in args], G)
    a, b, c = recording_lib.calls
    assert a[8] != b[8] and b[8:10] == c[8:10]
    assert kva._workspaces[(torch.device("cpu"), 0)][0].numel() == \
        kva.int8_kv_plan(2, 1, 4, 2, 128, 16, 96).ws_floats


def test_launcher_sends_s_above_one_to_the_rows_entry(recording_lib):
    """A verify block reaches ``int8_kv_attention_rows`` with the tensors,
    the stream's workspace (its plan splits the keys: chunk states and
    tickets), sizes, q's strides and the rows plan's seven ints; a cold
    call of the same sequences takes the workspace for its running accs
    and no ticket.  The launches count
    under the route ``rows``, an S = 1 call's under ``decode``."""
    calls = []

    class _Fn:
        argtypes = None

        def __call__(self, *a):
            calls.append(a)
            return 0

    recording_lib.int8_kv_attention_rows = _Fn()
    args, G = _case(10, [300, 41], 5, 2, 2, 128, 16, 20)
    t = [torch.from_numpy(a) for a in args]
    out = kva._int8_kv_cuda(*t, G)
    B, S, H, D = t[0].shape
    plan = kva.int8_kv_plan(B, S, H, G, D, 16, 20, q_dtype=torch.float32)
    (call,) = calls
    assert len(call) == 25 == len(recording_lib.int8_kv_attention_rows
                                  .argtypes)
    assert call[0] == t[0].data_ptr()
    ws, tickets = kva._workspaces[(t[0].device, 0)]
    assert call[8:10] == (ws.data_ptr(), tickets.data_ptr())
    assert ws.numel() == plan.ws_floats == B * G * 2 * 16 * 130
    assert tickets.numel() == plan.tickets == B * G and not tickets.any()
    assert call[10:21] == (B, S, H, G, D, 16, 20, args[1].shape[0],
                           *t[0].stride()[:3])
    assert tuple(call[21]) == plan.launch() == (16, plan.stages, 128,
                                                plan.smem_bytes, 2, 1, 2)
    assert call[22] == pytest.approx(D ** -0.5) and call[23] == 0
    assert out.shape == (B, S, G, H // G, D)
    # 5 row tiles x 32 kv heads x 2 sequences fill the card's 132
    cold, G = _case(10, [700, 650], 600, 32, 1, 128, 16, 50)
    cold[0] = torch.from_numpy(cold[0]).to(torch.bfloat16)
    kva._int8_kv_cuda(*[a if torch.is_tensor(a) else torch.from_numpy(a)
                        for a in cold], G)
    cplan = kva.int8_kv_plan(2, 600, 32, 32, 128, 16, 50)
    assert cplan.tickets == 0 and cplan.q_pieces == 1
    assert cplan.ws_floats == 2 * 32 * 5 * 128 * 128
    ws, _ = kva._workspaces[(t[0].device, 0)]
    assert calls[1][8] == ws.data_ptr() and ws.numel() >= cplan.ws_floats
    assert tuple(calls[1][21]) == cplan.launch() and calls[1][23] == 1
    one, _ = _case(10, [300, 41], 1, 2, 2, 128, 16, 20)
    kva._int8_kv_cuda(*[torch.from_numpy(a) for a in one], G)
    assert registry.spec("int8_kv_attention").mode_launches == {
        "rows": 2, "decode": 1}

