"""Kernel 4 (int8 paged attention) in plain PyTorch, and its launch
plan.

Every call, S = 1 (decode and draft steps) or S > 1 (verify blocks,
prefix-sharing suffix prefills), takes one CUDA kernel with one
arithmetic, whose order of operations ``paged_attention_rows_ref``
models: 256-slot chunks, each folded from a fresh state over 64-slot key
tiles at fixed absolute slots, then folded in chunk order; the query's
and p * v_scale's bf16 pieces as f32 sums of their products; the quad
lanes' order of sums.  Here it is held to the reference's Pallas kernel
(``_int8_kv_attn_kernel``, interpret mode) and to the reference's XLA
``paged_attention_ref`` within ``CARD_TOL[f32]`` on the cases the
chunks make hard -- a chunk boundary inside a sequence, sequences of one
chunk and of several, a verify row whose position lies before a live
chunk, idle trash rows, GQA, every head dim, decode steps among them --
and a row's bits are held not to depend on S, on the batch or on the
table's width: a decode step's row is bitwise the same row of a verify
block.  ``int8_kv_plan`` is pure arithmetic (the S = 1 plan is checked
field by field at the 7B decode and the serving shapes), and the
launcher is checked with a recording library in place of the CUDA one.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``).
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain models here are loops of tiny torch ops: one intra-op
    thread keeps them from spinning against the other test processes of
    a parallel run (each op's parallel region waits on descheduled
    threads), without changing what they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# (last positions, S, G, R, D, bs, M): decode steps (S = 1) and short
# verify blocks over a few blocks of 8 or 16 slots; the second
# sequence's rows and the first's reach past a 256-slot chunk where
# their positions do
_DECODE_CASES = {
    "boundary_inside_a_sequence": ([260, 40], 1, 2, 2, 64, 8, 36),
    "one_chunk_and_several": ([15, 530], 1, 2, 2, 64, 8, 70),
    "verify_row_masked_in_a_live_chunk": ([256, 33], 3, 2, 1, 64, 8, 36),
    "trash_rows": ([30, -1, -1], 1, 2, 2, 64, 8, 6),
    "gqa_r4": ([23, 9], 1, 1, 4, 64, 8, 5),
    "d128": ([300, 17], 1, 2, 2, 128, 16, 20),
    "d256": ([25, 3], 1, 1, 2, 256, 8, 4),
    "bs_40": ([44, 30], 2, 2, 1, 64, 40, 2),
}


@pytest.mark.parametrize("name", sorted(_DECODE_CASES))
def test_rows_ref_matches_jax_at_decode_shapes(name):
    last, S, G, R, D, bs, M = _DECODE_CASES[name]
    args, G = _case(3, last, S, G, R, D, bs, M)
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


def test_rows_ref_is_batch_invariant():
    """A sequence's result does not depend on its batch or on the table's
    width: alone through a table just wide enough, it is bitwise equal to
    its row inside the batch, at S = 1 and S = 2."""
    for S in (1, 2):
        args, G = _case(5, [300, 17, 33], S, 2, 2, 64, 8, 40)
        t = [torch.from_numpy(a) for a in args]
        full = kva.paged_attention_rows_ref(*t, G)
        for i, m in ((0, 38), (1, 3), (2, 5)):
            alone = kva.paged_attention_rows_ref(
                t[0][i:i + 1], t[1], t[2], t[3], t[4], t[5][i:i + 1, :m],
                t[6][i:i + 1], G)
            assert torch.equal(alone[0], full[i]), (S, i)


# (last position, G, R, D, bs, M): a decode step's row and the same
# position inside a verify block of 5 (as the row's first, middle or
# last position) must have the same bits
_S1_IN_BLOCK = {
    "7b_like_r1_bf16": (300, 2, 1, 128, 16, 24, torch.bfloat16),
    "gqa_r4_f32": (530, 1, 4, 64, 8, 70, torch.float32),
    "d256_f32": (70, 1, 2, 256, 16, 6, torch.float32),
    "first_chunk_only_bf16": (40, 2, 2, 64, 8, 8, torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(_S1_IN_BLOCK))
def test_rows_ref_s1_row_is_its_row_in_a_verify_block(name):
    """The repaired fault's contract in the model: a row computed alone
    (S = 1, a decode or draft step) is bitwise the row at that position
    of an S = 5 verify block (the verify block's rows at other positions
    change nothing).  The kernel takes every S through one plan family,
    so the card holds the same (``tests/test_torch_cuda.py``)."""
    last, G, R, D, bs, M, dt = _S1_IN_BLOCK[name]
    args, G = _case(13, [last, last - 7], 5, G, R, D, bs, M)
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(dt)
    block = kva.paged_attention_rows_ref(*t, G)
    for j in range(5):
        one = kva.paged_attention_rows_ref(
            t[0][:, j:j + 1].clone(), *t[1:6], t[6][:, j:j + 1].clone(), G)
        assert torch.equal(one[:, 0], block[:, j]), (name, j)
        assert kva.int8_kv_plan(2, 1, G * R, G, D, bs, M,
                                q_dtype=dt).route == "rows"


# ---------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("bs", [8, 16, 24, 40, 64, 72, 128, 256])
def test_s1_plan_takes_the_rows_kernel(bs, R):
    """S = 1 plans the one kernel every S takes (the card plan is pure
    Python): one 16-row slab (R live rows), 64-slot key tiles and
    256-slot chunks whatever the block size, the table's slots cut into
    ceil(M bs / 256) chunks; the same plan as the rows of an S > 1 call
    of R rows or fewer a kv head, and the keys split one chunk a block
    where the row tiles leave the card idle."""
    B, H, KH, D, M = 3, 8 * R, 8, 128, 50
    for dt in (torch.bfloat16, torch.float32):
        p = kva.int8_kv_plan(B, 1, H, KH, D, bs, M, q_dtype=dt)
        assert isinstance(p, kva.KvRowsPlan) and p.route == "rows"
        assert (p.q_tile, p.warps, p.key_tile, p.chunk) == (16, 1, 64, 256)
        assert p.chunks == -(-(M * bs) // 256)
        assert p.chunks_a_block == 1 and p.grid == (p.chunks, KH, B)
        assert p.tickets == B * KH
        assert p.ws_floats == B * KH * p.chunks * 16 * (D + 2)
        if R == 1:
            block = kva.int8_kv_plan(B, 16, H, KH, D, bs, M, q_dtype=dt)
            assert block._replace(grid=None) == p._replace(grid=None)


def test_plan_at_the_7b_decode():
    """B 8, one query, 32 heads and kv heads, head_dim 128, bs 16, a
    2,048-token table: one 16-row slab a block (one live row), a
    two-stage ring, 69,136 bytes (three blocks an SM), the keys split
    one 256-slot chunk a block (the 256 row tiles are fewer than the
    396 blocks three an SM fill) over chunk states and a ticket a row
    tile: the plan of the 7B's verify block but for nothing.  At batch 1
    likewise, over 32 row tiles."""
    p = kva.int8_kv_plan(8, 1, 32, 32, 128, 16, 128)
    verify = kva.int8_kv_plan(8, 5, 32, 32, 128, 16, 128)
    assert p == verify
    assert (p.q_tile, p.warps, p.stages, p.threads) == (16, 1, 2, 128)
    assert p.smem_bytes == 2 * (2 * 64 * 128 + 8 * 64) \
        + 4 * 64 * (128 + 8) + 8 * 64 + 16 == 69_136
    assert (p.chunks, p.chunks_a_block, p.grid) == (8, 1, (8, 32, 8))
    assert (p.ws_floats, p.tickets) == (8 * 32 * 8 * 16 * 130, 256)
    one = kva.int8_kv_plan(1, 1, 32, 32, 128, 16, 128)
    assert (one.chunks_a_block, one.grid, one.tickets) == (1, (8, 32, 1),
                                                           32)


@pytest.mark.parametrize("S,H,KH,D", [(1, 32, 32, 128), (4, 32, 8, 128),
                                      (3, 8, 2, 256), (1, 8, 8, 64)])
def test_plan_of_a_sequence_ignores_batch_and_table_width(S, H, KH, D):
    """Only the chunk count, the chunks a block, the grid and the
    workspace follow B, M and the card: the tiles, chunk, slabs and ring
    do not (and no field changes a row's bits)."""
    plans = [kva.int8_kv_plan(B, S, H, KH, D, 16, M, sm_count=sms)
             for B, M, sms in ((1, 9, 132), (8, 128, 132), (33, 300, 66))]
    assert {p.route for p in plans} == {"rows"}
    assert len({p._replace(chunks=None, chunks_a_block=None, grid=None,
                           ws_floats=None, tickets=None)
                for p in plans}) == 1
    assert [p.grid[1:] for p in plans] == [(KH, 1), (KH, 8), (KH, 33)]
    assert [p.chunks for p in plans] == [1, 8, 19]


def test_plan_trades_warps_and_stages_for_many_query_rows():
    """Many query rows a kv head (a wide GQA group) at head_dim 256 take
    more slabs a block (two at most at head_dim 256) and the deepest ring
    that keeps the blocks an SM, within a block's shared memory, at S = 1
    as at S > 1: no shape raises.  A block size off the multiple of 8
    does."""
    for H in (64, 512):
        p = kva.int8_kv_plan(2, 1, H, 1, 256, 16, 64)
        assert p.route == "rows" and p.warps == 2 and p.q_tile == 32
        assert p.smem_bytes <= 232_448 and 2 <= p.stages <= 4
        assert p.grid[0] == -(-H // 32) * -(-p.chunks // p.chunks_a_block)
    for S in (8, 64):
        r = kva.int8_kv_plan(2, S, 64, 8, 256, 16, 64)
        assert r.route == "rows" and r.smem_bytes <= 232_448
    with pytest.raises(ValueError, match="bs % 8"):
        kva.int8_kv_plan(2, 1, 8, 8, 128, 12, 64)


# (B, S, H, KH, D, bs, M, sm_count) -> the S = 1 plan, every field (the
# 7B decode and the serving mix at batch 8 and 1 among the shapes)
_S1_PLANS = {
    (8, 1, 32, 32, 128, 16, 128, 132): (16, 1, 64, 256, 1, 2, 128, 69136,
                                        8, 1, (8, 32, 8), 4259840, 256),
    (1, 1, 32, 32, 128, 16, 128, 132): (16, 1, 64, 256, 1, 2, 128, 69136,
                                        8, 1, (8, 32, 1), 532480, 32),
    (8, 1, 32, 8, 128, 16, 128, 132): (16, 1, 64, 256, 1, 2, 128, 69136,
                                       8, 1, (8, 8, 8), 1064960, 64),
    (3, 1, 8, 8, 64, 8, 40, 132): (16, 1, 64, 256, 1, 4, 128, 53776, 2, 1,
                                   (2, 8, 3), 50688, 24),
    (2, 1, 64, 8, 256, 16, 64, 132): (16, 1, 64, 256, 1, 4, 128, 209680,
                                      4, 1, (4, 8, 2), 264192, 16),
    (4, 1, 4, 2, 64, 72, 9, 132): (16, 1, 64, 256, 1, 4, 128, 53776, 3, 1,
                                   (3, 2, 4), 25344, 8),
    (33, 1, 8, 2, 256, 24, 300, 66): (16, 1, 64, 256, 1, 4, 128, 209680,
                                      29, 29, (1, 2, 33), 270336, 0),
}


@pytest.mark.parametrize("shape", sorted(_S1_PLANS))
def test_s1_plan_field_by_field(shape):
    """S = 1 plans the one kernel with exactly these fields: one slab, a
    ring of 2-4 stages, the keys split one chunk a block except where the
    row tiles fill the card (the last shape: 66 SMs, 33 sequences)."""
    p = kva.int8_kv_plan(*shape)
    assert isinstance(p, kva.KvRowsPlan) and p.route == "rows"
    assert p._fields == ("q_tile", "warps", "key_tile", "chunk",
                         "q_pieces", "stages", "threads", "smem_bytes",
                         "chunks", "chunks_a_block", "grid", "ws_floats",
                         "tickets")
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

        self.int8_kv_attention_rows = _Fn()


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
    """Each S = 1 call reaches ``int8_kv_attention_rows`` with the
    tensors, sizes, q's strides, the plan's seven ints (one array a
    shape) and one workspace a stream: a second call of the shape
    allocates none; its tickets start at zero."""
    args, G = _case(6, [600, 40, -1], 1, 2, 2, 128, 16, 40)
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].transpose(1, 2).contiguous().transpose(1, 2)   # strided q
    B, S, H, D = t[0].shape
    outs = [kva._int8_kv_cuda(*t, G) for _ in range(2)]
    plan = kva.int8_kv_plan(B, S, H, G, D, 16, 40, q_dtype=torch.float32)
    first, second = recording_lib.calls
    assert first[21] is second[21]
    assert tuple(first[21]) == plan.launch() == (16, plan.stages, 128,
                                                 plan.smem_bytes, 3, 1, 3)
    assert first[8:10] == second[8:10]           # the same workspace
    ws, tickets = kva._workspaces[(t[0].device, 0)]
    assert (ws.data_ptr(), tickets.data_ptr()) == first[8:10]
    assert ws.numel() == plan.ws_floats == B * G * 3 * 16 * 130
    assert tickets.numel() == B * G and not tickets.any()
    for call in recording_lib.calls:
        assert len(call) == 25
        assert len(recording_lib.int8_kv_attention_rows.argtypes) == 25
        assert call[10:18] == (B, S, H, G, D, 16, 40, args[1].shape[0])
        assert call[18:21] == t[0].stride()[:3]
        assert call[22] == pytest.approx(D ** -0.5) and call[23] == 0
        assert call[0] == t[0].data_ptr()
    assert outs[0].shape == (B, S, G, H // G, D)
    assert registry.launch_counts()["int8_kv_attention"] == 2
    assert registry.spec("int8_kv_attention").mode_launches == {"decode": 2}


def test_launcher_grows_its_workspace_for_a_wider_table(recording_lib):
    small, G = _case(7, [600, 40], 1, 2, 2, 128, 16, 40)
    wide, _ = _case(7, [1500, 40], 1, 2, 2, 128, 16, 96)
    for args in (small, wide, small):
        kva._int8_kv_cuda(*[torch.from_numpy(a) for a in args], G)
    a, b, c = recording_lib.calls
    assert a[8] != b[8] and b[8:10] == c[8:10]
    assert kva._workspaces[(torch.device("cpu"), 0)][0].numel() == \
        kva.int8_kv_plan(2, 1, 4, 2, 128, 16, 96,
                         q_dtype=torch.float32).ws_floats


def test_launcher_sends_s_above_one_to_the_rows_entry(recording_lib):
    """A verify block reaches ``int8_kv_attention_rows`` with the tensors,
    the stream's workspace (its plan splits the keys: chunk states and
    tickets), sizes, q's strides and the rows plan's seven ints; a cold
    call of the same sequences takes the workspace for its running accs
    and no ticket.  The launches count under ``rows``, an S = 1 call's
    (the same entry) under ``decode``."""
    calls = recording_lib.calls
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

