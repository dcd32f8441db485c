"""The port's hand-written CUDA kernels against their plain versions on
the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  They import only torch, numpy and the port, so they run on
a machine without JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same comparison at the serving shapes.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import kv_attention as kva
from paddle_tpu_torch.ops.kernels import registry


def _qkv(seed, B=1, H=2, S=256, D=64, Hkv=None):
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    return [rng.standard_normal((B, h, S, D)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


def _kv_case(seed, B=2, S=1, G=2, R=2, D=16, bs=8, M=4, nb=9):
    """Two sequences over int8 pools: row 0 a live sequence inside its
    first block, row 1 an idle decode slot (all-zero table = trash block
    0, position 0)."""
    rng = np.random.default_rng(seed)
    qh = rng.standard_normal((B, S, G * R, D)).astype(np.float32)
    kpool = rng.integers(-127, 128, (nb, bs, G, D)).astype(np.int8)
    vpool = rng.integers(-127, 128, (nb, bs, G, D)).astype(np.int8)
    ks = (rng.random((nb, bs)) * 0.01 + 1e-3).astype(np.float32)
    vs = (rng.random((nb, bs)) * 0.01 + 1e-3).astype(np.float32)
    tbl = np.zeros((B, M), np.int32)
    tbl[0, 0] = 3
    pos = np.array([np.arange(2, 2 + S), np.zeros(S)], np.int32)
    return [qh, kpool, vpool, ks, vs, tbl, pos], G


def _assert_within(got, ref, tol):
    err, share = registry.card_error(got, ref, tol)
    assert share <= 1.0, (err, share, tol)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the serving shapes")
    registry.reset_counts()
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        for D in (64, 128, 256):
            q, k, v = (torch.from_numpy(a).to(dev, dt)
                       for a in _qkv(10, H=4, Hkv=2, S=300, D=D))
            for causal in (True, False):
                o, lse = fa.flash_attention_bhsd(q, k, v, causal=causal,
                                                 return_lse=True)
                _, rl = fa.flash_attention_bhsd(q, k, v, causal=causal,
                                                return_lse=True,
                                                mode="torch_ref")
                # held at the kernel's own key tile (P is rounded to bf16
                # against the running max of each tile)
                ro = fa.flash_attention_blockwise_ref(
                    q, k, v, causal=causal,
                    block_k=fa.flash_fwd_plan(q, k, v).block_k)
                torch.cuda.synchronize()
                _assert_within(o, ro, fa.CARD_TOL[dt])
                assert (lse - rl).abs().max() <= 1e-4
    # bf16 at head_dim 128, the Hopper route: the served (B, S, H, D)
    # views, GQA, ragged lengths (none a multiple of 128 but 256)
    for S, H, Hkv, layout in ((130, 4, 1, "bhsd"), (777, 8, 2, "bshd"),
                              (1000, 4, 4, "bshd"), (256, 2, 2, "bhsd")):
        arrays = _qkv(14, B=2, H=H, Hkv=Hkv, S=S, D=128)
        if layout == "bshd":
            q, k, v = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
                       .to(dev, torch.bfloat16).transpose(1, 2)
                       for a in arrays)
        else:
            q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                       for a in arrays)
        plan = fa.flash_fwd_plan(q, k, v)
        assert plan.route == "tma_wgmma" and all(plan.as_is.values())
        for causal in (True, False):
            o, lse = fa.flash_attention_bhsd(q, k, v, causal=causal,
                                             return_lse=True)
            _, rl = fa.flash_attention_bhsd(q, k, v, causal=causal,
                                            return_lse=True,
                                            mode="torch_ref")
            ro = fa.flash_attention_blockwise_ref(q, k, v, causal=causal,
                                                  block_k=plan.block_k)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(o.float()).all())
            _assert_within(o, ro, fa.CARD_TOL[torch.bfloat16])
            assert (lse - rl).abs().max() <= 1e-3
    for case in (dict(S=1, D=128, bs=16), dict(S=3, D=64, bs=8, M=6)):
        args, G = _kv_case(11, **case)
        for dt in (torch.float32, torch.bfloat16):
            targs = [torch.from_numpy(a).to(dev) for a in args]
            targs[0] = targs[0].to(dt)
            got = kva.int8_paged_attention(*targs, G)
            ref = kva.int8_paged_attention(*targs, G, mode="torch_ref")
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got.float()).all())
            _assert_within(got, ref, kva.CARD_TOL[dt])
    counts = registry.launch_counts()
    assert counts["flash_attention"] > 0 and counts["int8_kv_attention"] > 0


def _kv_batch(seed, last, S, G, R, D, bs, M, dt, dev, nb=None):
    """Sequences whose S queries end at positions ``last`` (-1: an idle
    decode slot, all-zero table and position 0), each over distinct
    random blocks of one int8 pool pair."""
    rng = np.random.default_rng(seed)
    B = len(last)
    nb = nb or B * M + 1
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
    qh = torch.from_numpy(rng.standard_normal((B, S, G * R, D)).astype(
        np.float32)).to(dev, dt)
    return [qh] + [torch.from_numpy(a).to(dev) for a in
                   (kpool, vpool, ks, vs, tbl, pos)], G


@pytest.mark.cuda
def test_int8_kv_chunks_match_plain_on_card():
    """Kernel 4 at S = 1 (decode steps) and S = 3 (verify blocks) at
    256-slot chunk boundaries: a sequence of exactly one chunk, one a
    slot past it, a full table, an idle slot; GQA; every head dim, both
    dtypes, block sizes 16, 8 and 72.  Within CARD_TOL of the plain
    version and bitwise equal on a rerun; so does a block of 64 query
    rows a kv head at head_dim 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the serving shapes")
    registry.reset_counts()
    dev = torch.device("cuda")
    runs = 0
    cases = [(D, dt, 16, 40) for D in (64, 128, 256)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(128, torch.float32, 8, 80), (64, torch.bfloat16, 72, 9)]
    for D, dt, bs, M in cases:
        T = bs * M
        C = kva.KV_ROW_CHUNK
        for S in (1, 3):
            assert kva.int8_kv_plan(4, S, 4, 2, D, bs, M).route == "rows"
            args, G = _kv_batch(30 + D + bs, [C - 1, C + 1, T - 1, -1], S,
                                2, 2, D, bs, M, dt, dev)
            got = kva.int8_paged_attention(*args, G)
            again = kva.int8_paged_attention(*args, G)
            ref = kva.int8_paged_attention(*args, G, mode="torch_ref")
            torch.cuda.synchronize()
            runs += 2
            assert bool(torch.isfinite(got.float()).all()), (D, dt, bs, S)
            assert torch.equal(got, again), (D, dt, bs, S)
            _assert_within(got, ref, kva.CARD_TOL[dt])
    # 64 query rows a kv head at head_dim 256
    args, G = _kv_batch(60, [255, 300, 639], 8, 2, 8, 256, 16, 40,
                        torch.float32, dev)
    plan = kva.int8_kv_plan(3, 8, 16, 2, 256, 16, 40)
    assert plan.route == "rows" and plan.q_tile == 32
    got = kva.int8_paged_attention(*args, G)
    again = kva.int8_paged_attention(*args, G)
    ref = kva.int8_paged_attention(*args, G, mode="torch_ref")
    torch.cuda.synchronize()
    runs += 2
    assert torch.equal(got, again)
    _assert_within(got, ref, kva.CARD_TOL[torch.float32])
    assert registry.launch_counts()["int8_kv_attention"] == runs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_int8_kv_s1_rows_are_their_verify_rows_on_card(D, dt):
    """The invariant speculative decoding rests on: a decode step's row
    (S = 1) is bitwise the row at the same position of a verify block
    of S = k + 1 (k = 1, 4, 7), whichever of the block's rows it is, at
    short and long sequences (one chunk; several, split over blocks) and
    at batch 1 and 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    bs, M = 16, 48
    for B, last in ((8, [700, 40, 255, 256, 300, 17, 600, 760]),
                    (1, [500])):
        for S in (2, 5, 8):
            args, G = _kv_batch(90 + D + S, last, S, 2, 2, D, bs, M, dt,
                                dev)
            qh, kp, vp, ks, vs, tbl, pos = args
            block = kva.int8_paged_attention(*args, G)
            for j in range(S):
                one = kva.int8_paged_attention(
                    qh[:, j:j + 1].clone(), kp, vp, ks, vs, tbl,
                    pos[:, j:j + 1].clone(), G)
                torch.cuda.synchronize()
                assert torch.equal(one[:, 0], block[:, j]), (B, S, j)


def _card_llama(seed, layers=2):
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
    dev = torch.device("cuda")
    m = LlamaForCausalLM(
        llama_tiny(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512,
                   kv_cache_dtype="int8", initializer_range=0.1),
        device=dev, dtype="bfloat16",
        generator=torch.Generator(device=dev).manual_seed(seed))
    m.eval()
    return m


def _card_streams(model, draft, prefix, sample, **kw):
    from paddle_tpu_torch.inference import GenerationServer
    rng = np.random.default_rng(7)
    system = rng.integers(1, 512, 40)
    prompts = [np.concatenate([system, rng.integers(1, 512, n)]).astype(
        np.int32) for n in (3, 17, 60, 101, 9, 33)]
    srv = GenerationServer(model, num_slots=4, block_size=16,
                           max_model_len=256, max_prefill_batch=2,
                           prefix_cache=prefix, draft_model=draft,
                           check_replay=True, request_timeout_s=300.0,
                           **kw).start()
    try:
        outs = []
        for _ in range(2):                       # cold, then warm
            streams = [srv.submit(
                p, max_new_tokens=40, seed=100 + i,
                **({"do_sample": True, "temperature": 0.9, "top_k": 8}
                   if sample else {})) for i, p in enumerate(prompts)]
            outs.append([s.result(timeout=300) for s in streams])
        return outs, srv.stats()
    finally:
        srv.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("sample", [False, True])
def test_speculative_server_is_plain_decode_on_card(prefix, sample):
    """The reference's contract (``tests/test_spec_decode.py``) on the
    card: a speculative server's greedy and seeded-sampling streams are
    those of the same server without a draft, token for token, with
    prefix sharing on and off; with the target as its own draft every
    proposal is accepted (accept rate exactly 1.0); a one-layer draft of
    other weights changes the accept rate, never a token."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    target, other = _card_llama(3), _card_llama(4, layers=1)
    plain, _ = _card_streams(target, None, prefix, sample)
    assert plain[0] == plain[1]
    same, st = _card_streams(target, target, prefix, sample, spec_k=4)
    assert same == plain
    assert st["spec_accept_rate"] == 1.0 and st["spec_proposed"] > 0
    assert st["spec_verify_steps"] < st["tokens_generated"]
    diff, st2 = _card_streams(target, other, prefix, sample, spec_k=3)
    assert diff == plain
    assert st2["spec_accept_rate"] < 1.0


@pytest.mark.cuda
def test_int8_kv_rows_route_on_card():
    """The many-row route (S > 1) at every head dim, f32 and bf16, GQA,
    block sizes 16 and 24 (key tiles crossing blocks): a cold call
    (positions 0..599, three 256-slot chunks), a warm suffix (positions
    300..599) and a verify block (595..599, a plan that splits the keys
    over blocks, one chunk a block) over the same pools and the same q
    rows, each within CARD_TOL of the plain version and bitwise on a
    rerun; the positions they share are bitwise equal between the three
    calls (the row tile, S and the split change the rows' neighbours and
    where their chunks are folded, never their bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    registry.reset_counts()
    dev = torch.device("cuda")
    cases = [(64, torch.float32, 16, 2), (64, torch.bfloat16, 16, 1),
             (128, torch.bfloat16, 16, 1), (128, torch.float32, 24, 4),
             (128, torch.float32, 16, 1), (256, torch.bfloat16, 16, 2),
             (256, torch.float32, 16, 1)]
    for D, dt, bs, R in cases:
        M = 620 // bs + 1
        args, G = _kv_batch(70 + D, [599, 599], 600, 2, R, D, bs, M, dt,
                            dev)
        qh, kp, vp, ks, vs, tbl, pos = args
        plan = kva.int8_kv_plan(2, 5, 2 * R, 2, D, bs, M, q_dtype=dt)
        assert plan.chunks == 3 and plan.chunks_a_block == 1, plan
        outs = {}
        for name, lo in (("cold", 0), ("warm", 300), ("verify", 595)):
            a = [qh[:, lo:].clone(), kp, vp, ks, vs, tbl,
                 pos[:, lo:].clone()]
            got = kva.int8_paged_attention(*a, G)
            again = kva.int8_paged_attention(*a, G)
            ref = kva.int8_paged_attention(*a, G, mode="torch_ref")
            torch.cuda.synchronize()
            assert torch.equal(got, again), (D, dt, name)
            _assert_within(got, ref, kva.CARD_TOL[dt])
            outs[name] = got
        assert torch.equal(outs["warm"], outs["cold"][:, 300:]), (D, dt)
        assert torch.equal(outs["verify"], outs["cold"][:, 595:]), (D, dt)
    assert registry.spec("int8_kv_attention").mode_launches == {
        "rows": 6 * len(cases)}


@pytest.mark.cuda
def test_int8_kv_batch_invariant_on_card():
    """A sequence's output bits do not depend on its batch: alone at
    batch 1 through a table just wide enough, and inside a batch of 8
    through a 128-block table (the serving mix's lengths), the kernel
    gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    last = [1915, 1515, 1039, 715, 348, 143, 79, 32]
    for dt, S in ((torch.bfloat16, 1), (torch.float32, 2)):
        args, G = _kv_batch(50, last, S, 4, 2, 128, 16, 128, dt, dev)
        qh, kp, vp, ks, vs, tbl, pos = args
        full = kva.int8_paged_attention(*args, G)
        for i in (0, 3, 7):
            m = last[i] // 16 + 3
            alone = kva.int8_paged_attention(
                qh[i:i + 1].clone(), kp, vp, ks, vs,
                tbl[i:i + 1, :m].clone(), pos[i:i + 1].clone(), G)
            torch.cuda.synchronize()
            assert torch.equal(alone[0], full[i]), (dt, i)


# (dtype, B, H, Hkv, S, D): every head dim in f32 and bf16, then the
# Hopper route's own cases (bf16, head_dim 128): GQA and ragged, one key
# past a tile, not causal over two batches, a single work item, and more
# work items than SMs.  Each runs causal and not unless it names one.
_BWD_CARD_CASES = [
    *[(dt, 1, H, Hkv, S, D, None) for dt in (torch.float32, torch.bfloat16)
      for D, (H, Hkv, S) in ((64, (4, 2, 300)), (128, (2, 2, 256)),
                             (256, (4, 1, 130)))],
    (torch.bfloat16, 1, 8, 2, 777, 128, True),
    (torch.bfloat16, 1, 4, 4, 130, 128, True),
    (torch.bfloat16, 2, 4, 4, 1000, 128, False),
    (torch.bfloat16, 1, 1, 1, 100, 128, True),
    (torch.bfloat16, 1, 8, 8, 4096, 128, True),
]


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """Both backward kernels through the autograd Function on (B, S, H, D)
    views, as the model passes them: every head dim, f32 and bf16, causal
    or not, GQA and ragged lengths, and the Hopper route's cases; rerun
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the training shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    runs = 0
    for dt, B, H, Hkv, S, D, only in _BWD_CARD_CASES:
        q, k, v = (torch.from_numpy(a).to(dev, dt).transpose(1, 2)
                   .contiguous() for a in _qkv(12, B=B, H=H, Hkv=Hkv, S=S,
                                               D=D))
        g = torch.from_numpy(_qkv(13, B=B, H=H, S=S, D=D)[0]).to(dev, dt)
        for causal in ((True, False) if only is None else (only,)):
            grads = []
            for _ in range(2):
                qq, kk, vv = (t.detach().requires_grad_()
                              for t in (q, k, v))
                o = fa.flash_attention(qq, kk, vv, causal=causal)
                grads.append(torch.autograd.grad(
                    o, (qq, kk, vv), g.transpose(1, 2)))
            runs += 1
            assert all(torch.equal(a, b) for a, b in zip(*grads))
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            o, lse = fa.flash_attention_bhsd(qh, kh, vh, causal=causal,
                                             return_lse=True)
            delta = fa.attention_delta(o, g)
            ref = fa.flash_attention_bwd_blockwise_ref(
                qh, kh, vh, g, lse, delta, causal=causal)
            torch.cuda.synchronize()
            for got, want in zip(grads[0], ref):
                assert bool(torch.isfinite(got.float()).all())
                _assert_within(got.transpose(1, 2), want,
                               fa.CARD_TOL_BWD[dt])
    counts = registry.launch_counts()
    assert runs == 17
    assert counts["flash_attention_bwd_dkv"] == 2 * runs
    assert counts["flash_attention_bwd_dq"] == 2 * runs


# (B, H, Hkv, S, causal, p): the bf16 head_dim-64 Hopper route of kernels
# 2 and 3, with and without dropout, causal and not; ragged lengths (300
# and 130 take dropout under the reference's block rule, 1000 does not);
# GQA 12 over 4; and 288 or 432 work items against 132 SMs (not a
# multiple).  Every forward here runs kernel 1's Hopper route, so the
# backward's regenerated keep bits must be the forward's.
_BWD_D64_CASES = [(2, 12, 12, 256, False, 0.0), (2, 12, 12, 256, True, 0.0),
                  (2, 12, 12, 256, False, 0.1), (2, 12, 12, 256, True, 0.1),
                  (1, 12, 4, 300, True, 0.1), (1, 12, 4, 300, False, 0.0),
                  (1, 4, 4, 130, True, 0.1), (3, 12, 12, 1000, True, 0.0),
                  (3, 12, 12, 1536, False, 0.1)]


@pytest.mark.cuda
def test_backward_d64_hopper_route_matches_plain_on_card():
    """Kernels 2 and 3 on the bf16 head_dim-64 Hopper route (TMA,
    ``wgmma``, the keep mask under the products) through the autograd
    Function on (B, S, H, D) views: dQ, dK and dV within
    ``CARD_TOL_BWD`` of the blockwise plain version with the same seed,
    a rerun bitwise equal, each launch counted (``dropout`` mode with
    dropout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at ERNIE's shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    seed = torch.tensor([2 ** 40 + 77], dtype=torch.int64, device=dev)
    tol = fa.CARD_TOL_BWD[torch.bfloat16]
    drops = 0
    for B, H, Hkv, S, causal, p in _BWD_D64_CASES:
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   .transpose(1, 2).contiguous()
                   for a in _qkv(21, B=B, H=H, Hkv=Hkv, S=S, D=64))
        g = torch.from_numpy(_qkv(22, B=B, H=H, S=S, D=64)[0]).to(
            dev, torch.bfloat16)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        kw = dict(dropout_p=p, seed=seed) if p else {}
        assert fa.flash_bwd_plan(qh, kh, vh, g, causal, **(
            dict(dropout_p=p) if p else {})).route == "tma_wgmma"
        assert fa.flash_fwd_plan(qh, kh, vh, dropout_p=p).route == \
            "tma_wgmma"
        grads = []
        for _ in range(2):
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            o = fa.flash_attention(qq, kk, vv, causal=causal, **kw)
            grads.append(torch.autograd.grad(o, (qq, kk, vv),
                                             g.transpose(1, 2)))
        drops += 2 if p else 0
        assert all(torch.equal(a, b) for a, b in zip(*grads)), (B, S, p)
        o, lse = fa.flash_attention_bhsd(qh, kh, vh, causal=causal,
                                         return_lse=True, **kw)
        delta = fa.attention_delta(o, g)
        ref = fa.flash_attention_bwd_blockwise_ref(
            qh, kh, vh, g, lse, delta, causal=causal, **kw)
        torch.cuda.synchronize()
        for got, want in zip(grads[0], ref):
            assert bool(torch.isfinite(got.float()).all())
            _assert_within(got.transpose(1, 2), want, tol)
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        spec = registry.spec(name)
        assert spec.launches == 2 * len(_BWD_D64_CASES)
        assert spec.mode_launches == {"dropout": drops}


def _bias_row(seed, B, S, dt, dev):
    """A [B, 1, 1, S] padding row: 0 on each sequence's first keys (at
    least half), -1e9 on the rest, plus small finite values at the
    start (a bias is not only a mask)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(S // 2, S + 1, B)
    row = np.where(np.arange(S)[None, :] < n[:, None], 0.0, -1e9)
    row[:, :5] += rng.standard_normal((B, 5))
    return torch.from_numpy(row.astype(np.float32)[:, None, None, :]).to(
        dev, dt)


@pytest.mark.cuda
def test_dropout_keep_mask_bitwise_on_card():
    """The device header's keep mask (its debug entry, one element a
    thread) bitwise against the plain ``dropout_keep_mask`` on blocks at
    even and odd offsets; the keep rate within 5 sigma of 1 - p."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    seed = torch.tensor([2 ** 41 + 3], dtype=torch.int64, device=dev)
    for B, H, Sq, Sk, q0, k0, p in ((2, 3, 64, 64, 0, 0, 0.1),
                                    (1, 2, 33, 65, 7, 3, 0.3),
                                    (8, 12, 16, 2048, 2040, 0, 0.1)):
        got = fa.dropout_keep_mask_cuda(seed, B, H, Sq, Sk, p, q0, k0)
        want = fa.dropout_keep_mask(seed, B, H, Sq, Sk, p, q0, k0)
        assert torch.equal(got, want)
    m = fa.dropout_keep_mask_cuda(seed, 4, 4, 512, 512, 0.1)
    sigma = (0.1 * 0.9 / m.numel()) ** 0.5
    assert abs(m.double().mean().item() - 0.9) <= 5 * sigma


@pytest.mark.cuda
def test_flash_bias_row_matches_plain_on_card():
    """Kernel 1 with a [B, 1, 1, S] bias row (bf16 on the Hopper route at
    head_dim 64, on ``mma.sync`` at 128 and 256; f32 3xTF32), causal or not,
    GQA and a ragged length, against the plain versions at the kernel's
    key tile; a rerun bitwise equal; each launch counted as ``bias``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the translation shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    runs = 0
    for dt in (torch.bfloat16, torch.float32):
        for D in (64, 128, 256):
            q, k, v = (torch.from_numpy(a).to(dev, dt)
                       for a in _qkv(15, B=2, H=4, Hkv=2, S=300, D=D))
            bias = _bias_row(16, 2, 300, dt, dev)
            plan = fa.flash_fwd_plan(q, k, v, bias=bias)
            assert plan.route == (
                "tf32x3" if dt == torch.float32 else "tma_wgmma" if D == 64
                else "mma_sync")
            for causal in (True, False):
                o = fa.flash_attention_bhsd(q, k, v, bias=bias,
                                            causal=causal)
                again = fa.flash_attention_bhsd(q, k, v, bias=bias,
                                                causal=causal)
                ro = (fa.flash_attention_blockwise_ref(
                    q, k, v, bias=bias, causal=causal, block_k=plan.block_k)
                    if dt == torch.bfloat16 else fa.flash_attention_ref(
                        q, k, v, bias=bias, causal=causal))
                torch.cuda.synchronize()
                assert torch.equal(o, again)
                assert bool(torch.isfinite(o.float()).all())
                _assert_within(o, ro, fa.CARD_TOL[dt])
                runs += 2
    spec = registry.spec("flash_attention")
    assert spec.launches == runs and spec.mode_launches == {"bias": runs}


@pytest.mark.cuda
def test_flash_bias_row_shared_by_the_batch_on_card():
    """A [1, 1, 1, S] bias row under a batch of 3 (what a padding mask
    shared by the batch gives): kernel 1 reads it with batch stride 0 and
    equals, bitwise, the launch with the row copied to every batch entry;
    its gradient is the batch's sum of the copied rows' (bf16 and f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(a).to(dev, dt)
                   for a in _qkv(19, B=3, H=4, S=300, D=64))
        row = _bias_row(20, 1, 300, dt, dev)
        full = row.expand(3, 1, 1, 300).contiguous()
        o = fa.flash_attention_bhsd(q, k, v, bias=row)
        want = fa.flash_attention_bhsd(q, k, v, bias=full)
        torch.cuda.synchronize()
        assert torch.equal(o, want)
        g = torch.ones_like(o)
        b1, b3 = row.clone().requires_grad_(), full.clone().requires_grad_()
        (d1,) = torch.autograd.grad(
            fa.flash_attention_bhsd(q, k, v, bias=b1), b1, g)
        (d3,) = torch.autograd.grad(
            fa.flash_attention_bhsd(q, k, v, bias=b3), b3, g)
        assert d1.shape == row.shape
        # f32: the same sums in another order; bf16: two roundings to bf16
        tol = 1e-5 if dt == torch.float32 else 1e-2
        torch.testing.assert_close(d1.float(), d3.float().sum(0, True),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_dropout_matches_plain_on_card():
    """Kernels 1-3 with in-kernel dropout through the autograd Function
    (p = 0.1, one seed): every head dim in bf16 (the forward's Hopper
    route at head_dim 64, ``mma.sync`` at 128 and 256) and f32 (3xTF32
    forward, FMA backward),
    causal or not, GQA; the forward and the three gradients against the
    plain versions with the same seed (bf16: the blockwise ones, the
    forward's at its key tile); a rerun bitwise equal; each launch
    counted as ``dropout``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the pretraining shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    seed = torch.tensor([12345], dtype=torch.int64, device=dev)
    runs = 0
    for dt in (torch.bfloat16, torch.float32):
        for D in (64, 128, 256):
            q, k, v = (torch.from_numpy(a).to(dev, dt)
                       for a in _qkv(17, B=2, H=4, Hkv=2, S=256, D=D))
            g = torch.from_numpy(_qkv(18, B=2, H=4, S=256, D=D)[0]).to(
                dev, dt)
            for causal in (True, False):
                outs = []
                for _ in range(2):
                    qq, kk, vv = (t.detach().requires_grad_()
                                  for t in (q, k, v))
                    o = fa.flash_attention_bhsd(qq, kk, vv, causal=causal,
                                                dropout_p=0.1, seed=seed)
                    outs.append((o, *torch.autograd.grad(o, (qq, kk, vv),
                                                         g)))
                runs += 2
                assert all(torch.equal(a, b) for a, b in zip(*outs))
                kw = dict(causal=causal, dropout_p=0.1, seed=seed)
                ro, lse = fa.flash_attention_ref(q, k, v, return_lse=True,
                                                 **kw)
                if dt == torch.bfloat16:
                    ro = fa.flash_attention_blockwise_ref(
                        q, k, v, block_k=fa.flash_fwd_plan(
                            q, k, v, dropout_p=0.1).block_k, **kw)
                delta = fa.attention_delta(outs[0][0].detach(), g)
                args = (q, k, v, g, lse, delta)
                ref = (fa.flash_attention_bwd_blockwise_ref(*args, **kw)
                       if dt == torch.bfloat16 else
                       (fa.flash_attention_bwd_dq_ref(*args, **kw),
                        *fa.flash_attention_bwd_dkv_ref(*args, **kw)))
                torch.cuda.synchronize()
                _assert_within(outs[0][0], ro, fa.CARD_TOL[dt])
                for got, want in zip(outs[0][1:], ref):
                    assert bool(torch.isfinite(got.float()).all())
                    _assert_within(got, want, fa.CARD_TOL_BWD[dt])
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert registry.spec(name).mode_launches == {"dropout": runs}


@pytest.mark.cuda
def test_flash_f32_tf32x3_route_on_card():
    """Kernel 1's f32 route (3xTF32 on the tensor cores) at head_dim 64,
    128 and 256, causal or not, grouped-query (4 heads over 2), a ragged
    length (300: the last query and key tiles cut), without an option and
    with a bias row, also one row shared by the batch: within
    ``CARD_TOL[f32]`` of the chunked plain version, its LSE within 1e-4,
    bitwise on a rerun, the shared row bitwise its copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the translation shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    runs = biased = 0
    for D in (64, 128, 256):
        q, k, v = (torch.from_numpy(a).to(dev)
                   for a in _qkv(24, B=3, H=4, Hkv=2, S=300, D=D))
        row = _bias_row(25, 3, 300, torch.float32, dev)
        plan = fa.flash_fwd_plan(q, k, v, bias=row)
        assert (plan.route, plan.block_q, plan.block_k) == (
            "tf32x3", 64, 64 if D == 64 else 32)
        for causal in (True, False):
            for bias in (None, row, row[:1]):
                o, lse = fa.flash_attention_bhsd(q, k, v, bias=bias,
                                                 causal=causal,
                                                 return_lse=True)
                again = fa.flash_attention_bhsd(q, k, v, bias=bias,
                                                causal=causal)
                ro, rl = fa.flash_attention_ref(q, k, v, bias=bias,
                                                causal=causal,
                                                return_lse=True)
                torch.cuda.synchronize()
                assert torch.equal(o, again)
                _assert_within(o, ro, fa.CARD_TOL[torch.float32])
                assert (lse - rl).abs().max() <= 1e-4
                runs += 2
                biased += 0 if bias is None else 2
            shared = fa.flash_attention_bhsd(q, k, v, bias=row[:1],
                                             causal=causal)
            copied = fa.flash_attention_bhsd(
                q, k, v, bias=row[:1].expand(3, 1, 1, 300).contiguous(),
                causal=causal)
            torch.cuda.synchronize()
            assert torch.equal(shared, copied)
            runs += 2
            biased += 2
    spec = registry.spec("flash_attention")
    assert spec.launches == runs and spec.mode_launches == {"bias": biased}


@pytest.mark.cuda
def test_flash_f32_dropout_keeps_the_backward_set_on_card():
    """Kernel 1's f32 route with dropout keeps exactly the scores the f32
    backward (kernels 2 and 3, FMA) keeps, from the same seed, and both
    the keep mask's: with S = head_dim and V the identity, the forward's
    output is the dropped weights (zero where dropped), and with dO the
    identity dV is their transpose; at head_dim 64 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    registry.reset_counts()
    dev = torch.device("cuda")
    seed = torch.tensor([2 ** 40 + 9], dtype=torch.int64, device=dev)
    for D in (64, 128):
        B, H = 2, 4
        q, k, _ = (torch.from_numpy(a).to(dev) * 0.5
                   for a in _qkv(26, B=B, H=H, S=D, D=D))
        eye = torch.eye(D, device=dev).expand(B, H, D, D).contiguous()
        v = eye.clone().requires_grad_()
        assert fa.flash_fwd_plan(q, k, v, dropout_p=0.1).route == "tf32x3"
        assert fa.flash_bwd_plan(q, k, v, eye, dropout_p=0.1).route == "fma"
        o = fa.flash_attention_bhsd(q, k, v, dropout_p=0.1, seed=seed)
        (dv,) = torch.autograd.grad(o, (v,), eye)
        want = fa.dropout_keep_mask(seed, B, H, D, D, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(o != 0, want)
        assert torch.equal(dv.transpose(-1, -2) != 0, want)
    for name in ("flash_attention", "flash_attention_bwd_dkv"):
        assert registry.spec(name).mode_launches == {"dropout": 2}


@pytest.mark.cuda
def test_flash_forward_d64_dropout_gqa_ragged_on_card():
    """Kernel 1 on the bf16 head_dim-64 Hopper route with dropout, causal,
    grouped-query (12 query heads over 4) at a ragged length (1,000: the
    last 128-row query tile and key tile are cut): within
    ``CARD_TOL[bf16]`` of the blockwise plain version at the plan's key
    tile with the same seed, its LSE within 1e-3 of the plain version's,
    and bitwise on a rerun.  Called through the registry: the model entry
    takes dropout only at lengths the reference's blocks divide."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs kernel 1 at ERNIE's shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    seed = torch.tensor([2 ** 42 + 5], dtype=torch.int64, device=dev)
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _qkv(23, B=2, H=12, Hkv=4, S=1000, D=64))
    kw = dict(causal=True, dropout_p=0.1, seed=seed)
    plan = fa.flash_fwd_plan(q, k, v, dropout_p=0.1)
    assert (plan.route, plan.block_k) == ("tma_wgmma", 128)
    o, lse = registry.dispatch("flash_attention", q, k, v, return_lse=True,
                               **kw)
    again = registry.dispatch("flash_attention", q, k, v, **kw)
    ro = fa.flash_attention_blockwise_ref(q, k, v, block_k=plan.block_k,
                                          **kw)
    _, rl = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, again)
    assert bool(torch.isfinite(o.float()).all())
    _assert_within(o, ro, fa.CARD_TOL[torch.bfloat16])
    assert (lse - rl).abs().max() <= 1e-3
    spec = registry.spec("flash_attention")
    assert spec.launches == 2 and spec.mode_launches == {"dropout": 2}


# (M, K, N, compute dtype): ResNet-50 GEMMs (stem K = 147, the classifier
# N = 1000 at batch 1 and 32, layer4 at batch 1) and odd sizes.  On an
# H100 (int8_mm_plan): 64 k-tiles walked by each of a few tiles at K =
# 8,192 (N = 33: plain stores, no TMA); tiles walked in turn by
# persistent blocks, 128 rows a tile (M 20,000 and 17,000); N = 70 and
# 33 take plain stores
_INT8_MM_CASES = [(1, 2048, 1000, torch.bfloat16), (32, 2048, 1000, torch.bfloat16),
                  (49, 4608, 512, torch.float32), (3000, 147, 64, torch.float32),
                  (1000, 576, 64, torch.bfloat16), (300, 2304, 256, torch.float32),
                  (130, 100, 70, torch.float32), (5, 147, 33, torch.bfloat16),
                  (1, 147, 64, torch.float32), (49, 4608, 512, torch.bfloat16),
                  (1, 2048, 1000, torch.float32), (200, 300, 33, torch.float32),
                  (20000, 200, 96, torch.bfloat16),
                  (17000, 576, 64, torch.float32),
                  (8, 8192, 1024, torch.bfloat16), (3, 8192, 33, torch.float32)]


def _int8_mm_case(seed, M, K, N, dev):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
    ws = torch.from_numpy((rng.random(N) * 0.01 + 1e-4).astype(np.float32))
    xf = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    return xq.to(dev), w.to(dev), ws.to(dev), xf.to(dev)


@pytest.mark.cuda
def test_int8_matmul_matches_plain_on_card():
    """Dynamic mode bitwise equal to the plain version (integer sums are
    order-free) and to itself on a rerun; weight-only within CARD_TOL
    (the registered rtol)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the ResNet-50 shapes")
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    registry.reset_counts()
    dev = torch.device("cuda")
    for i, (M, K, N, cdt) in enumerate(_INT8_MM_CASES):
        xq, w, ws, xf = _int8_mm_case(20 + i, M, K, N, dev)
        xs = torch.tensor(0.0123, device=dev)
        got = im.int8_matmul(xq, w, ws, x_scale=xs, compute_dtype=cdt)
        again = im.int8_matmul(xq, w, ws, x_scale=xs, compute_dtype=cdt)
        ref = im.int8_matmul(xq, w, ws, x_scale=xs, compute_dtype=cdt,
                             mode="torch_ref")
        torch.cuda.synchronize()
        assert got.dtype == cdt and got.shape == (M, N)
        assert torch.equal(got, ref), (M, K, N, cdt)
        assert torch.equal(again, got), (M, K, N, cdt)
        for wdt in (torch.float32, torch.bfloat16):
            got = im.int8_matmul(xf, w, ws, compute_dtype=wdt)
            ref = im.int8_matmul(xf, w, ws, compute_dtype=wdt,
                                 mode="torch_ref")
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got.float()).all())
            _assert_within(got, ref, im.CARD_TOL[wdt])
    # rows that do not start on 16 bytes and leading batch dims
    xq, w, ws, _ = _int8_mm_case(40, 6 * 7, 147, 64, dev)
    x3 = xq.reshape(6, 7, 147)
    got = im.int8_matmul(x3, w, ws, x_scale=0.5, compute_dtype=torch.float32)
    ref = im.int8_matmul(x3, w, ws, x_scale=0.5, compute_dtype=torch.float32,
                         mode="torch_ref")
    assert got.shape == (6, 7, 64) and torch.equal(got, ref)
    # weight-only on a transposed (column-major) x
    xt = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (147, 6 * 7)).astype(np.float32)).to(dev).t()
    for wdt in (torch.float32, torch.bfloat16):
        got = im.int8_matmul(xt, w, ws, compute_dtype=wdt)
        ref = im.int8_matmul(xt, w, ws, compute_dtype=wdt, mode="torch_ref")
        torch.cuda.synchronize()
        _assert_within(got, ref, im.CARD_TOL[wdt])
    # the stem's layer on its cached weight rows (K = 147 in a 160-byte
    # pitch, zero past K) and patch rows whose pad bytes are not zero
    from paddle_tpu_torch.nn import Conv2D
    from paddle_tpu_torch.quantization import (Int8InferenceConv2D,
                                               set_kernel_mode)
    stem = Int8InferenceConv2D(Conv2D(
        3, 64, 7, stride=2, padding=3, device=dev,
        generator=torch.Generator(device=dev).manual_seed(42)))
    img = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)).to(dev)
    with torch.no_grad():
        # leave non-zero bytes in the allocator's free blocks
        torch.full((1 << 22,), 77, dtype=torch.int8, device=dev)
        got = stem(img)
        set_kernel_mode(stem, "torch_ref")
        ref = stem(img)
    assert stem.weight_rows().stride() == (160, 1)
    assert torch.equal(got, ref)
    assert registry.launch_counts()["int8_matmul"] == (
        4 * len(_INT8_MM_CASES) + 4)


# (M, K, N): weight-only at the weight-only ResNet-50's classifier (batch
# 1, 32, 128: 8 splits of K), its split edges (K = 2,000 and 2,100 not a
# multiple of the split, N = 1,000 and 70 not a multiple of 64, M = 33
# and 129 past a block's rows) and M of 1,024 and 4,100 (one split, tiles
# of 128 rows of x)
_WONLY_CASES = [(1, 2048, 1000), (32, 2048, 1000), (128, 2048, 1000),
                (5, 2000, 1000), (32, 2100, 70), (33, 300, 200),
                (129, 2048, 1000), (1, 17, 5), (1024, 768, 3072),
                (4100, 1000, 130)]


@pytest.mark.cuda
def test_int8_matmul_weight_only_split_on_card():
    """The weight-only kernel at the path's shapes, the split edges and
    M >= 1,024: within CARD_TOL of the plain version and bitwise equal to
    itself on a rerun (the partials merge in split order), one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the path's shapes")
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    registry.reset_counts()
    dev = torch.device("cuda")
    runs = 0
    for i, (M, K, N) in enumerate(_WONLY_CASES):
        _, w, ws, xf = _int8_mm_case(60 + i, M, K, N, dev)
        for wdt in (torch.float32, torch.bfloat16):
            x = xf.to(wdt)
            got = im.int8_matmul(x, w, ws, compute_dtype=wdt)
            again = im.int8_matmul(x, w, ws, compute_dtype=wdt)
            ref = im.int8_matmul(x, w, ws, compute_dtype=wdt,
                                 mode="torch_ref")
            torch.cuda.synchronize()
            runs += 2
            assert got.dtype == wdt and got.shape == (M, N)
            assert bool(torch.isfinite(got.float()).all())
            _assert_within(got, ref, im.CARD_TOL[wdt])
            assert torch.equal(again, got), (M, K, N, wdt)
    assert registry.launch_counts()["int8_matmul"] == runs


def _zipf_inverse(seed, n, vocab=20_000):
    """An embedding push's inverse: Zipf(1.3) ids deduplicated; returns
    (inverse, number of unique ids)."""
    rng = np.random.RandomState(seed)
    ids = np.clip(rng.zipf(1.3, n), 1, vocab)
    uniq, inv = np.unique(ids, return_inverse=True)
    return inv.astype(np.int64), uniq.size


def _card_grads(rng, n, dim, integer, aligned, dev):
    g = (rng.integers(-50, 50, (n, dim)) if integer
         else rng.standard_normal((n, dim))).astype(np.float32)
    if aligned:
        return torch.from_numpy(g).to(dev)
    # a view one float into its buffer
    buf = torch.empty(n * dim + 1, device=dev)
    buf[1:] = torch.from_numpy(g.reshape(-1)).to(dev)
    return buf[1:].view(n, dim)


@pytest.mark.cuda
def test_ps_kernels_match_plain_on_card():
    """segment_sum and pull_dequant bitwise equal to their plain versions
    at the wide&deep shapes and at odd ones, segment_sum also on the hard
    cases with their rows shuffled; segment_sum reruns bitwise equal; an
    inverse on the card is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the wide&deep shapes")
    from paddle_tpu_torch.distributed.fleet.ps import (dequantize_rows_q8,
                                                       quantize_rows_q8)
    from paddle_tpu_torch.ops.kernels.pull_dequant import pull_dequant
    from paddle_tpu_torch.ops.kernels.segment_sum import (hard_segment_cases,
                                                          segment_sum)
    registry.reset_counts()
    dev = torch.device("cuda")
    rng = np.random.default_rng(30)
    inv, u = _zipf_inverse(0, 26_624)
    cases = [(inv, 16, 1 << (u - 1).bit_length(), False, True),
             (rng.integers(0, 7, 64), 5, 8, True, True),
             (np.zeros(1, np.int64), 16, 1, False, True),
             (rng.integers(0, 40, 500), 13, 64, False, True)]
    cases += [(seg[rng.permutation(seg.size)], dim, nseg, False, aligned)
              for _, seg, dim, nseg, aligned in hard_segment_cases(rng)]
    for inv, dim, nseg, integer, aligned in cases:
        g = _card_grads(rng, inv.size, dim, integer, aligned, dev)
        ref = segment_sum(g, inv, nseg, mode="torch_ref")
        a, b = segment_sum(g, inv, nseg), segment_sum(g, inv, nseg)
        torch.cuda.synchronize()
        assert torch.equal(a, ref) and torch.equal(a, b), (inv.size, dim)
        with pytest.raises(ValueError, match="host"):
            segment_sum(g, torch.from_numpy(inv).to(dev), nseg)
    for m, dim in ((6242, 16), (1, 16), (4097, 13), (1000, 4096), (9, 8)):
        rows = (rng.standard_normal((m, dim)) * 3).astype(np.float32)
        rows[::3] = 0.0                      # all-zero rows: scale 0
        codes, scales = quantize_rows_q8(rows)
        c, s = torch.from_numpy(codes).to(dev), torch.from_numpy(scales).to(dev)
        got = pull_dequant(c, s)
        ref = pull_dequant(c, s, mode="torch_ref")
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (m, dim)
        assert np.array_equal(got.cpu().numpy(),
                              dequantize_rows_q8(codes, scales))
    counts = registry.launch_counts()
    assert counts["segment_sum"] == 22 and counts["pull_dequant"] == 5


@pytest.mark.cuda
def test_segment_sum_sorted_matches_plain_and_kernel7_on_card():
    """segment_sum_sorted bitwise equal to its plain version and to a
    rerun at the stream's merge, at vocab scale, with integer gradients,
    n = 1, dim 13 and the hard cases; and, through merge_segments on an
    unsorted merge, bitwise equal to segment_sum (kernel 7).  What it
    refuses on the card raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the stream's shapes")
    from paddle_tpu_torch.ops.kernels.segment_sum import (
        hard_segment_cases, merge_segments, segment_sum, segment_sum_sorted)
    registry.reset_counts()
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    # a wide&deep batch: 26 fields of Zipf(1.3) ids, offset per field
    z = np.clip(np.random.RandomState(0).zipf(1.3, (1024, 26)), 1, 20_000)
    uniq, inv = np.unique((z - 1) + np.arange(26) * 20_000,
                          return_inverse=True)
    inv, u = inv.reshape(-1), uniq.size
    assert u >= 4096                  # merge_segments takes kernel 8
    cases = [(np.sort(inv), 16, u, False),
             (np.sort(rng.integers(0, 200_000, 256)), 16, 200_000, False),
             (np.sort(rng.integers(0, 6000, 64)), 5, 6000, True),
             (np.zeros(1, np.int64), 16, 4096, False),
             (np.sort(rng.integers(0, 4096, 5000)), 13, 4096, False)]
    cases = [c + (True,) for c in cases]
    cases += [(seg, dim, nseg, False, aligned)
              for _, seg, dim, nseg, aligned in hard_segment_cases(rng)]
    for seg, dim, nseg, integer, aligned in cases:
        g = _card_grads(rng, seg.size, dim, integer, aligned, dev)
        ref = segment_sum_sorted(g, seg, nseg, mode="torch_ref")
        a, b = segment_sum_sorted(g, seg, nseg), segment_sum_sorted(g, seg,
                                                                    nseg)
        torch.cuda.synchronize()
        assert torch.equal(a, ref) and torch.equal(a, b), (seg.size, dim)
    g = torch.from_numpy(rng.standard_normal((inv.size, 16)).astype(
        np.float32)).to(dev)
    k8, k7 = merge_segments(g, inv, u), segment_sum(g, inv, u)
    torch.cuda.synchronize()
    assert torch.equal(k8, k7)
    for args, msg in (((g.double(), np.sort(inv), u), "float32"),
                      ((g, inv, u), "ascending"),
                      ((g, torch.from_numpy(np.sort(inv)).to(dev), u),
                       "host")):
        with pytest.raises(ValueError, match=msg):
            segment_sum_sorted(*args)
    counts = registry.launch_counts()
    assert counts["segment_sum_sorted"] == 25 and counts["segment_sum"] == 1


class _Sink:
    """A client that records every stamped push."""

    def __init__(self):
        self.pushes = []

    def push_stamped(self, table, ids, grads, seq, src=None, wm=None):
        self.pushes.append((np.array(ids), np.array(grads), int(seq)))
        return True


@pytest.mark.cuda
def test_small_card_batch_merges_on_card():
    """A batch of fewer than 4,096 rows whose ``step_fn`` returns CUDA
    gradients merges on the card (one segment_sum launch, no plain call)
    and pushes host sums bitwise equal to ``np.add.at``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py streams full batches through the card")
    from paddle_tpu_torch.online import StreamingTrainer
    rng = np.random.default_rng(32)
    ids = rng.integers(0, 300, 1000).astype(np.int64)
    g = rng.standard_normal((ids.size, 16)).astype(np.float32)

    def step(batch, pull):
        return ids, torch.from_numpy(g).cuda()

    registry.reset_counts()
    sink = _Sink()
    StreamingTrainer([{"i": 0}], sink, "emb", step, device_merge=True,
                     device="cuda").run()
    counts = registry.launch_counts()
    assert counts["segment_sum"] == 1 and counts["segment_sum_sorted"] == 0
    assert not any(s.torch_ref_calls for s in registry.kernels().values())
    uniq, inv = np.unique(ids, return_inverse=True)
    want = np.zeros((uniq.size, 16), np.float32)
    np.add.at(want, inv.reshape(-1), g)
    (pi, pg, seq), = sink.pushes
    assert seq == 1 and np.array_equal(pi, uniq)
    assert pg.dtype == np.float32 and np.array_equal(pg, want)


def _numpy_adam(p, g, m, v, lr, b1, b2, eps, t):
    """The host numpy engine's Adam step (``_FlatAdam.update`` of the
    reference), written out: f32 operations in its order."""
    B1, B2, lr, eps = (np.float32(b1), np.float32(b2), np.float32(lr),
                       np.float32(eps))
    m = (B1 * m + (np.float32(1) - B1) * g).astype(np.float32)
    v = (B2 * v + (np.float32(1) - B2) * g * g).astype(np.float32)
    c1 = np.float32(1.0 - b1 ** t)
    c2 = np.float32(1.0 - b2 ** t)
    p = (p - lr * (m / c1) / (np.sqrt(v / c2) + eps)).astype(np.float32)
    return p, m, v


@pytest.mark.cuda
def test_opt_apply_matches_plain_on_card():
    """opt_apply bitwise equal to its plain version for every kind, at
    odd lengths and an unaligned view (the scalar path), on a rerun too;
    Adam bitwise equal to the host numpy engine's expression."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the elastic shapes")
    from paddle_tpu_torch.ops.kernels.opt_apply import (KINDS, SLOTS,
                                                        opt_apply,
                                                        pack_hyper)
    registry.reset_counts()
    dev = torch.device("cuda")
    rng = np.random.default_rng(40)
    calls = 0
    for n in (1, 3, 4097, 100_000, (1 << 20) + 3):
        arrs = [rng.standard_normal(n + 1).astype(np.float32)
                for _ in range(3)]
        arrs.append(np.square(rng.standard_normal(n + 1)).astype(np.float32)
                    * np.float32(0.01))
        full = [torch.from_numpy(a).to(dev) for a in arrs]
        for view in ("aligned", "unaligned"):
            p, g, s0, s1 = ([t[:n] for t in full] if view == "aligned"
                            else [t[1:] for t in full])
            for kind in KINDS:
                for t in (1, 7, 10_000):
                    hyper = pack_hyper(kind, lr=0.01, t=t)
                    slots = [s0, s1][:len(SLOTS[kind])]
                    ref = opt_apply(kind, p, g, slots, hyper,
                                    mode="torch_ref")
                    a = opt_apply(kind, p, g, slots, hyper)
                    b = opt_apply(kind, p, g, slots, hyper)
                    calls += 2
                    torch.cuda.synchronize()
                    for x, y, z in zip(a, b, ref):
                        assert torch.equal(x, z) and torch.equal(x, y), (
                            n, view, kind, t)
                    if kind == "adam" and view == "aligned" and n < 5000:
                        want = _numpy_adam(*(x.cpu().numpy() for x in
                                             (p, g, s0, s1)),
                                           0.01, 0.9, 0.999, 1e-8, t)
                        for x, y in zip(a, want):
                            assert np.array_equal(x.cpu().numpy(), y), t
    with pytest.raises(ValueError, match="contiguous"):
        opt_apply("sgd", full[0][::2], full[1][::2], [],
                  pack_hyper("sgd", lr=0.1))
    with pytest.raises(ValueError, match="float32"):
        opt_apply("sgd", full[0].double(), full[1].double(), [],
                  pack_hyper("sgd", lr=0.1))
    assert registry.launch_counts()["opt_apply"] == calls


@pytest.mark.cuda
def test_conv_bn_stats_matches_plain_on_card():
    """The fused 1x1-conv + BN-statistics kernel within its CARD_TOL of the
    plain version at a small and a tail shape (M off the 128-row tile, N
    8), bitwise equal over two runs; ineligible calls raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the bottleneck shapes")
    from paddle_tpu_torch.ops.kernels import conv_bn_stats as cbs
    registry.reset_counts()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(50)
    for M, K, N in ((256, 64, 128), (1000, 72, 8)):
        x = torch.randn(M, K, device=dev, generator=g).bfloat16()
        w = (torch.randn(K, N, device=dev, generator=g) * 0.05).bfloat16()
        a = cbs.fused_matmul_bn_stats(x, w)
        b = cbs.fused_matmul_bn_stats(x, w)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, b)), (M, K, N)
        for name, (err, share) in cbs.card_check(x, w, a).items():
            assert share <= 1.0, (M, K, N, name, err, share)
    assert registry.launch_counts()["conv_bn_stats"] == 4
    with pytest.raises(ValueError, match="bfloat16"):
        cbs.fused_matmul_bn_stats(x.float(), w.float())
    with pytest.raises(ValueError, match="multiples of 8"):
        cbs.fused_matmul_bn_stats(x[:, :60].contiguous(), w[:60])


@pytest.mark.cuda
def test_resnet50_training_step_on_card():
    """One bf16-AMP Momentum step of resnet50 at batch 2 on the card:
    finite f32 loss, f32 masters and running statistics that moved, and
    no kernel launched (the reference's ResNet training runs none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 24 trains at "
                    "batch 256")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.vision.models import resnet50
    registry.reset_counts()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    m = resnet50(num_classes=1000, device=dev, generator=gen)
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "bfloat16"}
    opt = pt.optimizer.Momentum(0.1, 0.9, parameters=list(m.parameters()))
    step = DistributedTrainStep(
        m, lambda a, b: pt.nn.functional.cross_entropy(m(a), b).mean(),
        opt, s)
    img = torch.randn(2, 3, 224, 224, device=dev, generator=gen)
    lab = torch.randint(0, 1000, (2,), device=dev, generator=gen)
    loss = step(img, lab)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert m.bn1._mean.dtype == torch.float32
    assert bool(m.bn1._mean.abs().sum() > 0)
    assert all(v == 0 for v in registry.launch_counts().values())


@pytest.mark.cuda
def test_int8_matmul_at_the_bert_pooler_on_card():
    """Dynamic mode at the int8 BERT-base's pooler (M = 1, 8, 32, 128;
    K = N = 768; bf16 output): bitwise equal to the plain version and to
    itself on a rerun."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py phase 3 runs the same shapes")
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    registry.reset_counts()
    dev = torch.device("cuda")
    for i, M in enumerate((1, 8, 32, 128)):
        xq, w, ws, _ = _int8_mm_case(60 + i, M, 768, 768, dev)
        xs = torch.tensor(0.0071, device=dev)
        got, again = (im.int8_matmul(xq, w, ws, x_scale=xs)
                      for _ in range(2))
        ref = im.int8_matmul(xq, w, ws, x_scale=xs, mode="torch_ref")
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (M, 768)
        assert torch.equal(got, ref), M
        assert torch.equal(again, got), M
    assert registry.launch_counts()["int8_matmul"] == 8


@pytest.mark.cuda
def test_bert_training_step_and_int8_pooler_on_card():
    """One bf16-AMP AdamW step of a 2-layer BERT-base-wide pretraining
    model at batch 4 x seq 128 with dropout on: a finite f32 loss near
    ln(vocab) + ln(2), f32 masters, the tied word embedding one parameter,
    and no kernel launched (the reference runs none at seq 128).  Then
    the int8 BertModel from the same weights: one dynamic
    ``int8_matmul`` launch a forward, its pooled output bitwise the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phases 29-31 run "
                    "BERT-base at the bench's sizes")
    import math
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.quantization import (convert_to_int8_inference,
                                               set_kernel_mode)
    from paddle_tpu_torch.text.models import (BertForPretraining, BertModel,
                                              BertPretrainingCriterion,
                                              bert_base)
    registry.reset_counts()
    dev = torch.device("cuda")
    cfg = bert_base(num_hidden_layers=2)
    gen = torch.Generator(device=dev).manual_seed(4)
    m = BertForPretraining(cfg, device=dev, generator=gen)
    crit = BertPretrainingCriterion(cfg.vocab_size)
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "bfloat16"}

    def loss_fn(ids, pos, mlm, nsp):
        lg, ns = m(ids, masked_positions=pos)
        return crit(lg, ns, mlm, nsp)

    step = DistributedTrainStep(m, loss_fn, pt.optimizer.AdamW(
        1e-4, parameters=list(m.parameters())), s)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), device=dev,
                        generator=gen, dtype=torch.int32)
    pos = torch.randint(0, 128, (4, 19), device=dev, generator=gen).sort(
        dim=1).values.int()
    mlm = torch.randint(0, cfg.vocab_size, (4, 19), device=dev, generator=gen)
    nsp = torch.randint(0, 2, (4,), device=dev, generator=gen)
    loss = step(ids, pos, mlm, nsp)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert abs(loss.item() - math.log(cfg.vocab_size) - math.log(2)) < 0.5
    assert all(p.dtype == torch.float32 for p in m.parameters())
    names = [n for n, _ in m.named_parameters()]
    assert "bert.embeddings.word_embeddings.weight" in names
    assert not any("decoder" in n for n in names)
    assert all(v == 0 for v in registry.launch_counts().values())
    q = BertModel(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(5))
    convert_to_int8_inference(q)
    with torch.no_grad():
        pooled = q(ids)[1]
        assert registry.launch_counts()["int8_matmul"] == 1
        assert registry.spec("int8_matmul").mode_launches["dynamic"] == 1
        set_kernel_mode(q, "torch_ref")
        plain = q(ids)[1]
    assert torch.equal(pooled, plain)


@pytest.mark.cuda
def test_flash_kernels_at_8192_positions_match_plain_on_card():
    """Kernels 1-3 at 8,192 positions (B 1, H 2, head_dim 128, bf16,
    causal: the long-context proxy's length on the Hopper routes): the
    forward within ``CARD_TOL`` of the blockwise plain version at its key
    tile, the gradients within ``CARD_TOL_BWD`` of the blockwise backward,
    a rerun bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the proxy's shapes")
    registry.reset_counts()
    dev = torch.device("cuda")
    dt = torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(dev, dt).transpose(1, 2).contiguous()
               for a in _qkv(14, B=1, H=2, S=8192, D=128))
    g = torch.from_numpy(_qkv(15, B=1, H=2, S=8192, D=128)[0]).to(dev, dt)
    outs, grads = [], []
    for _ in range(2):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(qq, kk, vv, causal=True)
        outs.append(o.detach())
        grads.append(torch.autograd.grad(o, (qq, kk, vv),
                                         g.transpose(1, 2)))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    plan = fa.flash_fwd_plan(qh, kh, vh)
    ref = fa.flash_attention_blockwise_ref(qh, kh, vh, causal=True,
                                           block_k=plan.block_k)
    _assert_within(outs[0].transpose(1, 2), ref, fa.CARD_TOL[dt])
    o, lse = fa.flash_attention_bhsd(qh, kh, vh, causal=True,
                                     return_lse=True)
    delta = fa.attention_delta(o, g)
    bref = fa.flash_attention_bwd_blockwise_ref(qh, kh, vh, g, lse, delta,
                                                causal=True)
    torch.cuda.synchronize()
    for got, want in zip(grads[0], bref):
        assert bool(torch.isfinite(got.float()).all())
        _assert_within(got.transpose(1, 2), want, fa.CARD_TOL_BWD[dt])
    counts = registry.launch_counts()
    assert counts["flash_attention"] == 3
    assert counts["flash_attention_bwd_dkv"] == 2
    assert counts["flash_attention_bwd_dq"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(4, 8), (1, 16), (1, 8)],
                         ids=["tp_rank", "pp_mb", "tp_pp_mb"])
def test_flash_kernels_at_the_model_parallel_shapes_on_card(B, H):
    """Kernels 1-3 at the shapes the proxy's model-parallel steps give
    them (bf16, S 2,048, head_dim 128, causal): a tp-2 rank's heads (B 4,
    H 8), a pp-2 microbatch (B 1, H 16) and a tp-2 x pp-2 one (B 1, H 8).  The forward within
    ``CARD_TOL`` of the blockwise plain version, the gradients within
    ``CARD_TOL_BWD`` of the blockwise backward (from the kernel's own
    output and LSE, as the kernels' backward takes them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py phase 3 runs this at each of these "
                    "shapes")
    registry.reset_counts()
    dev = torch.device("cuda")
    dt = torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(dev, dt).transpose(1, 2).contiguous()
               .requires_grad_()
               for a in _qkv(16, B=B, H=H, S=2048, D=128))
    g = torch.from_numpy(_qkv(17, B=B, H=H, S=2048, D=128)[0]).to(dev, dt)
    o = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), g.transpose(1, 2))
    qh, kh, vh = (t.detach().transpose(1, 2) for t in (q, k, v))
    plan = fa.flash_fwd_plan(qh, kh, vh)
    ref = fa.flash_attention_blockwise_ref(qh, kh, vh, causal=True,
                                           block_k=plan.block_k)
    _assert_within(o.detach().transpose(1, 2), ref, fa.CARD_TOL[dt])
    o2, lse = fa.flash_attention_bhsd(qh, kh, vh, causal=True,
                                      return_lse=True)
    assert torch.equal(o2, o.detach().transpose(1, 2))
    delta = fa.attention_delta(o2, g)
    bref = fa.flash_attention_bwd_blockwise_ref(qh, kh, vh, g, lse, delta,
                                                causal=True)
    torch.cuda.synchronize()
    for got, want in zip(grads, bref):
        assert bool(torch.isfinite(got.float()).all())
        _assert_within(got.transpose(1, 2), want, fa.CARD_TOL_BWD[dt])
    counts = registry.launch_counts()
    assert counts["flash_attention"] == 2
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_bwd_dq"] == 1


@pytest.mark.cuda
def test_float16_scaled_step_on_card():
    """The train step with float16 AMP on the card: an overflowing batch
    leaves the parameters and the AdamW state bitwise as they were and
    the scale follows the dynamic state machine; the other steps are
    finite and train."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the float16 "
                    "step on BERT-base")
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.optimizer import AdamW
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    net = torch.nn.Sequential(tnn.Linear(4, 8, device=dev, generator=gen),
                              tnn.Tanh(),
                              tnn.Linear(8, 1, device=dev, generator=gen))
    opt = AdamW(0.01, parameters=list(net.parameters()))
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "float16", "init_loss_scaling": 1024.0,
                     "incr_every_n_steps": 2, "decr_every_n_nan_or_inf": 1}
    step = DistributedTrainStep(
        net, lambda x, y: torch.mean((net(x) - y) ** 2), opt, s,
        guard_health=True)
    rng = np.random.default_rng(0)
    losses, scales = [], []
    for i in range(6):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        if i == 3:
            x *= 1000.0                 # (out - y)^2 overflows float16
        xt = torch.from_numpy(x).to(dev)
        yt = xt.sum(1, keepdim=True) / 4
        before = [p.detach().clone() for p in net.parameters()]
        sbefore = [{k: v.clone() for k, v in st.items()}
                   for st in opt.opt_state()]
        losses.append(step(xt, yt).item())
        scales.append(step.amp_state[0].item())
        if i == 3:
            assert all(torch.equal(a, p)
                       for a, p in zip(before, net.parameters()))
            for s0, s1 in zip(sbefore, opt.opt_state()):
                assert all(torch.equal(s0[k], s1[k]) for k in s0)
            assert step.last_health[1].item() > 0
    assert scales == [1024.0, 2048.0, 2048.0, 1024.0, 1024.0, 2048.0]
    good = [x for i, x in enumerate(losses) if i != 3]
    assert all(np.isfinite(good)) and not np.isfinite(losses[3])


@pytest.mark.cuda
def test_q8_codec_on_card_is_bitwise_its_cpu_version():
    """The int8 moment codec (signed-sqrt q8) gives the same codes,
    scales and decoded values on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.optimizer.slot_codec import _q8_decode, _q8_encode
    rng = np.random.RandomState(0)
    for x in ((rng.randn(512, 1024) ** 3 * 1e-3).astype(np.float32),
              (np.abs(rng.randn(300, 77)) ** 4 * 1e-6).astype(np.float32)):
        for round_up in (False, True):
            qc, sc = _q8_encode(torch.from_numpy(x), round_up=round_up)
            qg, sg = _q8_encode(torch.from_numpy(x).cuda(),
                                round_up=round_up)
            np.testing.assert_array_equal(qg.cpu().numpy(), qc.numpy())
            np.testing.assert_array_equal(sg.cpu().numpy(), sc.numpy())
            np.testing.assert_array_equal(_q8_decode(qg, sg).cpu().numpy(),
                                          _q8_decode(qc, sc).numpy())


@pytest.mark.cuda
def test_offloaded_step_keeps_pinned_host_slots_on_card():
    """sharding offload: every slot a pinned CPU tensor, none on the
    card, and the steps bitwise those of the in-memory slots; the host
    slots, read right after a step with nothing else waiting on the card,
    are the in-memory arm's bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.optimizer import AdamW

    def run(offload):
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.Tanh(),
                                  torch.nn.Linear(256, 8)).cuda()
        opt = AdamW(learning_rate=1e-3, parameters=list(net.parameters()))
        s = DistributedStrategy()
        s.sharding = True
        s.sharding_configs = {"stage": 1, "offload": offload}
        step = DistributedTrainStep(
            net, lambda x, y: torch.mean((net(x) - y) ** 2), opt, s)
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(32, 64, device="cuda", generator=g)
        y = torch.randn(32, 8, device="cuda", generator=g)
        losses = [float(step(x, y)) for _ in range(3)]
        last = step(x, y)
        # no sync before this read: a pinned slot's clone is a host copy
        slots = [{k: v.clone() if v.device.type == "cpu" else v.cpu()
                  for k, v in st.items()} for st in opt.opt_state()]
        losses.append(float(last))
        return (losses, [p.detach().cpu() for p in net.parameters()], slots,
                step, opt)

    l0, p0, s0, _, _ = run(False)
    l1, p1, s1, step, opt = run(True)
    assert l0 == l1
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    for a, b in zip(s0, s1):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for st in opt.opt_state():
        for v in st.values():
            assert v.device.type == "cpu" and v.is_pinned()
    b = step.slot_bytes()
    assert b["device"] == 0 and b["pinned"] > 0 and b["host"] == 0


@pytest.mark.cuda
def test_world1_nccl_and_world2_gloo_collectives_on_card():
    """A one-rank NCCL world and a two-rank gloo world on the one card
    (gloo stages the CUDA tensors through host memory): every collective
    exact on integer-valued floats, its results on the card
    (``chip_smoke``'s phase 44 cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from paddle_tpu_torch.distributed.spawn import spawn
    one = spawn(chip_smoke._coll_rank, args=(None,), nprocs=1,
                backend="nccl", timeout=60, join_timeout=180)
    chip_smoke._check_coll("world 1", one, "nccl")
    two = spawn(chip_smoke._coll_rank, args=(None,), nprocs=2,
                backend="gloo", timeout=60, join_timeout=180)
    chip_smoke._check_coll("world 2", two, "gloo")
    assert [r["device"] for r in two] == ["cuda:0", "cuda:0"]
