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


# (M, K, N, compute dtype): ResNet-50 GEMMs (stem K = 147, the classifier
# N = 1000 at batch 1 and 32, layer4 at batch 1) and odd sizes
_INT8_MM_CASES = [(1, 2048, 1000, torch.bfloat16), (32, 2048, 1000, torch.bfloat16),
                  (49, 4608, 512, torch.float32), (3000, 147, 64, torch.float32),
                  (1000, 576, 64, torch.bfloat16), (300, 2304, 256, torch.float32),
                  (130, 100, 70, torch.float32), (5, 147, 33, torch.bfloat16),
                  (1, 147, 64, torch.float32)]


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
    order-free); weight-only within CARD_TOL (the registered rtol)."""
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
        ref = im.int8_matmul(xq, w, ws, x_scale=xs, compute_dtype=cdt,
                             mode="torch_ref")
        torch.cuda.synchronize()
        assert got.dtype == cdt and got.shape == (M, N)
        assert torch.equal(got, ref), (M, K, N, cdt)
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
    assert registry.launch_counts()["int8_matmul"] == 3 * len(_INT8_MM_CASES) + 3


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
