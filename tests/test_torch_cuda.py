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
                ro = fa.flash_attention_blockwise_ref(q, k, v,
                                                      causal=causal)
                torch.cuda.synchronize()
                _assert_within(o, ro, fa.CARD_TOL[dt])
                assert (lse - rl).abs().max() <= 1e-4
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


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """Both backward kernels through the autograd Function on (B, S, H, D)
    views, as the model passes them: every head dim, f32 and bf16, causal
    or not, GQA and a ragged length; rerun bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this at the training shape")
    registry.reset_counts()
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        for D, (H, Hkv, S) in ((64, (4, 2, 300)), (128, (2, 2, 256)),
                               (256, (4, 1, 130))):
            q, k, v = (torch.from_numpy(a).to(dev, dt).transpose(1, 2)
                       .contiguous() for a in _qkv(12, H=H, Hkv=Hkv, S=S,
                                                   D=D))
            g = torch.from_numpy(_qkv(13, H=H, S=S, D=D)[0]).to(dev, dt)
            for causal in (True, False):
                grads = []
                for _ in range(2):
                    qq, kk, vv = (t.detach().requires_grad_()
                                  for t in (q, k, v))
                    o = fa.flash_attention(qq, kk, vv, causal=causal)
                    grads.append(torch.autograd.grad(
                        o, (qq, kk, vv), g.transpose(1, 2)))
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
    assert counts["flash_attention_bwd_dkv"] == 24
    assert counts["flash_attention_bwd_dq"] == 24
