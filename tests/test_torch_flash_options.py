"""The flash kernels' two options in the port -- the [B, 1, 1, Sk] bias row
of kernel 1 and in-kernel dropout in kernels 1-3 -- against the JAX
reference, and the port's keep mask by itself.

On the CPU the port's entry points run the kernels' plain versions
(the tensors lie on the CPU), so these tests hold the plain versions to
the reference's Pallas kernels in interpret mode, mirroring the
reference's own tests (``tests/test_flash_attention.py:67-92`` for the
bias, ``:125-160`` for dropout, which injects a full keep mask:
``test_mask``, which the port's plain versions take too).  Tolerances,
each no looser than the reference's own (2e-3 forward, 3e-3 gradients):

- bias: forward and q/k/v/bias gradients rtol/atol 2e-3 (the
  reference's; the two sides agree to ~1e-6 at f32);
- dropout: forward and q/k/v gradients rtol/atol 3e-3;
- the keep mask: bitwise (Random123's known answers; blocks against the
  whole); its keep rate within 5 sigma of 1 - p.

The launchers are checked with the CUDA library replaced by a recorder
(no card here); the kernels themselves are held to these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 33).
"""
import contextlib
import importlib
import math
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from paddle_tpu_torch.ops.kernels import _build, registry
from paddle_tpu_torch.ops.kernels import flash_attention as fa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")


@pytest.fixture(autouse=True)
def _counts():
    registry.reset_counts()
    yield
    registry.reset_counts()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


# ---------------------------------------------------------------------
# the bias row (kernel 1)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_bias_plain_matches_jax_kernel(causal):
    """The reference's bias test (interpret mode, 64-row blocks): forward
    and the gradients of q, k, v and the bias row, the port's backward
    being its plain chunked recompute."""
    rng = np.random.RandomState(3)
    q, k, v, g = (_rand(rng, 2, 2, 128, 64) for _ in range(4))
    keep = rng.rand(2, 128) > 0.3
    bias = np.where(keep, 0.0, -1e30).astype(np.float32)[:, None, None, :]
    bias[:, :, :, :3] += rng.standard_normal((2, 1, 1, 3)) \
        .astype(np.float32)

    def jloss(q_, k_, v_, b_):
        o = jfa.flash_attention_bhsd(q_, k_, v_, bias=b_, causal=causal,
                                     block_q=64, block_k=64, interpret=True)
        return (o * jnp.asarray(g)).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    ts = [_t(a) for a in (q, k, v, bias)]
    o = fa.flash_attention_bhsd(ts[0], ts[1], ts[2], bias=ts[3],
                                causal=causal)
    tg = torch.autograd.grad(o, ts, torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=2e-3, atol=2e-3)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3)
    assert registry.spec("flash_attention").torch_ref_calls == 1


def test_bias_backward_matches_dense_autograd_with_gqa():
    """The bias path's backward (the chunked backward from the forward's
    LSE, with the bias added and its gradient asked for) against autograd
    of the dense composition, grouped-query (4 query heads on 2 kv
    heads), ragged length, causal, in 64-row chunks: atol 1e-5 (the same
    f32 math in chunks)."""
    rng = np.random.RandomState(4)
    B, H, Hkv, S, D = 2, 4, 2, 200, 64
    q, g = _rand(rng, B, H, S, D), _rand(rng, B, H, S, D)
    k, v = _rand(rng, B, Hkv, S, D), _rand(rng, B, Hkv, S, D)
    bias = (_rand(rng, B, 1, 1, S) * 2).astype(np.float32)
    tq, tk, tv, tb, tg = (torch.from_numpy(a) for a in (q, k, v, bias, g))
    o, lse = fa.flash_attention_ref(tq, tk, tv, bias=tb, causal=True,
                                    return_lse=True)
    got = fa._bwd_chunked(tq, tk, tv, tg, lse, fa.attention_delta(o, tg),
                          True, None, ("dq", "dk", "dv", "dbias"),
                          round_p=False, chunk=64, bias=tb)
    ts = [_t(a) for a in (q, k, v, bias)]
    kk, vv = (t.repeat_interleave(H // Hkv, dim=1) for t in ts[1:3])
    s = ts[0] @ kk.transpose(-1, -2) / math.sqrt(D) + ts[3]
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    o = torch.softmax(s, -1) @ vv
    want = torch.autograd.grad(o, ts, torch.from_numpy(g))
    for name, b in zip(("dq", "dk", "dv", "dbias"), want):
        np.testing.assert_allclose(got[name].numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 1, 1, 128), (2, 1, 1, 1), (128,)])
def test_bias_that_broadcasts_matches_jax(shape):
    """A bias that broadcasts to [B, 1, 1, Sk] without being that shape (a
    padding row shared by the batch, a per-batch constant, a bare row):
    the reference takes it on its chunked XLA version, the port expands
    it (on the card the kernel reads a shared row with batch stride 0);
    forward and the gradients of q, k, v and the bias, whose gradient
    keeps the bias's shape, at the reference's 2e-3."""
    rng = np.random.RandomState(5)
    q, k, v, g = (_rand(rng, 2, 2, 128, 64) for _ in range(4))
    bias = rng.standard_normal(shape).astype(np.float32)
    if shape[-1] == 128:
        bias[..., 90:] = -1e30

    def jloss(q_, k_, v_, b_):
        o = jfa.flash_attention_bhsd(q_, k_, v_, bias=b_, block_q=64,
                                     block_k=64, interpret=True)
        return (o * jnp.asarray(g)).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    ts = [_t(a) for a in (q, k, v, bias)]
    o = fa.flash_attention_bhsd(ts[0], ts[1], ts[2], bias=ts[3])
    tg = torch.autograd.grad(o, ts, torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=2e-3, atol=2e-3)
    assert tg[3].shape == shape
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3)
    assert registry.spec("flash_attention").torch_ref_calls == 1


def test_bias_shape_and_dropout_with_bias_are_refused():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match=r"\[B, 1, 1, Sk\]"):
        fa.flash_attention_bhsd(q, q, q, bias=torch.zeros(1, 2, 64, 64))
    with pytest.raises(ValueError, match="does not compose"):
        fa.flash_attention_bhsd(q, q, q, bias=torch.zeros(1, 1, 1, 64),
                                dropout_p=0.1, seed=torch.zeros(1).long())
    with pytest.raises(ValueError, match="needs a seed"):
        fa.flash_attention_bhsd(q, q, q, dropout_p=0.1)


# ---------------------------------------------------------------------
# dropout (kernels 1-3)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_dropout_plain_matches_jax_kernels(causal):
    """The reference's fused-dropout test: an injected keep mask at p =
    0.3, forward and all three gradients, the reference's Pallas forward
    and backward kernels in interpret mode against the port's plain
    versions through its autograd Function."""
    rng = np.random.RandomState(9)
    B, H, S, D, p = 2, 2, 128, 64, 0.3
    q, k, v, g = (_rand(rng, B, H, S, D) for _ in range(4))
    keep = (rng.rand(B, H, S, S) > p).astype(np.uint8)

    def jflash(q_, k_, v_):
        return jfa.flash_attention_bhsd(q_, k_, v_, test_mask=jnp.asarray(
            keep), causal=causal, block_q=64, block_k=64, interpret=True,
            dropout_p=p)

    args = [jnp.asarray(a) for a in (q, k, v)]
    jo = jflash(*args)
    jg = jax.grad(lambda *a: (jflash(*a) * jnp.asarray(g)).sum(),
                  argnums=(0, 1, 2))(*args)
    ts = [_t(a) for a in (q, k, v)]
    o = fa.flash_attention_bhsd(*ts, test_mask=torch.from_numpy(keep),
                                causal=causal, dropout_p=p)
    tg = torch.autograd.grad(o, ts, torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=3e-3, atol=3e-3)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3,
                                   atol=3e-3)
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert registry.spec(name).torch_ref_calls == 1


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_blockwise_plain_matches_chunked(causal):
    """The blockwise plain version (the bf16 kernels' oracle) and the
    chunked one agree at f32 with a generated mask and GQA, forward and
    backward: atol 1e-5 (the same f32 math in another order); the
    generated mask injected as ``test_mask`` gives the same output."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(_rand(rng, 2, 4, 192, 64))
    k, v = (torch.from_numpy(_rand(rng, 2, 2, 192, 64)) for _ in range(2))
    do = torch.from_numpy(_rand(rng, 2, 4, 192, 64))
    seed = torch.tensor([12345], dtype=torch.int64)
    kw = dict(causal=causal, dropout_p=0.2, seed=seed)
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True, chunk=64, **kw)
    ob = fa.flash_attention_blockwise_ref(q, k, v, block_k=64, **kw)
    np.testing.assert_allclose(ob.numpy(), o.numpy(), atol=1e-5)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    chunked = (fa.flash_attention_bwd_dq_ref(*args, **kw),
               *fa.flash_attention_bwd_dkv_ref(*args, **kw))
    for a, b in zip(fa.flash_attention_bwd_blockwise_ref(*args, **kw),
                    chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # the generated mask is the test_mask path's with that mask injected
    keep = fa.dropout_keep_mask(seed, 2, 4, 192, 192, 0.2).to(torch.uint8)
    o2 = fa.flash_attention_ref(q, k, v, causal=causal, dropout_p=0.2,
                                test_mask=keep)
    assert torch.equal(o2, fa.flash_attention_ref(q, k, v, **kw))


def test_dropout_forward_is_softmax_dropped_then_v():
    """The forward's arithmetic: softmax(q k^T / sqrt(D)) * keep / (1 - p)
    then times V, the keep mask :func:`dropout_keep_mask`'s; the LSE is
    the undropped one.  atol 1e-5."""
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 96, 64)) for _ in range(3))
    seed = torch.tensor([-7], dtype=torch.int64)
    o, lse = fa.flash_attention_bhsd(q, k, v, dropout_p=0.25, seed=seed,
                                     return_lse=True)
    s = q @ k.transpose(-1, -2) / 8.0
    keep = fa.dropout_keep_mask(seed, 1, 2, 96, 96, 0.25)
    w = torch.where(keep, torch.softmax(s, -1) / torch.tensor(0.75), 0.0)
    np.testing.assert_allclose(o.numpy(), (w @ v).numpy(), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5)


# ---------------------------------------------------------------------
# the f32 forward's arithmetic: 3xTF32 products on the tensor cores
# ---------------------------------------------------------------------

def _tf32(x):
    """``x`` rounded to TF32 as the kernel rounds its hi part: the f32
    bits plus 0x1000, the low 13 bits cleared (10 mantissa bits, to
    nearest, ties away from zero: ``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """``x`` as the tensor cores read an f32 operand of a TF32 product:
    its top 19 bits (the low 13 cleared)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """hi = x rounded to TF32, lo = x - hi (exact) as read by the tensor
    cores."""
    hi = _tf32(x)
    return hi, _tf32_trunc(x - hi)


def _mm_3xtf32(a, b):
    """a @ b as the kernel forms it: lo.hi + hi.lo + hi.hi of the split
    operands, f32 sums (lo.lo dropped)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _tf32x3_forward(q, k, v, bias, causal, keep, p, block_k):
    """The f32 kernel's forward in plain PyTorch: key tiles of
    ``block_k``, both products in 3xTF32, the online softmax in log2
    units (scale log2 e folded into one multiply-add, the bias row
    pre-scaled by log2 e), masked scores -1e30, kept probabilities divided
    by f32(1 - p) for P.V while the denominator keeps them all, out = acc
    / max(l, 1e-30), lse = m ln 2 (or m scale) + log(max(l, 1e-30))."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    k = k.repeat_interleave(H // k.shape[1], dim=1)
    v = v.repeat_interleave(H // v.shape[1], dim=1)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    scale_log2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) \
        * log2e
    cf = 1.0 if bias is not None else scale_log2
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Sk, block_k):
        s = _mm_3xtf32(q, k[:, :, k0:k0 + block_k].transpose(-1, -2))
        if bias is not None:
            s = s * scale_log2 + bias[..., k0:k0 + block_k] * log2e
        if causal:
            kpos = torch.arange(k0, min(k0 + block_k, Sk))
            s = s.masked_fill(qpos < kpos[None, :], -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * cf)
        pe = torch.exp2(s * cf - (m_new * cf)[..., None])
        l = l * alpha + pe.sum(dim=-1)
        if keep is not None:
            pe = torch.where(keep[..., k0:k0 + block_k], pe
                             / torch.tensor(1.0 - p, dtype=torch.float32),
                             0.0)
        acc = acc * alpha[..., None] + _mm_3xtf32(
            pe, v[:, :, k0:k0 + block_k])
        m = m_new
    lc = l.clamp_min(1e-30)
    ls = math.log(2.0) if bias is not None else 1.0 / math.sqrt(D)
    return acc / lc[..., None], m * ls + torch.log(lc)


def test_tf32_split_rounds_to_nearest_away_and_keeps_21_bits():
    """hi: 10 mantissa bits, ties away from zero (1 + 2^-11 goes up, as
    does its negative's magnitude); lo as the tensor cores read it: hi +
    lo within 2^-21 of x."""
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12])
    assert _tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]
    x = torch.from_numpy(_rand(np.random.RandomState(21), 4096)) * 1e3
    hi, lo = _split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert rel.max().item() <= 2 ** -21


@pytest.mark.parametrize("case", ["plain", "causal", "gqa_ragged_causal",
                                  "bias", "bias_ragged_causal", "dropout",
                                  "dropout_causal", "d128_causal"])
def test_tf32x3_arithmetic_matches_jax_kernel(case):
    """The f32 kernel's arithmetic (3xTF32 products of hi = x rounded to
    TF32 and lo = x - hi truncated to TF32, the online softmax in log2
    units, at the plan's key tile) in plain PyTorch against the
    reference's forward at f32 -- its Pallas kernel in interpret mode
    (64-row blocks; its chunked XLA version where a ragged length leaves
    the blocks), K and V repeated for grouped-query heads, dropout through
    its injected ``test_mask`` -- within ``CARD_TOL[f32]``, the limit the
    kernel is held to on the card; the LSE within 1e-5 of the port's
    chunked plain version's.  The split keeps about 21 of f32's 24 bits:
    one TF32 product (11 bits) would be off by about 1e-3."""
    rng = np.random.RandomState(22)
    D = 128 if case.startswith("d128") else 64
    S = 200 if "ragged" in case else 128
    B, H = 2, 4
    Hkv = 2 if "gqa" in case else H
    causal = "causal" in case
    q = _rand(rng, B, H, S, D)
    k, v = _rand(rng, B, Hkv, S, D), _rand(rng, B, Hkv, S, D)
    bias = keep = None
    p = 0.0
    if case.startswith("bias"):
        bias = np.where(rng.rand(B, S) > 0.3, 0.0, -1e9).astype(
            np.float32)[:, None, None, :]
        bias[..., :4] += _rand(rng, B, 1, 1, 4)
    if case.startswith("dropout"):
        p = 0.2
        keep = (rng.rand(B, H, S, S) > p).astype(np.uint8)
    tq = torch.from_numpy(q)
    block_k = fa.flash_fwd_plan(tq, tq, tq).block_k
    assert block_k == (64 if D == 64 else 32)
    got, lse = _tf32x3_forward(
        tq, torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal,
        None if keep is None else torch.from_numpy(keep).bool(), p, block_k)
    rep = H // Hkv
    jo = jfa.flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=1)),
        jnp.asarray(np.repeat(v, rep, axis=1)),
        bias=None if bias is None else jnp.asarray(bias),
        test_mask=None if keep is None else jnp.asarray(keep),
        dropout_p=p, causal=causal, block_q=64, block_k=64, interpret=True)
    want = torch.from_numpy(np.array(jo))
    err, share = registry.card_error(got, want, fa.CARD_TOL[torch.float32])
    assert share <= 1.0, err
    # the same products in one TF32 pass miss the limit
    one_pass = torch.softmax(
        _tf32(tq) @ _tf32(torch.from_numpy(np.repeat(k, rep, axis=1)))
        .transpose(-1, -2) / math.sqrt(D), -1)
    full = torch.softmax(tq @ torch.from_numpy(np.repeat(k, rep, axis=1))
                         .transpose(-1, -2) / math.sqrt(D), -1)
    assert (one_pass - full).abs().max().item() > 10 * err
    _, rl = fa.flash_attention_ref(
        tq, torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias),
        causal=causal, return_lse=True)
    assert (lse - rl).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------
# the keep mask
# ---------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for philox4x32_10 (int64
    arithmetic with the multipliers split into 16-bit halves)."""
    got = fa.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                             for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("p,want", [(0.5, [[0, 1], [1, 1]]),
                                    (0.7, [[0, 1], [1, 0]]),
                                    (0.0, [[1, 1], [1, 1]])])
def test_keep_mask_of_the_zero_key_and_counter(p, want):
    """Seed 0, batch 0, head 0, queries and keys 0-1: the group of counter
    (0, 0, 0, 0) under key (0, 0), whose words 6627e8d5 e169c58d bc57ac4c
    9b00dbd8 are (q, k) = (0, 0), (0, 1), (1, 0), (1, 1); kept iff a word
    is >= floor(p * 2^32)."""
    got = fa.dropout_keep_mask(0, 1, 1, 2, 2, p)
    assert got[0, 0].tolist() == [[bool(x) for x in row] for row in want]


def test_keep_mask_elements_are_their_definition():
    """Elements of the mask at several (b, h, q, k) against Philox of
    their own counter, word and threshold, one at a time (the layout
    of the batch, head, query and key axes)."""
    seed = (1 << 41) + 3
    p = 0.3
    mask = fa.dropout_keep_mask(torch.tensor([seed]), 3, 4, 50, 70, p)
    rng = np.random.RandomState(7)
    for b, h, q, k in zip(*(rng.randint(0, n, 40) for n in (3, 4, 50, 70))):
        words = fa.philox4x32_10(k >> 1, q >> 1, int(h), int(b),
                                 seed & 0xFFFFFFFF, seed >> 32)
        bits = int(words[2 * (q & 1) + (k & 1)])
        assert bool(mask[b, h, q, k]) == (bits >= int(p * 2 ** 32))


@pytest.mark.parametrize("q0,nq,k0,nk", [(0, 64, 0, 64), (1, 7, 3, 33),
                                         (64, 64, 128, 64), (5, 1, 0, 130),
                                         (31, 33, 63, 65)])
def test_keep_mask_does_not_depend_on_tiles(q0, nq, k0, nk):
    """A block of the mask (any offsets, odd ones too: a route's tile, a
    row chunk of a plain version) is the same slice of the whole mask."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64)
    whole = fa.dropout_keep_mask(seed, 2, 3, 200, 200, 0.1)
    block = fa.dropout_keep_mask(seed, 2, 3, nq, nk, 0.1, q0=q0, k0=k0)
    assert torch.equal(block, whole[:, :, q0:q0 + nq, k0:k0 + nk])


def _groups_model(seed, b, h, row_base, c0, rows_q, p):
    """A numpy model of ``keep_groups_mma`` (``csrc/dropout.cuh``) for
    each thread of a warpgroup on the Hopper backward route: its group
    word [warp, lane], nibble j the 2 x 2 group it computes for n-tile j
    (bit 0 (q even, k even), 1 (q even, k odd), 2 (q odd, k even), 3 (q
    odd, k odd)): the lower lane of a row pair at its row row_base + 16
    warp + g, the upper lane at its row + 8; columns c0 + 8 j + 2 t.
    Rows are queries if ``rows_q``, else keys."""
    key = (seed & 0xFFFFFFFF, seed >> 32)
    th = int(p * 2 ** 32)
    words = np.zeros((4, 32), np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            row = row_base + 16 * w + g + (0 if g % 2 == 0 else 8)
            for j in range(8):
                c = c0 + 8 * j + 2 * t
                q, k = (row, c) if rows_q else (c, row)
                r = fa.philox4x32_10(k >> 1, q >> 1, h, b, *key)
                nib = sum(int(int(x) >= th) << i for i, x in enumerate(r))
                words[w, lane] |= nib << (4 * j)
    return words


def _bits_of_groups_model(words, rows_q):
    """``keep_bits_of_groups``: each lane's keep bits (bit 4 j + e for
    element e of n-tile j) from its group word and its partner's (lane ^
    4)."""
    bits = np.zeros_like(words)
    for lane in range(32):
        mine, other = words[:, lane], words[:, lane ^ 4]
        lower = (lane >> 2) % 2 == 0
        if rows_q:
            bits[:, lane] = ((mine & 0x33333333) | ((other & 0x33333333) << 2)
                             if lower else ((other >> 2) & 0x33333333)
                             | (mine & 0xCCCCCCCC))
        elif lower:
            bits[:, lane] = ((mine & 0x11111111) | ((mine >> 1) & 0x22222222)
                             | ((other << 2) & 0x44444444)
                             | ((other << 1) & 0x88888888))
        else:
            bits[:, lane] = (((other >> 1) & 0x11111111)
                             | ((other >> 2) & 0x22222222)
                             | ((mine << 1) & 0x44444444)
                             | (mine & 0x88888888))
    return bits


def _dq_gather_model(block):
    """dQ's gather of its group words from the 128 words dK/dV's
    warpgroup wrote for a 64 x 64 (query block, key block) (word i:
    thread i's group word): the lane's query group qg (its row, halved)
    and key groups 4 jj + t, word (jj / 2) 32 + 8 t + 4 (jj % 2) + qg % 4,
    nibble qg / 4."""
    words = np.zeros((4, 32), np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            lr_a = 16 * w + g
            qg = ((lr_a + 8) if g & 1 else lr_a) >> 1
            for jj in range(8):
                word = int(block[(jj >> 1) * 32 + 8 * t + 4 * (jj & 1)
                                 + (qg & 3)])
                words[w, lane] |= ((word >> (4 * (qg >> 2))) & 0xF) \
                    << (4 * jj)
    return words


# the second consumer warpgroup's 64 rows of an odd resident tile, an odd
# streamed tile, head and batch not 0
_SEED, _P, _QB, _KB, _B, _H = 2 ** 40 + 77, 0.1, 7, 7, 1, 2


def _mask_block():
    return fa.dropout_keep_mask(torch.tensor([_SEED]), 2, 3, 64, 64, _P,
                                q0=64 * _QB, k0=64 * _KB)[_B, _H]


@pytest.mark.parametrize("kernel", ["dkv", "dq", "fwd"])
def test_keep_bits_of_the_wgmma_fragment_are_the_mask(kernel):
    """The Hopper routes' keep bits, thread by thread, are
    ``dropout_keep_mask``'s at the rows and columns that thread's
    ``wgmma`` fragment holds: dK/dV (an m64n64 fragment, rows are keys,
    columns queries) from its Philox groups, dQ (rows queries, columns
    keys) from the group words dK/dV wrote, and the forward (an m64n128
    S fragment, rows queries, columns keys: its two 64-key halves, bits
    ``keep[r / 32]``) from its own Philox groups, each through the
    lane-pair swap."""
    if kernel == "fwd":
        # the second consumer warpgroup's 64 query rows of query tile 3
        # against key tile 5 (128 keys)
        q0, k0 = 128 * 3 + 64, 128 * 5
        mask = fa.dropout_keep_mask(torch.tensor([_SEED]), 2, 3, 64, 128,
                                    _P, q0=q0, k0=k0)[_B, _H]
        halves = [_bits_of_groups_model(_groups_model(
            _SEED, _B, _H, q0, k0 + 64 * hh, True, _P), True)
            for hh in range(2)]
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(64):
                    q = 16 * w + g + 8 * ((r >> 1) & 1)
                    k = 8 * (r >> 2) + 2 * t + (r & 1)
                    bit = (int(halves[r // 32][w, lane]) >> (r % 32)) & 1
                    assert bit == int(mask[q, k]), (kernel, w, lane, r)
        return
    mask = _mask_block()                    # [query, key] of the block
    dkv_words = _groups_model(_SEED, _B, _H, 64 * _KB, 64 * _QB, False, _P)
    if kernel == "dkv":
        bits, rows_q = _bits_of_groups_model(dkv_words, False), False
    else:
        words = _dq_gather_model(dkv_words.reshape(-1))
        # the words dQ gathers are the groups it would compute itself
        assert np.array_equal(words, _groups_model(
            _SEED, _B, _H, 64 * _QB, 64 * _KB, True, _P))
        bits, rows_q = _bits_of_groups_model(words, True), True
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(32):
                row = 16 * w + g + 8 * ((r >> 1) & 1)
                col = 8 * (r >> 2) + 2 * t + (r & 1)
                q, k = (row, col) if rows_q else (col, row)
                assert ((int(bits[w, lane]) >> r) & 1) == int(mask[q, k]), \
                    (kernel, w, lane, r)


def test_keep_bits_buffer_packing_order():
    """The words dK/dV writes for a 64 x 64 block (``keep_bits_out``):
    word 32 w + lane, nibble j holds the 2 x 2 group of queries 2 (4 j +
    t) + {0, 1} and keys 2 kg + {0, 1}, kg = 8 w + g / 2 for the lower
    lane of a row pair (g even), 8 w + 4 + (g - 1) / 2 for the upper;
    bit 2 (q & 1) + (k & 1).  The buffer holds one such block for each
    (batch, query head, query block, key block): ``keep_bits_numel``."""
    mask = _mask_block()
    words = _groups_model(_SEED, _B, _H, 64 * _KB, 64 * _QB, False,
                          _P).reshape(-1)
    for i in range(128):
        w, lane = divmod(i, 32)
        g, t = lane >> 2, lane & 3
        kg = 8 * w + (g // 2 if g % 2 == 0 else 4 + (g - 1) // 2)
        for j in range(8):
            for bit in range(4):
                q, k = 2 * (4 * j + t) + (bit >> 1), 2 * kg + (bit & 1)
                assert ((int(words[i]) >> (4 * j + bit)) & 1) == \
                    int(mask[q, k]), (i, j, bit)
    q = torch.zeros(8, 12, 2048, 64)
    assert fa.keep_bits_numel(q, q) * 4 == 8 * 12 * 2048 * 2048 // 8
    assert fa.keep_bits_numel(q[:, :, :300], q[:, :4, :130]) == \
        8 * 12 * 5 * 3 * 128


def test_keep_mask_rows_in_blocks_match(monkeypatch):
    """The plain mask computes a block of rows at a time; the blocks'
    size does not change it."""
    seed = torch.tensor([99], dtype=torch.int64)
    whole = fa.dropout_keep_mask(seed, 2, 3, 64, 50, 0.3)
    monkeypatch.setattr(fa, "_MASK_GROUPS", 7)
    assert torch.equal(fa.dropout_keep_mask(seed, 2, 3, 64, 50, 0.3), whole)


def test_keep_mask_seed_head_batch_and_rate():
    """Another seed, head or batch gives another mask; the keep rate is
    1 - p within 5 sigma over 2^20 scores, at several p."""
    a = fa.dropout_keep_mask(1, 2, 2, 128, 128, 0.1)
    b = fa.dropout_keep_mask(2, 2, 2, 128, 128, 0.1)
    assert not torch.equal(a, b)
    assert not torch.equal(a[0, 0], a[0, 1])
    assert not torch.equal(a[0, 0], a[1, 0])
    for p in (0.1, 0.3, 0.5):
        m = fa.dropout_keep_mask(3, 4, 4, 256, 256, p)
        n = m.numel()
        sigma = math.sqrt(p * (1 - p) / n)
        assert abs(m.double().mean().item() - (1 - p)) <= 5 * sigma


def test_dropout_seed_replays_with_the_generator():
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    s1 = fa.dropout_seed(g)
    g.set_state(state)
    assert torch.equal(fa.dropout_seed(g), s1)
    assert s1.dtype == torch.int64 and s1.shape == (1,)
    assert not torch.equal(fa.dropout_seed(g), s1)


# ---------------------------------------------------------------------
# the reference's dispatch checks, ported
# ---------------------------------------------------------------------

_FLOAT_ROW = ((2, 1, 1, None), "float32")
_ELIGIBLE_CASES = [
    # (seq, head_dim, mask (shape with None for seq, dtype), dropout, kv)
    (512, 64, None, 0.0, None), (1024, 64, None, 0.0, None),
    (1024, 32, None, 0.0, None), (2048, 128, None, 0.0, None),
    (1280, 64, None, 0.0, None), (4096, 256, None, 0.0, None),
    (1024, 64, _FLOAT_ROW, 0.0, None), (2048, 128, _FLOAT_ROW, 0.0, None),
    (1024, 64, ((2, 1, 1, None), "bfloat16"), 0.0, None),
    (1024, 64, ((2, 1, 1, None), "bool"), 0.0, None),
    (1024, 64, ((2, 1, None, None), "float32"), 0.0, None),
    (1024, 64, ((2, 4, 1, None), "float32"), 0.0, None),
    (1024, 64, ((1, None), "float32"), 0.0, None),
    (1024, 64, None, 0.1, None), (2048, 64, None, 0.1, None),
    (1280, 64, None, 0.1, None), (512 * 300, 64, None, 0.1, None),
    (512 * 300, 64, None, 0.0, None), (8192, 64, None, 0.1, None),
    (2048, 64, None, 0.1, 1024), (2048, 64, None, 0.1, 1000),
    (2048, 64, _FLOAT_ROW, 0.1, None), (512, 64, None, 0.1, None),
    (2048, 64, "unvetted", 0.0, None), (2048, 64, "unvetted", 0.1, None),
]


@pytest.mark.parametrize("seq,d,mask,drop,kv", _ELIGIBLE_CASES)
def test_flash_eligible_agrees_with_the_reference(monkeypatch, seq, d, mask,
                                                  drop, kv):
    """The port's ``flash_eligible`` against the reference's on the TPU
    backend it tests for (the port routes by device instead)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ", raising=False)
    jkw, tkw = dict(dropout=drop, kv_seq_len=kv), dict(dropout=drop,
                                                       kv_seq_len=kv)
    if mask == "unvetted":
        jkw["has_mask"] = tkw["has_mask"] = True
    elif mask is not None:
        shape = tuple(seq if n is None else n for n in mask[0])
        jkw.update(has_mask=True, mask_shape=shape,
                   mask_dtype=jnp.dtype(mask[1]) if mask[1] != "bfloat16"
                   else jnp.bfloat16)
        tkw.update(has_mask=True, mask_shape=shape,
                   mask_dtype=getattr(torch, mask[1]))
    assert fa.flash_eligible(seq, d, **tkw) == jfa.flash_eligible(seq, d,
                                                                  **jkw)


_CHECK_CASES = [
    # (p, seed, test_mask, sq, sk, block_q, block_k, bias)
    (0.0, False, False, 100, 100, 64, 64, True),
    (0.1, True, False, 1024, 1024, 512, 512, False),
    (0.1, False, True, 128, 128, 64, 64, False),
    (0.1, False, False, 1024, 1024, 512, 512, False),
    (0.1, True, False, 1024, 1024, 512, 512, True),
    (0.1, True, False, 1000, 1000, 512, 512, False),
    (0.1, True, False, 1024, 1000, 512, 512, False),
    (0.1, True, False, 512 * 300, 512, 512, 512, False),
    (0.1, True, False, 256 * 256, 256, 256, 256, False),
    (0.1, True, False, 100, 100, 512, 512, False),
]


@pytest.mark.parametrize("p,seed,tmask,sq,sk,bq,bk,bias", _CHECK_CASES)
def test_check_dropout_args_agrees_with_the_reference(p, seed, tmask, sq, sk,
                                                      bq, bk, bias):
    """``_check_dropout_args`` raises exactly where the reference's does,
    with the same reason."""
    def outcome(fn, s, m, b):
        try:
            fn(p, s, m, sq, sk, bq, bk, b)
        except ValueError as e:
            return str(e).split(" (")[0].split(",")[0][:40]
        return None

    j = outcome(jfa._check_dropout_args, jnp.zeros(1) if seed else None,
                jnp.zeros(1) if tmask else None,
                jnp.zeros(1) if bias else None)
    t = outcome(fa._check_dropout_args, torch.zeros(1) if seed else None,
                torch.zeros(1) if tmask else None,
                torch.zeros(1) if bias else None)
    assert t == j


@pytest.mark.parametrize("sq,sk,bq,bk", [(2048, 2048, None, None),
                                         (8192, 2048, None, None),
                                         (8192, 8192, 512, 512),
                                         (1024, 1024, 128, 64)])
def test_resolve_blocks_agrees_with_the_reference(sq, sk, bq, bk):
    assert fa._resolve_blocks(sq, sk, bq, bk) == \
        jfa._resolve_blocks(sq, sk, bq, bk)


# ---------------------------------------------------------------------
# routes and launchers (the CUDA library replaced by a recorder)
# ---------------------------------------------------------------------

class _Fn:
    def __init__(self, calls, name):
        self.calls, self.name, self.argtypes = calls, name, None

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _Lib:
    def __init__(self):
        self.calls = []
        for name in ("flash_attention_fwd", "flash_attention_fwd_sm90",
                     "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv_sm90",
                     "flash_attention_bwd_dq_sm90",
                     "flash_dropout_keep_mask"):
            setattr(self, name, _Fn(self.calls, name))


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load", lambda source: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return fake


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("opt", ["bias", "dropout"])
def test_options_take_the_hopper_route_at_d64_else_mma_sync(D, opt):
    """bf16 with an option takes the forward's Hopper route at head_dim
    64 (128 x 128 tiles, a 4-stage ring, beside each K stage the bias
    row's 128 f32 values or half the keep mask's 256 group words) and its
    ``mma.sync`` route at 128 and 256; f32 the 3xTF32 route (64 query
    rows, key tiles of 64 at head_dim 64 and 32 above, with the bias row
    its f32 values beside each of the 2 stages; dropout adds nothing to
    shared memory).  The backward's dropout takes the Hopper route at
    head_dim 64 and ``mma.sync`` at 128 and 256.  Without an option the
    forward's Hopper route takes bf16 at head_dim 64 and 128, the
    backward's too."""
    q = torch.zeros(2, 4, 300, D, dtype=torch.bfloat16)
    kw = (dict(bias=torch.zeros(2, 1, 1, 300, dtype=torch.bfloat16))
          if opt == "bias" else dict(dropout_p=0.1))
    plan = fa.flash_fwd_plan(q, q, q, **kw)
    if D == 64:
        assert (plan.route, plan.block_q, plan.block_k, plan.stages,
                plan.threads) == ("tma_wgmma", 128, 128, 4, 384)
        # Q, 4 stages of K and V, the O staging tile (16 KB each), beside
        # each K stage the bias row's 128 f32 values or half the keep
        # mask's group words (256), alignment slack and 18 mbarriers
        assert plan.smem_bytes == 1024 + 10 * 16384 + 4 * (
            512 if opt == "bias" else 1024) + 8 * 18
        # 3 query tiles x 4 heads x 2 sequences: a block each
        assert plan.grid == (24, 1, 1) and len(plan.tma_strides) == 12
    else:
        assert (plan.route, plan.block_q, plan.block_k) == (
            "mma_sync", 64, 64)
        # the tile's bias row (f32) beside Q, K and V
        assert plan.smem_bytes == 3 * 64 * (D + 8) * 2 + 64 * 4
    fplan = fa.flash_fwd_plan(q.float(), q.float(), q.float(), **kw)
    bk = 64 if D == 64 else 32
    assert (fplan.route, fplan.block_q, fplan.block_k, fplan.stages,
            fplan.threads) == ("tf32x3", 64, bk, 2, 128)
    # Q above head_dim 64 (rows of D + 16), each stage's K (D + 16) and V
    # (D + 4) rows, with the bias row its bk values
    assert fplan.smem_bytes == 4 * ((0 if D == 64 else 64 * (D + 16))
                                    + 2 * bk * (2 * D + 20)
                                    + (2 * bk if opt == "bias" else 0))
    # 5 query tiles of 64 x 4 heads x 2 sequences
    assert fplan.grid == (5, 4, 2) and fplan.tma_strides == ()
    if opt == "dropout":
        bplan = fa.flash_bwd_plan(q, q, q, q, dropout_p=0.1)
        if D == 64:
            assert bplan.route == "tma_wgmma"
            assert bplan.dkv.block_res == bplan.dq.block_res == 128
        else:
            assert bplan.route == "mma_sync"
            assert bplan.dkv.block_res == (64 if D == 128 else 32)
            assert bplan.dq.block_res == 64
    assert fa.flash_fwd_plan(q, q, q).route == (
        "mma_sync" if D == 256 else "tma_wgmma")
    assert fa.flash_bwd_plan(q, q, q, q).route == (
        "mma_sync" if D == 256 else "tma_wgmma")


@pytest.mark.parametrize("shape", [(8, 12, 12, 2048), (8, 8, 8, 1024),
                                   (1, 12, 4, 1000), (1, 1, 1, 17)])
@pytest.mark.parametrize("opt", ["none", "bias", "dropout"])
def test_hopper_d64_plan_fits_a_block_and_the_card(shape, opt):
    """The forward's head_dim-64 Hopper plan: its shared memory within a
    block's 227 KB (232,448 bytes), its grid no more blocks than the
    work items (128-row query tiles x heads x batch) or the SMs."""
    B, H, Hkv, S = shape
    q = torch.zeros(B, H, S, 64, dtype=torch.bfloat16)
    kv = torch.zeros(B, Hkv, S, 64, dtype=torch.bfloat16)
    kw = dict(bias=torch.zeros(B, 1, 1, S, dtype=torch.bfloat16)) \
        if opt == "bias" else dict(dropout_p=0.1) if opt == "dropout" \
        else {}
    plan = fa.flash_fwd_plan(q, kv, kv, **kw)
    assert plan.route == "tma_wgmma"
    assert plan.smem_bytes <= 232448
    items = -(-S // plan.block_q) * H * B
    assert plan.grid == (min(items, fa.H100_SMS), 1, 1)


def test_bias_launch_passes_the_row_and_counts_its_mode(lib):
    B, H, S, D = 2, 4, 300, 128
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    bias = torch.zeros(B, 1, 1, S, dtype=torch.bfloat16)
    o = fa._flash_fwd_cuda(q, q, q, bias=bias)
    ((name, args),) = lib.calls
    assert name == "flash_attention_fwd"
    # after the 5 pointers and B, H, Hkv, Sq, Sk, D: the bias row and its
    # batch stride, then no dropout (null seed, threshold 0, 1 - p = 1)
    assert args[5:11] == (B, H, H, S, S, D)
    assert args[11:16] == (bias.data_ptr(), S, None, 0, 1.0)
    assert o.shape == q.shape
    spec = registry.spec("flash_attention")
    assert spec.launches == 1 and spec.mode_launches == {"bias": 1}


@pytest.mark.parametrize("shared", [False, True])
def test_hopper_bias_launch_passes_the_row_and_its_batch_stride(lib,
                                                                 shared):
    """bf16 at head_dim 64 with the bias row reaches the forward's sm90
    entry with head_dim 64, the row's pointer and its batch stride in
    elements (0 for one row shared by the batch, read in place), no
    dropout (a null seed, threshold 0, factor 1), and the plan with the
    stages' bias rows; it counts as a ``bias`` launch."""
    B, H, S, D = 3, 4, 300, 64
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    row = torch.zeros(1 if shared else B, 1, 1, S, dtype=torch.bfloat16)
    bias = row.expand(B, 1, 1, S)
    o = fa._flash_fwd_cuda(q, q, q, bias=bias, causal=True)
    ((name, args),) = lib.calls
    assert name == "flash_attention_fwd_sm90"
    plan = fa.flash_fwd_plan(q, q, q, bias=bias)
    assert tuple(args[11]) == (128, 128, 4, 384, plan.smem_bytes) + plan.grid
    assert args[12] == 1 and args[14] == D
    assert args[15:17] == (row.data_ptr(), 0 if shared else S)
    assert args[17:20] == (None, 0, 1.0)
    assert o.shape == q.shape
    spec = registry.spec("flash_attention")
    assert spec.launches == 1 and spec.mode_launches == {"bias": 1}


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 64)])
def test_dropout_launches_pass_the_seed_and_count_their_mode(lib, dtype, D):
    B, H, S = 1, 2, 256
    q = torch.zeros(B, H, S, D, dtype=dtype)
    seed = torch.tensor([3], dtype=torch.int64)
    lse = torch.zeros(B, H, S)
    # bf16 at head_dim 64: the Hopper entries, the forward's and the
    # backward's, dK/dV writing its keep mask for dQ to read
    sm90 = "_sm90" if (dtype, D) == (torch.bfloat16, 64) else ""
    bits = (torch.empty(fa.keep_bits_numel(q, q), dtype=torch.int32)
            if sm90 else None)
    fa._flash_fwd_cuda(q, q, q, return_lse=True, dropout_p=0.1, seed=seed)
    fa._bwd_dkv_cuda(q, q, q, q, lse, lse, dropout_p=0.1, seed=seed,
                     keep_bits_out=bits)
    fa._bwd_dq_cuda(q, q, q, q, lse, lse, dropout_p=0.1, seed=seed,
                    keep_bits=bits)
    (n1, a1), (n2, a2), (n3, a3) = lib.calls
    assert (n1, n2, n3) == ("flash_attention_fwd" + sm90,
                            "flash_attention_bwd_dkv" + sm90,
                            "flash_attention_bwd_dq" + sm90)
    want = (seed.data_ptr(), int(0.1 * 2 ** 32), 0.9)
    if sm90:
        # after causal, scale, D and no bias (null, batch stride 0): the
        # seed, the threshold and f32(1 / f32(1 - p)), then the stream
        assert a1[12:17] == (0, 1 / D ** 0.5, D, None, 0)
        assert a1[-4:-1] == (seed.data_ptr(), int(0.1 * 2 ** 32),
                             float(torch.tensor(1.0) / torch.tensor(0.9)))
    else:
        assert a1[13:16] == want              # after the bias and stride
    if sm90:
        # after causal, scale and D; then the keep bits and the stream
        assert a2[-5:-2] == a3[-5:-2] == want
        assert a2[-6] == a3[-6] == D
        assert a2[-2] == a3[-2] == bits.data_ptr()
    else:
        assert a2[14:17] == a3[13:16] == want     # after D
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert registry.spec(name).mode_launches == {"dropout": 1}


def test_hopper_dq_with_dropout_needs_the_keep_bits(lib):
    """dQ with dropout on the Hopper route reads the mask dK/dV wrote:
    without it the wrapper raises, naming the shape, and launches
    nothing; without dropout the sm90 entries get a null seed and no
    bits."""
    q = torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 256)
    seed = torch.tensor([3], dtype=torch.int64)
    with pytest.raises(ValueError, match=r"q=\(1, 2, 256, 64\)"):
        fa._bwd_dq_cuda(q, q, q, q, lse, lse, dropout_p=0.1, seed=seed)
    assert lib.calls == []
    fa._bwd_dkv_cuda(q, q, q, q, lse, lse)
    fa._bwd_dq_cuda(q, q, q, q, lse, lse)
    (n1, a1), (n2, a2) = lib.calls
    assert (n1, n2) == ("flash_attention_bwd_dkv_sm90",
                        "flash_attention_bwd_dq_sm90")
    assert a1[-6:-1] == a2[-6:-1] == (64, None, 0, 1.0, None)
    assert registry.spec("flash_attention_bwd_dq").mode_launches == {}


def test_debug_mask_entry_refuses_a_host_seed(lib):
    seed = torch.tensor([1], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA seed"):
        fa.dropout_keep_mask_cuda(seed, 1, 1, 4, 4, 0.1)
    assert lib.calls == []
