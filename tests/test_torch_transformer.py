"""The port's transformer layers (``nn/layer/transformer.py``) and WMT
translation model (``text/models/transformer.py``) against the JAX
reference.

Weights are made by the JAX layer or model (``paddle.seed``) and carried
across with ``load_jax_state_dict``; inputs are seeded numpy.  Everything
runs in f32 in eval mode (dropout masks have no bit parity with
``jax.random``).  Tolerances, each with its reason:

- layers, the model's logits and the criterion's loss: rtol/atol 1e-5
  (the same f32 math, summed in another order);
- greedy and beam tokens: equal;
- at 1,024 positions under a [B, 1, 1, S] float mask (or one [1, 1, 1,
  S] row shared by the batch) the port's attention takes the flash
  entry (the kernel's bias row; its plain version on the CPU, counted by
  the registry) where the reference on the CPU takes ``_sdpa_ref``: the
  same numbers within 1e-5, and the gradients (the port's chunked bias
  backward against JAX's autodiff) within 1e-5 relative to each
  gradient's largest element.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.text.models import transformer as jt

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.text.models import transformer as tt

E, H, FF = 32, 4, 64


@pytest.fixture(autouse=True)
def _counts():
    registry.reset_counts()
    yield
    registry.reset_counts()


def _arrays(jm):
    return {k: np.asarray(v._value).astype(np.float32)
            for k, v in jm.state_dict().items()}


def _carry(jm, tm):
    load_jax_state_dict(tm, _arrays(jm))
    jm.eval()
    return tm.eval()


def _j(a):
    return paddle.to_tensor(a)


def _np(t):
    return t.detach().float().numpy()


def _jnp(t):
    return np.asarray(t._value).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=tol, atol=tol)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _masks(rng, B, Sq, Sk):
    """A bool [B, 1, 1, Sk] key-padding mask (True keeps; each row keeps
    its first keys) and an additive [B, 1, Sq, Sk] float mask."""
    keep = np.arange(Sk)[None, :] < rng.randint(Sk // 2, Sk + 1, (B, 1))
    boolm = keep[:, None, None, :]
    floatm = np.where(rng.rand(B, 1, Sq, Sk) < 0.2, -1e9, 0.0).astype(
        np.float32)
    floatm[..., 0] = 0.0                    # no row fully masked
    return boolm, floatm


# ---------------------------------------------------------------------
# nn/layer/transformer.py
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_multi_head_attention_self(mask):
    rng = np.random.RandomState(1)
    paddle.seed(1)
    jm = jnn.MultiHeadAttention(E, H)
    tm = _carry(jm, tnn.MultiHeadAttention(E, H, device="cpu"))
    x = _x(rng, 2, 7, E)
    boolm, floatm = _masks(rng, 2, 7, 7)
    m = {"none": None, "bool": boolm, "float": floatm}[mask]
    want = jm(_j(x), attn_mask=None if m is None else _j(m))
    got = tm(torch.from_numpy(x),
             attn_mask=None if m is None else torch.from_numpy(m))
    _close(got, want)


def test_multi_head_attention_cross_with_kdim_vdim():
    rng = np.random.RandomState(2)
    paddle.seed(2)
    jm = jnn.MultiHeadAttention(E, H, kdim=16, vdim=24)
    tm = _carry(jm, tnn.MultiHeadAttention(E, H, kdim=16, vdim=24,
                                           device="cpu"))
    q, k, v = _x(rng, 2, 5, E), _x(rng, 2, 9, 16), _x(rng, 2, 9, 24)
    boolm, _ = _masks(rng, 2, 5, 9)
    _close(tm(*(torch.from_numpy(a) for a in (q, k, v, boolm))),
           jm(*(_j(a) for a in (q, k, v, boolm))))


def test_multi_head_attention_caches():
    """An incremental ``Cache`` over three one-token steps (its k/v grow
    by one row a step) and a ``StaticCache`` of a memory."""
    rng = np.random.RandomState(3)
    paddle.seed(3)
    jm = jnn.MultiHeadAttention(E, H)
    tm = _carry(jm, tnn.MultiHeadAttention(E, H, device="cpu"))
    first = _x(rng, 2, 1, E)
    jc, tc = jm.gen_cache(_j(first)), tm.gen_cache(torch.from_numpy(first))
    assert tuple(tc.k.shape) == (2, 0, H, E // H)
    for step in range(3):
        x = _x(rng, 2, 1, E)
        jo, jc = jm(_j(x), cache=jc)
        to, tc = tm(torch.from_numpy(x), cache=tc)
        _close(to, jo)
        assert isinstance(tc, tnn.MultiHeadAttention.Cache)
        assert tuple(tc.k.shape) == (2, step + 1, H, E // H)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    mem = _x(rng, 2, 6, E)
    js = jm.gen_cache(_j(mem), _j(mem), type=jnn.MultiHeadAttention
                      .StaticCache)
    ts = tm.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                      type=tnn.MultiHeadAttention.StaticCache)
    q = _x(rng, 2, 2, E)
    _close(tm(torch.from_numpy(q), cache=ts), jm(_j(q), cache=js))


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_and_encoder(pre, act):
    rng = np.random.RandomState(4)
    paddle.seed(4)
    jl = jnn.TransformerEncoderLayer(E, H, FF, activation=act,
                                     normalize_before=pre)
    tl = _carry(jl, tnn.TransformerEncoderLayer(
        E, H, FF, activation=act, normalize_before=pre, device="cpu"))
    x = _x(rng, 2, 8, E)
    boolm, floatm = _masks(rng, 2, 8, 8)
    for m in (boolm, floatm):
        _close(tl(torch.from_numpy(x), torch.from_numpy(m)),
               jl(_j(x), _j(m)))
    paddle.seed(5)
    je = jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(E, H, FF, activation=act,
                                    normalize_before=pre), 2,
        jnn.LayerNorm(E) if pre else None)
    te = _carry(je, tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(E, H, FF, activation=act,
                                    normalize_before=pre, device="cpu"), 2,
        tnn.LayerNorm(E, device="cpu") if pre else None))
    _close(te(torch.from_numpy(x), torch.from_numpy(boolm)),
           je(_j(x), _j(boolm)))


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_layer_and_decoder(pre):
    rng = np.random.RandomState(6)
    paddle.seed(6)
    jd = jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(E, H, FF, normalize_before=pre), 2,
        jnn.LayerNorm(E) if pre else None)
    td = _carry(jd, tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(E, H, FF, normalize_before=pre,
                                    device="cpu"), 2,
        tnn.LayerNorm(E, device="cpu") if pre else None))
    tgt, mem = _x(rng, 2, 5, E), _x(rng, 2, 9, E)
    _, tmask = _masks(rng, 2, 5, 5)
    mmask, _ = _masks(rng, 2, 5, 9)
    args = (tgt, mem, tmask, mmask)
    _close(td(*(torch.from_numpy(a) for a in args)),
           jd(*(_j(a) for a in args)))
    # one layer alone
    _close(td.layers[1](*(torch.from_numpy(a) for a in args)),
           jd.layers[1](*(_j(a) for a in args)))


def test_decoder_incremental_caches_match_jax():
    """The decoder over three one-token steps with ``gen_cache`` (an
    incremental and a static cache a layer), as the translation decoders
    run it."""
    rng = np.random.RandomState(7)
    paddle.seed(7)
    jd = jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(E, H, FF, normalize_before=True), 2,
        jnn.LayerNorm(E))
    td = _carry(jd, tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(E, H, FF, normalize_before=True,
                                    device="cpu"), 2,
        tnn.LayerNorm(E, device="cpu")))
    mem = _x(rng, 2, 9, E)
    mmask, _ = _masks(rng, 1, 1, 9)
    mmask = np.where(np.repeat(mmask, 2, 0), 0.0, -1e9).astype(np.float32)
    jc, tc = jd.gen_cache(_j(mem)), td.gen_cache(torch.from_numpy(mem))
    for _ in range(3):
        x = _x(rng, 2, 1, E)
        jo, jc = jd(_j(x), _j(mem), None, _j(mmask), jc)
        to, tc = td(torch.from_numpy(x), torch.from_numpy(mem), None,
                    torch.from_numpy(mmask), tc)
        _close(to, jo)
    zipped = td.gen_cache(torch.from_numpy(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_transformer_and_its_square_mask():
    rng = np.random.RandomState(8)
    paddle.seed(8)
    jm = jnn.Transformer(E, H, 2, 2, FF, normalize_before=True)
    tm = _carry(jm, tnn.Transformer(E, H, 2, 2, FF, normalize_before=True,
                                    device="cpu"))
    src, tgt = _x(rng, 2, 9, E), _x(rng, 2, 6, E)
    sm = _jnp(jm.generate_square_subsequent_mask(6))
    tsm = tm.generate_square_subsequent_mask(6)
    assert np.array_equal(_np(tsm), sm)
    smask, _ = _masks(rng, 2, 9, 9)
    args = (src, tgt, smask, sm, smask)
    _close(tm(*(torch.from_numpy(np.asarray(a)) for a in args)),
           jm(*(_j(a) for a in args)))


def test_layers_share_one_dropout_generator():
    """The deep copies of a layer keep its dropout generator (state that
    the training step replays), and dropout needs none in eval."""
    layer = tnn.TransformerEncoderLayer(E, H, FF, device="cpu")
    enc = tnn.TransformerEncoder(layer, 3)
    gens = {id(m.generator) for m in enc.modules() if hasattr(m, "generator")}
    assert len(gens) == 1
    w = [lay.linear1.weight for lay in enc.layers]
    assert torch.equal(w[0], w[2]) and w[0] is not w[2]
    x = torch.randn(2, 5, E)
    enc.train()
    a = enc(x)
    assert not torch.equal(a, enc(x))
    enc.eval()
    assert torch.equal(enc(x), enc(x))


# ---------------------------------------------------------------------
# text/models/transformer.py
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX ``TransformerModel(transformer_tiny())`` and its port, from
    the same weights."""
    paddle.seed(0)
    cfg = dict(src_vocab_size=600, trg_vocab_size=600)
    jm = jt.TransformerModel(jt.transformer_tiny(**cfg))
    tm = tt.TransformerModel(tt.transformer_tiny(**cfg), device="cpu")
    return jm, _carry(jm, tm)


def _ids(rng, B, S, pad_from, vocab=600):
    ids = rng.randint(4, vocab, (B, S)).astype(np.int64)
    for b, n in enumerate(pad_from):
        ids[b, n:] = 0
    return ids


def test_state_dict_carries_the_tied_embedding(tiny):
    jm, tm = tiny
    assert tm.trg_embed is tm.src_embed
    assert set(tm.state_dict()) == set(jm.state_dict()) | {
        "trg_embed.weight"}
    assert "_pos" not in tm.state_dict() and "_causal" not in tm.state_dict()
    assert tuple(tm._pos.shape) == (32, 32)


def test_model_logits_and_loss_match_jax(tiny):
    jm, tm = tiny
    rng = np.random.RandomState(11)
    src, trg = _ids(rng, 3, 12, (12, 7, 9)), _ids(rng, 3, 10, (10, 6, 8))
    nxt = _ids(rng, 3, 10, (10, 6, 8))
    jl = jm(_j(src), _j(trg))
    tl = tm(torch.from_numpy(src), torch.from_numpy(trg))
    assert tl.shape == (3, 10, 600)
    _close(tl, jl)
    jc, tc = jt.CrossEntropyCriterion(0.1), tt.CrossEntropyCriterion(0.1)
    _close(tc(tl, torch.from_numpy(nxt)), jc(jl, _j(nxt)))
    # sequences past max_len are truncated (the position table ends there)
    long = _ids(rng, 1, 40, (40,))
    assert tm(torch.from_numpy(long), torch.from_numpy(long)).shape[1] == 32


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_translate_tokens_match_jax(tiny, decode):
    jm, tm = tiny
    rng = np.random.RandomState(12)
    src = _ids(rng, 3, 14, (14, 9, 5))
    if decode == "greedy":
        want = jt.greedy_translate(jm, _j(src), max_len=10)
        got = tt.greedy_translate(tm, torch.from_numpy(src), max_len=10)
    else:
        want = jt.beam_translate(jm, _j(src), beam_size=4, max_len=10)
        got = tt.beam_translate(tm, torch.from_numpy(src), beam_size=4,
                                max_len=10)
    assert got.dtype == np.int64 and got.shape == np.asarray(want).shape
    assert np.array_equal(got, np.asarray(want))
    assert not tm.training


def test_model_trains_a_step_on_the_cpu():
    """Dropout on (the model's generator), a backward through the tied
    embedding and the criterion: the loss falls over a few AdamW steps on
    one batch."""
    from paddle_tpu_torch.optimizer import AdamW
    torch.manual_seed(0)
    tm = tt.TransformerModel(tt.transformer_tiny(src_vocab_size=100,
                                                 trg_vocab_size=100),
                             device="cpu")
    crit = tt.CrossEntropyCriterion(0.1)
    opt = AdamW(1e-2, parameters=list(tm.parameters()))
    rng = np.random.RandomState(13)
    src, trg = (torch.from_numpy(_ids(rng, 4, 10, (10, 8, 10, 6), 100))
                for _ in range(2))
    losses = []
    for _ in range(5):
        loss = crit(tm(src, trg), trg)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------
# the bias row at 1,024 positions
# ---------------------------------------------------------------------

def _attention_at_1024_against_jax(seed, mask):
    """``MultiHeadAttention`` (embed 128, 2 heads: head_dim 64) on a batch
    of 2 at 1,024 positions under the float ``mask``: one flash call (its
    plain version on the CPU) against the reference's ``_sdpa_ref``, the
    outputs and every parameter's gradient.  ``k_proj.bias``'s gradient
    is zero (softmax cancels a constant added to a row's scores), so both
    sides give rounding noise there: it must be noise, at most 1e-5 of
    the value bias's gradient."""
    rng = np.random.RandomState(seed)
    paddle.seed(seed)
    jm = jnn.MultiHeadAttention(128, 2)
    tm = _carry(jm, tnn.MultiHeadAttention(128, 2, device="cpu"))
    x, g = _x(rng, 2, 1024, 128), _x(rng, 2, 1024, 128)
    jo = jm(_j(x), attn_mask=_j(mask))
    (jo * _j(g)).sum().backward()
    to = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    (to * torch.from_numpy(g)).sum().backward()
    _close(to, jo)
    assert registry.spec("flash_attention").torch_ref_calls == 1
    jg = {n: _jnp(p.grad) for n, p in jm.named_parameters()}
    noise = 1e-5 * np.abs(jg["v_proj.bias"]).max()
    for n, p in tm.named_parameters():
        if n == "k_proj.bias":
            assert np.abs(p.grad.numpy()).max() <= noise
            assert np.abs(jg[n]).max() <= noise
            continue
        scale = np.abs(jg[n]).max()
        np.testing.assert_allclose(p.grad.numpy() / scale, jg[n] / scale,
                                   atol=1e-5, err_msg=n)


def test_attention_at_1024_takes_the_flash_bias_row():
    """A [B, 1, 1, S] float padding mask: the port's SDPA sends it to the
    flash entry as the kernel's bias row."""
    pad = np.arange(1024)[None, :] >= np.array([[1024], [700]])
    _attention_at_1024_against_jax(
        14, np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :])


def test_attention_at_1024_with_a_mask_shared_by_the_batch():
    """One [1, 1, 1, S] float row for the batch of 2: the flash entry
    takes it as the bias row of every batch entry."""
    _attention_at_1024_against_jax(16, np.where(
        np.arange(1024) >= 800, -1e9, 0.0).astype(np.float32)[
            None, None, None, :])


def test_encoder_at_1024_is_one_bias_launch_a_layer():
    """The translation model's encoder at a 1,024-token source (the
    position table made that long, no weight changes): each encoder layer
    sends its padding row to the flash entry once, the decoder's one-token
    steps take the plain attention; the encoder memory equals the
    reference's."""
    rng = np.random.RandomState(15)
    paddle.seed(15)
    cfg = dict(src_vocab_size=300, trg_vocab_size=300, max_len=1024,
               d_model=128, nhead=2)
    jm = jt.TransformerModel(jt.transformer_tiny(**cfg))
    tm = _carry(jm, tt.TransformerModel(tt.transformer_tiny(**cfg),
                                        device="cpu"))
    src = rng.randint(4, 300, (2, 1024)).astype(np.int64)
    src[1, 600:] = 0
    jmem = jm.transformer.encoder(jm._embed(jm.src_embed, _j(src)),
                                  jm._pad_mask(_j(src)))
    with torch.no_grad():
        ts = torch.from_numpy(src)
        tmem = tm.transformer.encoder(tm._embed(tm.src_embed, ts),
                                      tm._pad_mask(ts))
    _close(tmem, jmem)
    assert registry.spec("flash_attention").torch_ref_calls == 2
    registry.reset_counts()
    got = tt.greedy_translate(tm, ts, max_len=4)
    assert registry.spec("flash_attention").torch_ref_calls == 2
    assert np.array_equal(got, np.asarray(jt.greedy_translate(
        jm, _j(src), max_len=4)))
