"""The port's BERT slice and its building blocks against the JAX reference.

The same numpy inputs, made from seeds, go through the JAX function and
its counterpart in the port; model weights are made by the JAX model
(``paddle.seed``) and carried across with ``load_jax_state_dict``.  The
models are ``bert_tiny`` (hidden 128, 2 layers, 2 heads, vocab 1,024).
Dropout masks have no bit parity with ``jax.random``, so the parity tests
run with dropout 0 or in eval mode, and dropout's arithmetic is tested by
itself.  Tolerances, each with its reason at the test:

- functionals at f32: ``layer_norm`` rtol/atol 1e-5, ``gelu`` / ``tanh``
  1e-6, ``embedding`` bitwise; bf16 ``layer_norm`` one bf16 rounding
  (2^-8 relative) from the reference and bitwise the f32 closed form
  rounded once;
- ``BertModel`` and ``BertForPretraining`` + criterion in f32: rtol/atol
  1e-5 (the same f32 math in another order);
- one f32 AdamW step: the loss rtol 1e-5, every parameter within 0.25 lr
  elementwise and 1e-4 lr on average; one bf16-AMP step: the loss
  within 2.4e-3 relative, every parameter within 2.01 lr elementwise and
  0.05 lr on average (see the tests);
- the int8 pooler: bitwise; the whole int8 model at f32 compute: see the
  test.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.ops.pallas import registry as jreg
from paddle_tpu.quantization import convert_to_int8_inference as jax_convert
from paddle_tpu.text.models import bert as jb

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.nn import Dropout, LayerNorm
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.ops.kernels.int8_matmul import int8_mm_plan
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.quantization import (Int8InferenceLinear,
                                           convert_to_int8_inference,
                                           set_kernel_mode)
from paddle_tpu_torch.text.models import bert as tb

LR = 1e-3
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S, M, V = 4, 32, 4, 1024


@pytest.fixture(autouse=True)
def _clean():
    registry.reset_counts()
    mesh_mod.set_mesh(None)
    yield
    registry.reset_counts()
    mesh_mod.set_mesh(None)
    jreg.set_mode("int8_matmul", None)


def _arrays(jm):
    return {k: np.asarray(v._value).astype(np.float32)
            for k, v in jm.state_dict().items()}


def _np(t):
    return t.detach().float().numpy()


def _jnp(t):
    return np.asarray(t._value).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    """The bench's draws at a small size: ids, sorted masked positions,
    MLM labels, NSP labels (``bench.py:392-399``), and a padding mask."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (B, S)).astype("int32")
    pos = np.sort(rng.randint(0, S, (B, M)), axis=1).astype("int32")
    mlm = rng.randint(0, V, (B, M)).astype("int64")
    nsp = rng.randint(0, 2, (B,)).astype("int64")
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[3, 5:] = 0
    return dict(ids=ids, pos=pos, mlm=mlm, nsp=nsp, mask=mask)


@pytest.fixture(scope="module")
def pretrain():
    """The JAX ``BertForPretraining(bert_tiny())`` without dropout, and
    its weights as numpy."""
    paddle.seed(0)
    jm = jb.BertForPretraining(jb.bert_tiny(**NO_DROP))
    return jm, _arrays(jm)


def _port(arrays, cls=tb.BertForPretraining, **kw):
    cfg = dict(NO_DROP)
    cfg.update(kw)
    tm = cls(tb.bert_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, arrays)
    return tm


# ---------------------------------------------------------------------
# the functionals and layers
# ---------------------------------------------------------------------

def test_layer_norm_f32_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 2).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for args in ((), (w, b)):
        ref = _jnp(JF.layer_norm(paddle.to_tensor(x), 64,
                                 *[paddle.to_tensor(a) for a in args],
                                 epsilon=1e-12))
        got = F.layer_norm(torch.from_numpy(x), 64,
                           *[torch.from_numpy(a) for a in args],
                           epsilon=1e-12)
        # the same f32 closed form, reductions in another order
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)
    # two trailing dims
    ref = _jnp(JF.layer_norm(paddle.to_tensor(x), [5, 64]))
    got = F.layer_norm(torch.from_numpy(x), [5, 64])
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)


def test_layer_norm_bf16_takes_f32_moments():
    """A bf16 input is normalised in f32 and rounded once: bitwise the f32
    closed form of the same values cast to bf16, and within one bf16
    rounding (2^-8 of |y|, plus 2^-8 of |y|'s scale near zero) of the
    reference's bf16 output."""
    rng = np.random.default_rng(2)
    # a large mean: bf16 moments would lose the variance entirely
    x32 = (rng.standard_normal((4, 8, 128)) + 100.0).astype(np.float32)
    xb = torch.from_numpy(x32).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    for wb in ((w, b), (w.bfloat16(), b.bfloat16())):
        got = F.layer_norm(xb, 128, *wb, epsilon=1e-12)
        assert got.dtype == torch.bfloat16
        f32 = F.layer_norm(xb.float(), 128, wb[0].float(), wb[1].float(),
                           epsilon=1e-12)
        assert torch.equal(got, f32.to(torch.bfloat16))
        ref = _jnp(JF.layer_norm(
            paddle.to_tensor(jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
            128, *[paddle.to_tensor(jnp.asarray(t.float().numpy(),
                                                t.dtype == torch.bfloat16
                                                and jnp.bfloat16
                                                or jnp.float32))
                   for t in wb], epsilon=1e-12))
        np.testing.assert_allclose(_np(got), ref, rtol=2 ** -8,
                                   atol=2 ** -8 * np.abs(ref).max())


def test_layer_norm_gradients_match_the_custom_vjp():
    """The reference's scale and shift run through a custom vjp
    (``_scale_shift``; at 8,192 rows or more its parameter gradients take
    a two-stage sum); the port's plain autograd of the same closed form
    gives the same gradients (rtol/atol 1e-5: f32 sums in another
    order)."""
    rng = np.random.default_rng(3)
    for shape in ((6, 7, 32), (2, 4100, 16)):
        h = shape[-1]
        x = rng.standard_normal(shape).astype(np.float32)
        w = rng.standard_normal(h).astype(np.float32)
        b = rng.standard_normal(h).astype(np.float32)
        g = rng.standard_normal(shape).astype(np.float32)
        jt = [paddle.to_tensor(a) for a in (x, w, b)]
        for t in jt:
            t.stop_gradient = False
        (JF.layer_norm(jt[0], h, jt[1], jt[2], epsilon=1e-12)
         * paddle.to_tensor(g)).sum().backward()
        tt = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
        (F.layer_norm(tt[0], h, tt[1], tt[2], epsilon=1e-12)
         * torch.from_numpy(g)).sum().backward()
        for j, t in zip(jt, tt):
            np.testing.assert_allclose(t.grad.numpy(), _jnp(j.grad),
                                       rtol=1e-5, atol=1e-5)


def test_layer_norm_layer_parameters():
    ln = LayerNorm(16, epsilon=1e-12, device="cpu")
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    assert torch.equal(ln.weight, torch.ones(16))
    assert torch.equal(ln.bias, torch.zeros(16))
    assert LayerNorm(16, weight_attr=False, device="cpu").weight is None


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 4
    ref = _jnp(JF.gelu(paddle.to_tensor(x), approximate=approximate))
    got = F.gelu(torch.from_numpy(x), approximate=approximate)
    # erf / tanh evaluated by two libraries: a few f32 ulps
    np.testing.assert_allclose(_np(got), ref, rtol=1e-6, atol=1e-6)


def test_tanh_matches_jax():
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32) * 3
    ref = _jnp(JF.tanh(paddle.to_tensor(x)))
    np.testing.assert_allclose(_np(F.tanh(torch.from_numpy(x))), ref,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_embedding_matches_jax_with_padding_idx(padding_idx):
    """Bitwise forward; the weight's gradient within 1e-6 (the same rows
    summed in another order), zero at ``padding_idx``."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((10, 8)).astype(np.float32)
    ids = rng.integers(0, 10, (4, 9)).astype(np.int32)
    ids[0, :3] = 3
    g = rng.standard_normal((4, 9, 8)).astype(np.float32)
    jw = paddle.to_tensor(w)
    jw.stop_gradient = False
    jo = JF.embedding(paddle.to_tensor(ids), jw, padding_idx=padding_idx)
    (jo * paddle.to_tensor(g)).sum().backward()
    tw = torch.from_numpy(w).requires_grad_()
    to = F.embedding(torch.from_numpy(ids), tw, padding_idx=padding_idx)
    (to * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(_np(to), _jnp(jo))
    np.testing.assert_allclose(tw.grad.numpy(), _jnp(jw.grad), rtol=1e-6,
                               atol=1e-6)
    if padding_idx is not None:
        assert not bool(to[0, :3].any()) and not bool(tw.grad[3].any())


def test_embedding_sparse_is_refused():
    with pytest.raises(NotImplementedError, match="queue item 4"):
        F.embedding(torch.zeros(2, dtype=torch.int64), torch.ones(4, 2),
                    sparse=True)


def test_dropout_identity_cases_match_jax():
    """``training=False`` or ``p == 0`` returns the input unchanged, in
    both modes, as the reference does."""
    x = np.random.default_rng(7).standard_normal((5, 6)).astype(np.float32)
    t = torch.from_numpy(x)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        for p, training in ((0.3, False), (0.0, True)):
            ref = _jnp(JF.dropout(paddle.to_tensor(x), p, training=training,
                                  mode=mode))
            got = F.dropout(t, p, training=training, mode=mode)
            assert got is t
            np.testing.assert_array_equal(_np(got), ref)
    layer = Dropout(0.5, device="cpu").eval()
    assert layer(t) is t


def test_dropout_keep_rate_and_divide_not_multiply():
    """At p = 0.1 over 2^20 elements: the keep rate within 0.003 of 0.9
    (ten binomial standard deviations), every kept value bitwise ``x /
    f32(0.9)`` (the quotient correctly rounded: computed in f64 and
    rounded once) and the dropped ones zero; on these inputs a multiply
    by the f32 reciprocal differs somewhere, so the check tells them
    apart."""
    n, p = 1 << 20, 0.1
    x = torch.from_numpy(
        np.random.default_rng(8).standard_normal(n).astype(np.float32))
    g = torch.Generator().manual_seed(11)
    y = F.dropout(x, p, generator=g)
    keep = y != 0
    assert abs(float(keep.double().mean()) - (1 - p)) <= 0.003
    div = (x.double() / float(np.float32(1 - p))).float()
    assert torch.equal(y[keep], div[keep])
    assert not bool(y[~keep].any())
    recip = x * (1.0 / torch.tensor(np.float32(1 - p)))
    assert not torch.equal(recip, div)


def test_dropout_generator_axis_and_modes():
    x = torch.ones(64, 8, 16)
    a = F.dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
    b = F.dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
    c = F.dropout(x, 0.5, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the mask is shared along the axes not listed (the reference's shape)
    for axis, shape in ((0, (64, 1, 1)), ([0, 2], (64, 1, 16)),
                        (-1, (1, 1, 16))):
        y = F.dropout(x, 0.5, axis=axis,
                      generator=torch.Generator().manual_seed(3))
        keep = (y != 0)
        full = keep.any(dim=[i for i in range(3) if shape[i] == 1],
                        keepdim=True)
        assert full.shape == shape
        assert torch.equal(keep, full.expand_as(keep))
    # downscale_in_infer keeps the kept values as they are
    y = F.dropout(x * 3, 0.25, mode="downscale_in_infer",
                  generator=torch.Generator().manual_seed(4))
    assert set(y.unique().tolist()) == {0.0, 3.0}
    # masks never come from torch's global generator
    before = torch.get_rng_state()
    F.dropout(x, 0.5, generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), before)
    with pytest.raises(ValueError, match="generator"):
        F.dropout(x, 0.5)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="upscale", generator=torch.Generator())


def test_attention_dropout_is_the_plain_attention_with_the_mask():
    """``_sdpa_ref`` with dropout equals the same attention's softmax
    weights dropped by hand with the mask the generator draws (rtol/atol
    1e-6: the same f32 operations); it is the reference's ``_sdpa_ref``
    at p = 0 (rtol/atol 1e-5)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 12, 3, 8)).astype(
        np.float32)) for _ in range(3))
    mask = torch.from_numpy(np.where(rng.random((2, 1, 1, 12)) < 0.2, -1e9,
                                     0.0).astype(np.float32))
    g = torch.Generator().manual_seed(21)
    replay = torch.Generator().set_state(g.get_state())
    got = F._sdpa_ref(q, k, v, mask, 0.2, False, None, generator=g)
    w = torch.softmax(torch.matmul(q.transpose(1, 2),
                                   k.transpose(1, 2).transpose(-1, -2))
                      / math.sqrt(8) + mask, dim=-1)
    keep = torch.rand(w.shape, generator=replay) < 0.8
    want = torch.matmul(torch.where(keep, w / torch.tensor(0.8), 0.0),
                        v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    from paddle_tpu.nn.functional.attention import _sdpa_ref as jax_sdpa
    ref = jax_sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v, mask)), 0.0,
                   False, None)
    np.testing.assert_allclose(
        _np(F._sdpa_ref(q, k, v, mask, 0.0, False, None)), np.asarray(ref),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------

def test_state_dict_keys_and_the_tie(pretrain):
    """The reference's 38 keys, the decoder tied to the word embedding
    as one parameter, AdamW decaying every parameter (no
    ``apply_decay_param_fun``), as the reference's."""
    jm, arrays = pretrain
    tm = _port(arrays)
    assert len(arrays) == 38 and sorted(tm.state_dict()) == sorted(arrays)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(arrays) and len(names) == 38
    assert not any("decoder" in n for n in names)
    opt = AdamW(LR, parameters=tm.parameters())
    assert all(float(st["decay"]) == 1.0 for st in opt.opt_state())
    jopt = paddle.optimizer.AdamW(LR, parameters=jm.parameters())
    assert all(jopt._decay_flags.values())


def test_tied_gradient_is_the_sum_of_both_uses(pretrain, batch):
    """The word embedding's gradient is the embedding gather's gradient
    (scattered by id) plus the decoder's (dlogits^T h), within 1e-6."""
    tm = _port(pretrain[1])
    seen = {}

    def keep(name):
        def hook(mod, inputs, out):
            out.retain_grad()
            seen[name] = out
        return hook

    tm.bert.embeddings.word_embeddings.register_forward_hook(keep("emb"))
    tm.mlm_norm.register_forward_hook(keep("h"))
    ids = torch.from_numpy(batch["ids"])
    lg, ns = tm(ids, masked_positions=torch.from_numpy(batch["pos"]))
    lg.retain_grad()
    loss = tb.BertPretrainingCriterion(V)(
        lg, ns, torch.from_numpy(batch["mlm"]), torch.from_numpy(batch["nsp"]))
    loss.backward()
    w = tm.bert.embeddings.word_embeddings.weight
    from_emb = torch.zeros_like(w).index_add_(
        0, ids.reshape(-1).long(), seen["emb"].grad.reshape(-1, w.shape[1]))
    from_dec = lg.grad.reshape(-1, V).t() @ seen["h"].detach().reshape(
        -1, w.shape[1])
    torch.testing.assert_close(w.grad, from_emb + from_dec, rtol=1e-6,
                               atol=1e-6)
    assert bool(from_emb.abs().sum() > 0) and bool(from_dec.abs().sum() > 0)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_model_eval_matches_jax(pretrain, batch, masked):
    """Sequence and pooled outputs in eval (dropout off), with and
    without the padding mask: rtol/atol 1e-5."""
    arrays = {k[len("bert."):]: v for k, v in pretrain[1].items()
              if k.startswith("bert.")}
    paddle.seed(1)
    jm = jb.BertModel(jb.bert_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    jm.eval()
    tm = _port(arrays, tb.BertModel, **{k: 0.1 for k in NO_DROP}).eval()
    mask = batch["mask"] if masked else None
    jseq, jpool = jm(paddle.to_tensor(batch["ids"]), attention_mask=(
        None if mask is None else paddle.to_tensor(mask)))
    tseq, tpool = tm(torch.from_numpy(batch["ids"]), attention_mask=(
        None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(_np(tseq), _jnp(jseq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tpool), _jnp(jpool), rtol=1e-5,
                               atol=1e-5)
    if masked:
        # the mask matters: padded keys change the attended rows
        free, _ = tm(torch.from_numpy(batch["ids"]))
        assert not torch.allclose(free[1], tseq[1], atol=1e-3)


@pytest.mark.parametrize("weighted", [False, True])
def test_pretraining_loss_matches_jax(pretrain, batch, weighted):
    """The MLM logits at the masked positions, the NSP logits and the
    criterion's loss, with and without ``mlm_weights``: rtol 1e-5."""
    jm, arrays = pretrain
    tm = _port(arrays)
    wts = (np.random.default_rng(12).random((B, M)).astype(np.float32)
           if weighted else None)
    jl, jn = jm(paddle.to_tensor(batch["ids"]),
                attention_mask=paddle.to_tensor(batch["mask"]),
                masked_positions=paddle.to_tensor(batch["pos"]))
    tl, tn = tm(torch.from_numpy(batch["ids"]),
                attention_mask=torch.from_numpy(batch["mask"]),
                masked_positions=torch.from_numpy(batch["pos"]))
    assert tuple(tl.shape) == (B, M, V)
    np.testing.assert_allclose(_np(tl), _jnp(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tn), _jnp(jn), rtol=1e-5, atol=1e-5)
    jargs = [jl, jn, paddle.to_tensor(batch["mlm"]),
             paddle.to_tensor(batch["nsp"])]
    targs = [tl, tn, torch.from_numpy(batch["mlm"]),
             torch.from_numpy(batch["nsp"])]
    if weighted:
        jargs.append(paddle.to_tensor(wts))
        targs.append(torch.from_numpy(wts))
    jloss = float(jb.BertPretrainingCriterion(V)(*jargs))
    tloss = tb.BertPretrainingCriterion(V)(*targs).item()
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)


def _steps(pretrain, batch, amp):
    """One AdamW step (lr 1e-3) of each package from the same weights
    on the same batch, bf16 AMP or f32; returns (JAX loss, port loss,
    JAX weights after, port model, the dtypes the port's loss_fn saw)."""
    jarrays = pretrain[1]
    paddle.seed(0)
    jm = jb.BertForPretraining(jb.bert_tiny(**NO_DROP))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in jarrays.items()})
    tm = _port(jarrays)
    mesh = mesh_mod.init_mesh({"dp": 1}, devices=jax.devices()[:1])
    js, ts = JStrategy(), DistributedStrategy()
    if amp:
        for s in (js, ts):
            s.amp = True
            s.amp_configs = {"dtype": "bfloat16"}
    jc, tc = jb.BertPretrainingCriterion(V), tb.BertPretrainingCriterion(V)

    def jloss(ids, pos, mlm, nsp):
        lg, ns = jm(ids, masked_positions=pos)
        return jc(lg, ns, mlm, nsp)

    seen = []

    def tloss(ids, pos, mlm, nsp):
        seen.extend(t.dtype for t in (ids, pos, mlm, nsp))
        lg, ns = tm(ids, masked_positions=pos)
        return tc(lg, ns, mlm, nsp)

    jstep = JStep(jm, jloss, paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters()), js, mesh=mesh)
    tstep = DistributedTrainStep(tm, tloss, AdamW(
        learning_rate=LR, parameters=tm.parameters()), ts)
    keys = ("ids", "pos", "mlm", "nsp")
    jl = float(jstep(*[paddle.to_tensor(batch[k]) for k in keys]))
    tl = tstep(*[torch.from_numpy(batch[k]) for k in keys])
    assert tl.dtype == torch.float32
    return jl, tl.item(), _arrays(jm), tm, seen


def _step_diff(name, p, jw):
    """|port - reference| of parameter ``name`` after the step, without
    the key third of each ``qkv_proj.bias``: a key bias adds q . b_k to
    every logit of a row, which the softmax cancels, so its gradient is
    zero and each package's is rounding noise, which Adam's first step
    turns into +-lr by its sign."""
    d = np.abs(_np(p) - jw[name])
    if name.endswith("qkv_proj.bias"):
        h = d.shape[0] // 3
        d = np.concatenate([d[:h], d[2 * h:]])
    return d


def test_f32_adamw_step_matches_jax(pretrain, batch):
    """The loss within rtol 1e-5 (the same f32 math); every parameter
    after the step within 0.25 lr elementwise and 1e-4 lr on average.
    Adam's first step moves an element by lr * g / (|g| + eps): where a
    gradient is within f32 rounding noise of zero (|g| near eps = 1e-8)
    the two packages' steps differ by a visible share of lr (measured:
    0.111 lr at one element of ``mlm_transform.weight``, the mean at most
    7.2e-6 lr)."""
    jl, tl, jw, tm, _ = _steps(pretrain, batch, amp=False)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for n, p in tm.named_parameters():
        d = _step_diff(n, p, jw)
        assert d.max() <= 0.25 * LR, (n, d.max() / LR)
        assert d.mean() <= 1e-4 * LR, (n, d.mean() / LR)


def test_bf16_amp_adamw_step_matches_jax(pretrain, batch):
    """bf16 AMP over f32 masters; int ids, positions and labels reach
    the model uncast.  The loss within 2.4e-3 relative (the Llama AMP
    test's bound: the activations round to bf16 at different points of
    the two frameworks' fusions; measured 6.8e-4).  The masters: Adam's
    first step moves every element by about lr whatever the gradient's
    size, so an element whose gradient is bf16 noise can move by +lr in
    one package and -lr in the other: every element within 2.01 lr (2 lr
    and the decay's share), the mean within 0.05 lr per parameter, the
    Llama AMP test's bound (measured: 2.0 lr at most; the mean at most
    0.031 lr, two of the 128 elements of ``layers.1``'s
    ``out_proj.bias``)."""
    jl, tl, jw, tm, seen = _steps(pretrain, batch, amp=True)
    assert seen == [torch.int32, torch.int32, torch.int64, torch.int64]
    assert abs(tl - jl) <= 2.4e-3 * abs(jl)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32
        d = _step_diff(n, p, jw)
        assert d.max() <= 2.01 * LR, (n, d.max() / LR)
        assert d.mean() <= 0.05 * LR, (n, d.mean() / LR)


def test_recompute_replays_the_dropout_masks(pretrain, batch):
    """With dropout on, a step with ``strategy.recompute`` draws the same
    masks in its recomputation as in its forward: its loss and gradients
    equal the step without recompute from the same generator state
    (atol 1e-6: the same f32 math)."""
    out = []
    for recompute in (False, True):
        tm = _port(pretrain[1], **{k: 0.1 for k in NO_DROP})
        tm.bert.embeddings.dropout.generator.manual_seed(5)
        s = DistributedStrategy()
        s.recompute = recompute
        crit = tb.BertPretrainingCriterion(V)

        def loss_fn(ids, pos, mlm, nsp, tm=tm):
            lg, ns = tm(ids, masked_positions=pos)
            return crit(lg, ns, mlm, nsp)

        step = DistributedTrainStep(tm, loss_fn, AdamW(
            LR, parameters=tm.parameters()), s)
        out.append(step.loss_and_grads(
            *[torch.from_numpy(batch[k])
              for k in ("ids", "pos", "mlm", "nsp")]))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_flash_route_at_1024_and_its_dropout_refused(pretrain, monkeypatch):
    """(The port used to refuse attention dropout on the flash route; it
    now drops inside kernels 1-3, as the reference does.)  With no padding
    mask at S = 1,024 (head_dim 64) the port's attention takes kernel 1's
    entry point (its plain version on the CPU) where the reference on the
    CPU takes ``_sdpa_ref``: the same exact attention, rtol/atol 1e-5.  In
    training with attention dropout it takes the flash entry with a seed
    drawn from the model's dropout generator: a layer's output is
    ``_sdpa_ref``'s composition with that seed's ``dropout_keep_mask``
    applied to the weights (atol 1e-5), and a step under ``recompute``
    redraws each layer's seed (the same masks, bitwise) and gives the
    loss and gradients of the step without it, bitwise."""
    kw = dict(max_position_embeddings=1024)
    paddle.seed(2)
    jm = jb.BertModel(jb.bert_tiny(**kw, **NO_DROP))
    jm.eval()
    arrays = _arrays(jm)
    tm = _port(arrays, tb.BertModel, **kw).eval()
    ids = np.random.RandomState(3).randint(0, V, (1, 1024)).astype("int32")
    jseq, _ = jm(paddle.to_tensor(ids))
    tseq, _ = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(tseq), _jnp(jseq), rtol=1e-5, atol=1e-5)
    assert registry.spec("flash_attention").torch_ref_calls == 2

    # training: in-kernel dropout from a seed the layer draws
    train = _port(arrays, tb.BertModel, max_position_embeddings=1024,
                  attention_probs_dropout_prob=0.1)
    att = train.layers[0].attention
    hidden = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (1, 1024, 128)).astype(np.float32))
    state = att.generator.get_state()
    registry.reset_counts()
    got = att(hidden)
    assert registry.spec("flash_attention").torch_ref_calls == 1
    att.generator.set_state(state)
    seed = fa.dropout_seed(att.generator)
    with torch.no_grad():
        q, k, v = (t.reshape(1, 1024, 2, 64).transpose(1, 2) for t in
                   att.qkv_proj(hidden).split(128, dim=-1))
        w = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1)
        keep = fa.dropout_keep_mask(seed, 1, 2, 1024, 1024, 0.1)
        w = torch.where(keep, w / torch.tensor(0.9), 0.0)
        want = att.out_proj((w @ v).transpose(1, 2).reshape(1, 1024, 128))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)

    # recompute replays the seeds, so the masks, bitwise
    seeds = []
    real = tb.dropout_seed

    def logged(gen):
        s = real(gen)
        seeds.append(int(s))
        return s

    monkeypatch.setattr(tb, "dropout_seed", logged)
    out, drawn = [], []
    pos = np.sort(np.random.RandomState(5).randint(0, 1024, (1, 4)),
                  axis=1).astype("int32")
    args = [torch.from_numpy(a) for a in (
        ids, pos, np.array([[1, 2, 3, 4]], np.int64), np.array([1]))]
    for recompute in (False, True):
        pm = tb.BertForPretraining(
            tb.bert_tiny(max_position_embeddings=1024,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.1), device="cpu",
            generator=torch.Generator().manual_seed(0),
            dropout_generator=torch.Generator().manual_seed(5))
        s = DistributedStrategy()
        s.recompute = recompute
        crit = tb.BertPretrainingCriterion(V)

        def loss_fn(ids_, pos_, mlm, nsp, pm=pm):
            lg, ns = pm(ids_, masked_positions=pos_)
            return crit(lg, ns, mlm, nsp)

        seeds.clear()
        step = DistributedTrainStep(pm, loss_fn, AdamW(
            LR, parameters=pm.parameters()), s)
        out.append(step.loss_and_grads(*args))
        drawn.append(list(seeds))
    # one seed a layer; under recompute each drawn again, the same
    assert len(set(drawn[0])) == len(drawn[0]) == 2
    assert sorted(drawn[1]) == sorted(drawn[0] * 2)
    (l0, g0), (l1, g1) = out
    assert torch.equal(l1, l0)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert registry.spec("flash_attention_bwd_dkv").torch_ref_calls == 4


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for cls in (tb.BertModel, tb.BertForPretraining):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(tb.bert_tiny())


# ---------------------------------------------------------------------
# int8 inference: kernel 6 at the pooler
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair(pretrain):
    """The JAX and the port ``BertModel(bert_tiny())`` from the same
    weights, each converted with ``convert_to_int8_inference`` at f32
    compute."""
    arrays = {k[len("bert."):]: v for k, v in pretrain[1].items()
              if k.startswith("bert.")}
    paddle.seed(1)
    jm = jb.BertModel(jb.bert_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    jax_convert(jm, compute_dtype=jnp.float32)
    tm = _port(arrays, tb.BertModel)
    convert_to_int8_inference(tm, compute_dtype=torch.float32)
    return jm, tm


def test_int8_conversion_swaps_only_the_pooler(int8_pair):
    jm, tm = int8_pair
    swapped = [n for n, m in tm.named_modules()
               if isinstance(m, Int8InferenceLinear)]
    assert swapped == ["pooler"] and not tm.training
    jswapped = [n for n, m in jm.named_sublayers()
                if type(m).__name__ == "Int8InferenceLinear"]
    assert jswapped == ["pooler"]
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert tm.pooler.qweight.dtype == torch.int8


@pytest.mark.parametrize("jmode", ["xla_ref", "interpret"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_int8_pooler_bitwise_on_the_jax_trunk(pretrain, batch, jmode, cdt):
    """The port's int8 pooler fed the JAX trunk's [CLS] rows gives the
    JAX pooler's output bitwise (integer sums are order-free; the
    activation scale, codes and rescale are the reference's
    expressions), against the reference's plain route and its Pallas
    kernel in interpret mode, at f32 and bf16 compute."""
    arrays = {k[len("bert."):]: v for k, v in pretrain[1].items()
              if k.startswith("bert.")}
    jdt = jnp.float32 if cdt == "float32" else jnp.bfloat16
    paddle.seed(1)
    jm = jb.BertModel(jb.bert_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    jax_convert(jm, compute_dtype=jdt)
    tm = _port(arrays, tb.BertModel)
    convert_to_int8_inference(tm, compute_dtype=getattr(torch, cdt))
    jseq, _ = jm(paddle.to_tensor(batch["ids"]))
    cls = _jnp(jseq)[:, 0]
    # the trunk above takes the default route; the pooler alone (no
    # gradient to trace) takes the route under test
    jreg.set_mode("int8_matmul", jmode)
    jlin = jm.pooler(paddle.to_tensor(cls))
    jreg.set_mode("int8_matmul", None)
    tlin = tm.pooler(torch.from_numpy(cls))
    assert tlin.dtype == getattr(torch, cdt)
    np.testing.assert_array_equal(_np(tlin), _jnp(jlin))
    assert registry.spec("int8_matmul").torch_ref_calls == 1


def test_int8_model_matches_jax(int8_pair, batch):
    """The whole int8 model at f32 compute: the trunks agree to ~1e-6
    (f32), and the per-tensor activation scale and codes then agree
    unless a value sits on a rounding tie, where one code can move by 1
    and the pooled output by up to x_scale * w_scale * |q| of that term
    (at most max|x| * max|w|/127 here); measured: bitwise.  The bound:
    atol 2e-6 on the pre-tanh output of magnitude ~1."""
    jm, tm = int8_pair
    jreg.set_mode("int8_matmul", "xla_ref")
    jseq, jpool = jm(paddle.to_tensor(batch["ids"]),
                     attention_mask=paddle.to_tensor(batch["mask"]))
    jreg.set_mode("int8_matmul", None)
    with torch.no_grad():
        tseq, tpool = tm(torch.from_numpy(batch["ids"]),
                         attention_mask=torch.from_numpy(batch["mask"]))
        set_kernel_mode(tm, "torch_ref")
        _, again = tm(torch.from_numpy(batch["ids"]),
                      attention_mask=torch.from_numpy(batch["mask"]))
        set_kernel_mode(tm, None)
    np.testing.assert_allclose(_np(tseq), _jnp(jseq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tpool), _jnp(jpool), rtol=0, atol=2e-6)
    assert torch.equal(again, tpool)
    assert registry.spec("int8_matmul").torch_ref_calls == 2


@pytest.mark.parametrize("M", [1, 8, 32, 128, 100])
def test_int8_plan_at_the_pooler(M):
    """Kernel 6's dynamic plan at BERT-base's pooler (K = N = 768, bf16
    out): 768-byte rows (TMA's 16-byte alignment), six 128-byte k-tiles,
    TMA stores, one block an SM at most, shared memory within the
    card's 227 KB."""
    plan = int8_mm_plan(M, 768, 768, 132, 2)
    assert plan.k_tiles == 6 and plan.tma_store
    assert plan.block_n == 128 and plan.block_m in (64, 128)
    assert plan.grid == -(-M // plan.block_m) * 6 <= 132
    assert plan.smem_bytes <= 232_448 and 1 <= plan.stages <= 8
