"""The port's long-sequence memory savers and the whole one-device
training slice against the JAX reference.

- ``chunked_attention`` (the reference's ``_ref_chunked``): output and
  the gradients of q, k, v at S 1,024-1,100 (chunks of 512, 275 and one
  block for a prime length), causal or not, with a bias row, in f32:
  within 1e-5 (the same f32 products in another order);
- the chunked LM loss against the reference's ``_chunked_causal_lm_loss``
  and against the plain loss: the loss within 1e-6 relative and the
  gradients of the hidden states and the head within 1e-5, both head
  layouts; a tiny Llama's step with the thresholds lowered inside the
  test, as the reference's tests lower them;
- the whole slice: a tiny Llama at 1,024 positions (chunked attention
  on both sides, the chunked loss with its threshold lowered) trained
  through ``DistributedTrainStep`` with AdamW under ``LinearWarmup(
  CosineAnnealingDecay)``, ``ClipGradByGlobalNorm``, gradient merge
  (k = 2) and ``guard_health``, against the JAX step: losses and health
  vectors within 1e-5 relative, the f32 masters after 3 applied steps
  within 2e-6 absolute (about 1e-3 of one step's lr; see the test).
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.text.models import llama_tiny as jax_tiny

from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.ops.kernels.flash_attention import chunked_attention
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.text.models import llama as tllama

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jllama = importlib.import_module("paddle_tpu.text.models.llama")


@pytest.fixture(autouse=True)
def _clean():
    registry.reset_counts()
    mesh_mod.set_mesh(None)
    yield
    registry.reset_counts()
    mesh_mod.set_mesh(None)


@pytest.fixture
def low_threshold(monkeypatch):
    """The chunked loss engaged at a tiny model's logits in both
    packages (the thresholds are module constants)."""
    monkeypatch.setattr(tllama, "_CHUNK_BYTES_MIN", 0)
    monkeypatch.setattr(jllama, "_CHUNK_BYTES_MIN", 0)


# ---------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S,causal,bias", [
    (1024, True, False),      # two chunks of 512
    (1100, True, False),      # four chunks of 275
    (1031, False, False),     # a prime length: one block
    (1100, False, True),      # a padding row
])
def test_chunked_attention_matches_jax(S, causal, bias):
    rng = np.random.RandomState(S)
    q, k, v, g = (rng.randn(2, S, 2, 16).astype(np.float32)
                  for _ in range(4))
    b = None
    if bias:
        b = np.zeros((2, 1, 1, S), np.float32)
        b[1, ..., S - 37:] = -1e9
    jb = None if b is None else jnp.asarray(b)

    def jloss(q_, k_, v_):
        o = jfa.chunked_attention(q_, k_, v_, bias=jb, causal=causal)
        return jnp.sum(o * g), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(*map(jnp.asarray,
                                                        (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = chunked_attention(tq, tk, tv,
                           bias=None if b is None else torch.from_numpy(b),
                           causal=causal)
    tg = torch.autograd.grad((to * torch.from_numpy(g)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for a, e in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-5)


def test_long_flash_ineligible_attention_takes_the_chunked_path():
    """head_dim 16 is flash-ineligible: at 1,024 positions the training
    attention is chunked (no flash call, plain or kernel), below it the
    plain attention; the chunked forward equals the plain one."""
    tm = LlamaForCausalLM(llama_tiny(max_position_embeddings=1024,
                                     compute_dtype="float32"), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, 1024)).astype(np.int64))
    attn = tm.model.layers[0].self_attn
    h = torch.randn(1, 1024, 64)
    pos = torch.arange(1024)[None]
    chunked = attn(h, pos)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tllama, "chunked_attention", lambda *a, **k: (_ for _ in
                   ()).throw(AssertionError("not the chunked path")))
        with pytest.raises(AssertionError, match="chunked path"):
            attn(h, pos)
        attn(h[:, :512], pos[:, :512])          # short: plain attention
    from paddle_tpu_torch.nn.functional import _sdpa_ref
    c = attn.config
    q = attn.q_proj(h).reshape(1, 1024, 4, 16)
    k = attn.k_proj(h).reshape(1, 1024, 2, 16)
    v = attn.v_proj(h).reshape(1, 1024, 2, 16)
    q, k = tllama._rope(q, pos, c.rope_theta), tllama._rope(k, pos,
                                                            c.rope_theta)
    k, v = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    plain = attn.o_proj(_sdpa_ref(q, k, v, None, 0.0, True, None)
                        .reshape(1, 1024, 64))
    torch.testing.assert_close(chunked, plain, rtol=1e-5, atol=1e-5)
    assert tm(ids, labels=ids)[1] is not None
    assert registry.spec("flash_attention").torch_ref_calls == 0


# ---------------------------------------------------------------------
# the chunked LM loss
# ---------------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True])
def test_chunked_lm_loss_matches_jax_and_the_plain_loss(transposed):
    rng = np.random.RandomState(7)
    B, S, H, V = 2, 600, 32, 50        # 599 targets: 3 chunks, padded
    h = rng.randn(B, S, H).astype(np.float32)
    w = (rng.randn(V, H) if transposed else rng.randn(H, V)).astype(
        np.float32) * 0.2
    lb = rng.randint(0, V, (B, S)).astype(np.int32)
    lb[0, 100:130] = -100

    def jloss(h_, w_):
        return jllama._chunked_causal_lm_loss(h_, w_, jnp.asarray(lb),
                                              transposed)

    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = tllama._chunked_causal_lm_loss(th, tw, torch.from_numpy(lb),
                                        transposed)
    tgh, tgw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-7)
    # the plain path on the full logits gives the same loss and gradients
    th2 = torch.from_numpy(h).requires_grad_()
    tw2 = torch.from_numpy(w).requires_grad_()
    logits = th2 @ (tw2.t() if transposed else tw2)
    pl = tllama._causal_lm_loss(logits, torch.from_numpy(lb))
    pgh, pgw = torch.autograd.grad(pl, (th2, tw2))
    np.testing.assert_allclose(tl.item(), pl.item(), rtol=1e-6)
    torch.testing.assert_close(tgh, pgh, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(tgw, pgw, rtol=1e-5, atol=1e-7)


def test_chunked_loss_rounds_the_cotangent_to_the_weights_dtype():
    """bf16 weights: the projection's backward multiplies the cotangent
    rounded to bf16 (the reference's ``_proj_chunk`` vjp), and each
    gradient comes back in its input's dtype."""
    rng = np.random.RandomState(2)
    h = torch.from_numpy(rng.randn(1, 8, 16).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    w = torch.from_numpy(rng.randn(16, 24).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    g = torch.from_numpy(rng.randn(1, 8, 24).astype(np.float32))
    out = tllama._ProjChunk.apply(h, w)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, h.float() @ w.float(), rtol=0, atol=0)
    dh, dw = torch.autograd.grad(out, (h, w), g)
    gl = g.to(torch.bfloat16).float()
    assert dh.dtype == dw.dtype == torch.bfloat16
    torch.testing.assert_close(dh, (gl @ w.float().t()).to(torch.bfloat16))
    torch.testing.assert_close(
        dw, (h.float()[0].t() @ gl[0]).to(torch.bfloat16))


def _models(S=1024, **kw):
    d = dict(max_position_embeddings=S, compute_dtype="float32")
    d.update(kw)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**d))
    arrays = {k: np.asarray(v._value).astype(np.float32)
              for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**d), device="cpu")
    load_jax_state_dict(tm, arrays)
    return jm, tm


def _ids(S, B, seed):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


def test_step_engages_the_chunked_loss_only_inside(low_threshold):
    """Inside the train step the model returns ``(loss, None)`` (the
    chunked loss); an eager call keeps the logits; the two losses and the
    eager loss's gradients agree."""
    _, tm = _models(S=1024)
    ids = torch.from_numpy(_ids(1024, 1, 3))
    seen = []

    def loss_fn(a):
        loss, logits = tm(a, labels=a)
        seen.append(logits)
        return loss

    step = DistributedTrainStep(tm, loss_fn, AdamW(1e-3, parameters=list(
        tm.parameters())))
    ls, gs = step.loss_and_grads(ids)
    assert seen == [None]
    le, logits = tm(ids, labels=ids)
    assert logits is not None and logits.shape == (1, 1024, 256)
    ge = torch.autograd.grad(le, list(tm.parameters()))
    np.testing.assert_allclose(ls.item(), le.item(), rtol=1e-6)
    for a, b in zip(gs, ge):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------

def test_whole_slice_trains_like_the_jax_step(low_threshold):
    """Three applied AdamW steps (six calls of a k = 2 merge) of a tiny
    Llama at 1,024 positions, with a warmup + cosine schedule stepped
    after every applied step, a global-norm clip that engages, and
    ``guard_health``, against the JAX step on the same weights and ids.
    The masters: the gradients agree to ~1e-6 relative, and Adam's
    first steps move an element by about lr whatever its gradient's
    size, so an element whose gradient is rounding noise can part by a
    fraction of lr (measured at most 1.5e-7 at lr 1e-3, on the MLP's
    down projection); held to 2e-6."""
    jm, tm = _models(S=1024)
    mesh = mesh_mod.init_mesh({"dp": 1}, devices=jax.devices()[:1])

    def sched(lr):
        return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=4), 2,
                               1e-4, 1e-3)

    js_, ts_ = JStrategy(), DistributedStrategy()
    for s in (js_, ts_):
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": 2, "avg": True}
    jsched, tsched = sched(jlr), sched(tlr)
    jopt = paddle.optimizer.AdamW(jsched, parameters=jm.parameters(),
                                  grad_clip=jclip.ClipGradByGlobalNorm(0.1))
    topt = AdamW(tsched, parameters=list(tm.parameters()),
                 grad_clip=tclip.ClipGradByGlobalNorm(0.1))
    jstep = JStep(jm, lambda a: jm(a, labels=a)[0], jopt, js_, mesh=mesh,
                  guard_health=True)
    tstep = DistributedTrainStep(tm, lambda a: tm(a, labels=a)[0], topt,
                                 ts_, guard_health=True)
    init = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    lrs = []
    for call in range(6):
        ids = _ids(1024, 1, 10 + call)
        jl = float(jstep(paddle.to_tensor(ids)))
        tl = tstep(torch.from_numpy(ids)).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tstep.last_health.numpy(),
                                   np.asarray(jstep.last_health), rtol=1e-5)
        if call % 2:
            # the clip engages: the window's mean gradient is over 0.1
            assert tstep.last_health[0].item() / 2 > 0.1
            lrs.append(topt.get_lr())
            assert topt.get_lr() == jopt.get_lr()
            jsched.step()
            tsched.step()
    assert lrs == [1e-4, pytest.approx(5.5e-4), 1e-3]
    jw = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for n, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - jw[n]).max()
        assert d <= 2e-6, (n, d)
        assert np.abs(p.detach().numpy() - init[n]).max() > 1e-4, n
    assert registry.spec("flash_attention").torch_ref_calls == 0
