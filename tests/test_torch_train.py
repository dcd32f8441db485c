"""The PyTorch port's Llama training path against the JAX reference.

Weights made by the JAX model (from a seed) are carried into the port
with ``load_jax_state_dict``; the same ids then go through both.  The
model is ``llama_tiny(scan_layers=True, remat=True)`` widened to head_dim
64 (hidden 128, 2 heads, 1 kv head), so that at sequence 1024 the port
takes the flash path (its autograd Function; plain versions on the CPU)
while the reference on the CPU takes its chunked attention -- both exact
attention.  Tolerances, each with its reason at the test:

- eager loss and every parameter gradient at f32 compute: relative 1e-5
  (measured ~1e-6: the same f32 math in another order);
- the same at the default bf16 compute dtype: relative 1e-2 (measured at
  most 2.4e-3, on the embedding, see the test);
- three bf16-AMP ``DistributedTrainStep`` steps: losses within 1e-3
  relative, f32 master weights within 6 * lr of each other elementwise
  and 0.05 * lr on average per parameter (see the test).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.text.models import llama_tiny as jax_tiny

from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                          StackedLlamaDecoder, llama_tiny)
from paddle_tpu_torch.text.models.llama import _causal_lm_loss

LR = 1e-3


def _kw(**kw):
    d = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=128, max_position_embeddings=1024,
             scan_layers=True, remat=True)
    d.update(kw)
    return d


def _models(**kw):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**_kw(**kw)))
    arrays = {k: np.asarray(v._value).astype(np.float32)
              for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**_kw(**kw)), device="cpu")
    load_jax_state_dict(tm, arrays)
    return jm, tm


def _ids(S, B=2, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


@pytest.fixture(autouse=True)
def _clean():
    registry.reset_counts()
    mesh_mod.set_mesh(None)
    yield
    registry.reset_counts()
    mesh_mod.set_mesh(None)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------
# the model: eager loss and gradients
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S,compute_dtype,rel", [
    # f32: the same math in another order (measured ~1e-6)
    (1024, "float32", 1e-5),
    # bf16 compute: the activations round to bf16 at different points
    # of the two frameworks' fusions; worst on the embedding, whose
    # gradient is the bf16 cotangent of the cast after the gather, summed
    # per token id in another order by PyTorch's index backward and XLA's
    # scatter-add (measured 2.4e-3)
    (1024, "bfloat16", 1e-2),
    # a short sequence takes the plain attention (_sdpa_ref) on both sides
    (64, "float32", 1e-5),
])
def test_loss_and_every_gradient_match_jax(S, compute_dtype, rel):
    jm, tm = _models(compute_dtype=compute_dtype)
    ids = _ids(S, B=1)
    jl, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jl.backward()
    tl, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tl.backward()
    assert logits.shape == (1, S, 256) and logits.dtype == torch.float32
    assert abs(float(jl) - tl.item()) <= rel * abs(float(jl))
    jg = {n: np.asarray(p.grad._value).astype(np.float32)
          for n, p in jm.named_parameters()}
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(jg)
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jg[n]) <= rel, n
    flash = registry.spec("flash_attention").torch_ref_calls
    # remat: each layer's forward runs again in the backward
    assert flash == (4 if S >= 1024 else 0)
    assert registry.spec("flash_attention_bwd_dkv").torch_ref_calls == (
        2 if S >= 1024 else 0)


def test_stacked_names_follow_the_reference():
    jm, tm = _models()
    assert isinstance(tm.model.decoder, StackedLlamaDecoder)
    assert len(tm.model.layers) == 0
    shapes = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert shapes == {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert shapes["model.decoder.self_attn__q_proj__weight"] == (2, 128, 128)
    assert not tm.supports_kv_cache()
    with pytest.raises(NotImplementedError, match="scan_layers=False"):
        tm.init_paged_cache(4, 8)


def test_remat_and_unstacked_layers_agree():
    """scan_layers and remat change where the work happens, not the
    result: the stacked model with remat against the per-layer model
    without it, on the same weights (f32, rel 1e-5)."""
    jm, tm = _models(compute_dtype="float32")
    flat = LlamaForCausalLM(llama_tiny(**_kw(compute_dtype="float32",
                                             scan_layers=False,
                                             remat=False)), device="cpu")
    with torch.no_grad():
        for n, p in flat.named_parameters():
            if ".layers." in n:
                i, rest = n.split(".layers.")[1].split(".", 1)
                src = getattr(tm.model.decoder, rest.replace(".", "__"))
                p.copy_(src[int(i)])
            else:
                p.copy_(dict(tm.named_parameters())[n])
    ids = torch.from_numpy(_ids(64, B=1))
    la, _ = tm(ids, labels=ids)
    lb, _ = flat(ids, labels=ids)
    la.backward()
    lb.backward()
    assert abs(la.item() - lb.item()) <= 1e-5 * abs(lb.item())
    g = tm.model.decoder.mlp__gate_proj__weight.grad
    for i, layer in enumerate(flat.model.layers):
        ref = layer.mlp.gate_proj.weight.grad.numpy()
        assert _rel(g[i].numpy(), ref) <= 1e-5


def test_causal_lm_loss_ignores_negative_labels():
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.randint(0, 7, (2, 5)).astype(np.int32)
    labels[0, 2] = labels[1, 4] = -100
    from paddle_tpu.text.models.llama import _causal_lm_loss as jloss
    ref = float(jloss(jnp.asarray(logits), jnp.asarray(labels)))
    got = _causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(got.item() - ref) <= 1e-6 * abs(ref)
    none = np.full((2, 5), -100, np.int32)
    assert _causal_lm_loss(torch.from_numpy(logits),
                           torch.from_numpy(none)).item() == 0.0


def test_no_future_token_reaches_a_position():
    _, tm = _models(compute_dtype="float32")
    ids = _ids(1024, B=1)
    ids2 = ids.copy()
    ids2[0, 600:] = (ids2[0, 600:] + 7) % 256
    with torch.no_grad():
        a = tm(torch.from_numpy(ids))
        b = tm(torch.from_numpy(ids2))
    assert torch.equal(a[:, :600], b[:, :600])
    assert not torch.equal(a[:, 600:], b[:, 600:])


# ---------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_adam_update_rule_matches_jax(cls):
    """Three updates of the same parameter from the same gradients: the
    same f32 ops in the same order (rel 1e-6)."""
    rng = np.random.RandomState(4)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    gs = rng.standard_normal((3, 5, 3)).astype(np.float32)
    jopt = getattr(paddle.optimizer, cls)(
        learning_rate=LR, parameters=[paddle.to_tensor(p0)])
    tp = torch.from_numpy(p0.copy())
    topt = {"Adam": Adam, "AdamW": AdamW}[cls](LR, parameters=[tp])
    jp, js = jnp.asarray(p0), None
    ts = None
    for g in gs:
        js = js or jopt.opt_state()[0]
        (jp,), (js,) = jopt.functional_update([jp], [jnp.asarray(g)], [js])
        ts = ts or topt.opt_state()[0]
        (tp,), (ts,) = topt.functional_update([tp], [torch.from_numpy(g)],
                                              [ts])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts["v"].numpy(), np.asarray(js["v"]),
                               rtol=1e-6)
    assert abs(ts["beta1_pow"].item() - 0.9 ** 3) < 1e-7


def test_step_and_clear_grad_update_in_place():
    w = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(LR, parameters=[w], apply_decay_param_fun=lambda n: False)
    (w * torch.tensor([1.0, -2.0, 0.0])).sum().backward()
    opt.step()
    # first Adam step: -lr * sign(g), no decay, zero gradient stays
    np.testing.assert_allclose(w.detach().numpy(),
                               [1 - LR, 1 + LR, 1.0], rtol=1e-6)
    opt.clear_grad()
    assert w.grad is None


# ---------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------

def test_three_amp_steps_match_jax():
    """bf16 AMP over f32 masters, AdamW (lr 1e-3), the same carried
    weights and ids in both packages.  Losses agree within 1e-3 relative
    (bf16 compute, as the eager test).  The masters: Adam's first step
    moves every element by about lr whatever the gradient's size, so an
    element whose gradient is bf16 noise can move by +lr in one package
    and -lr in the other; three steps can separate it by up to 6 lr.
    Measured: the largest difference 3.8 lr (on the embedding and the
    MLP gate, whose small gradients are bf16 noise in places), the mean
    at most 0.019 lr.  The test holds every element to 6 lr and each
    parameter's mean difference to 0.05 lr."""
    jm, tm = _models()
    ids = _ids(1024, B=1, seed=5)
    mesh = mesh_mod.init_mesh({"dp": 1}, devices=jax.devices()[:1])
    js = JStrategy()
    js.amp = True
    js.amp_configs = {"dtype": "bfloat16"}
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = JStep(jm, lambda a, b: jm(a, labels=b)[0], jopt, js, mesh=mesh)
    ts = DistributedStrategy()
    ts.amp = True
    ts.amp_configs = {"dtype": "bfloat16"}
    topt = AdamW(learning_rate=LR, parameters=tm.parameters())
    tstep = DistributedTrainStep(tm, lambda a, b: tm(a, labels=b)[0], topt,
                                 ts)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))))
        t = torch.from_numpy(ids)
        tl.append(tstep(t, t).item())
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    jw = {k: np.asarray(v._value).astype(np.float32)
          for k, v in jm.state_dict().items()}
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32
        d = np.abs(p.detach().numpy() - jw[n])
        assert d.max() <= 6 * LR, (n, d.max())
        assert d.mean() <= 0.05 * LR, (n, d.mean())
    # three steps x 2 layers: forward + remat recompute, one backward
    assert registry.spec("flash_attention").torch_ref_calls == 12
    assert registry.spec("flash_attention_bwd_dq").torch_ref_calls == 6


def _fp16(s):
    s.amp = True
    s.amp_configs = {"dtype": "float16"}


# the reference's own refusals keep its messages: float16 loss scaling
# with gradient merge, and DGC with either; every feature still to be
# ported names ROADMAP queue item 4
_REFERENCE_REFUSALS = ("gradient_merge", "float16")
# the model axes, ported: a degree above 1 needs that many ranks (this
# world has one), a toggle alone at degree 1 builds the step
_MODEL_AXES = ("pp_degree", "sep_degree", "tensor_parallel", "pipeline",
               "mp_degree")


@pytest.mark.parametrize("setup,match", [
    (lambda s: setattr(s, "hybrid_configs", {"pp_degree": 2}), "pp_degree"),
    (lambda s: setattr(s, "hybrid_configs", {"sep_degree": 2}),
     "sep_degree"),
    (lambda s: setattr(s, "tensor_parallel", True), "tensor_parallel"),
    (lambda s: (_fp16(s), setattr(s, "gradient_merge", True),
                setattr(s, "gradient_merge_configs", {"k_steps": 2})),
     "gradient_merge"),
    (lambda s: setattr(s, "pipeline", True), "pipeline"),
    (lambda s: (_fp16(s), setattr(s, "dgc", True)), "float16"),
    (lambda s: setattr(s, "hybrid_configs", {"mp_degree": 2}), "mp_degree"),
])
def test_refused_strategies_raise(setup, match):
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    s = DistributedStrategy()
    setup(s)
    if match in _MODEL_AXES:
        opt = AdamW(parameters=tm.parameters())
        if max(s.mesh_degrees().values()) > 1:
            with pytest.raises(ValueError, match="need that many ranks"):
                DistributedTrainStep(tm, lambda a: a, opt, s)
        else:
            step = DistributedTrainStep(tm, lambda a: a, opt, s)
            assert step._mesh is None and step._sp == 1
        return
    with pytest.raises(NotImplementedError, match=match) as e:
        DistributedTrainStep(tm, lambda a: a, AdamW(parameters=tm.parameters()),
                             s)
    if match in _REFERENCE_REFUSALS:
        assert "ROADMAP" not in str(e.value)
    else:
        assert "ROADMAP queue item 4" in str(e.value)


@pytest.mark.parametrize("kw,match", [
    (dict(guard_health=True), "guard_health"),
    (dict(mesh=["cuda:0", "cuda:1"]), "2 devices"),
])
def test_refused_step_options_raise(kw, match):
    """A mesh of two devices is still refused; ``guard_health`` runs: the
    step leaves its health vector (finite norm, no bad element, the
    step's loss) on ``last_health``."""
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    if match == "guard_health":
        step = DistributedTrainStep(tm, lambda a: tm(a, labels=a)[0],
                                    AdamW(parameters=tm.parameters()), **kw)
        loss = step(torch.from_numpy(_ids(16, B=1))).item()
        h = step.last_health.numpy()
        assert h.shape == (3,) and np.isfinite(h[0]) and h[0] > 0
        assert h[1] == 0 and h[2] == loss
        return
    with pytest.raises(NotImplementedError, match=match):
        DistributedTrainStep(tm, lambda a: a,
                             AdamW(parameters=tm.parameters()), **kw)


def test_recompute_strategy_gives_the_same_step():
    """strategy.recompute recomputes the whole forward in the backward:
    the same loss and update as without it (f32, no AMP)."""
    def run(recompute):
        _, tm = _models(compute_dtype="float32", remat=False)
        s = DistributedStrategy()
        s.recompute = recompute
        step = DistributedTrainStep(tm, lambda a: tm(a, labels=a)[0],
                                    AdamW(LR, parameters=tm.parameters()), s)
        ids = torch.from_numpy(_ids(64, B=1))
        loss = step(ids).item()
        return loss, tm.lm_head.weight.detach().clone()
    (la, wa), (lb, wb) = run(False), run(True)
    assert la == lb
    torch.testing.assert_close(wa, wb, rtol=0, atol=1e-7)


def test_optimizer_must_hold_model_parameters():
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    stray = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="not part of the model"):
        DistributedTrainStep(tm, lambda a: a, AdamW(parameters=[stray]))
    assert math.isclose(AdamW(parameters=[stray]).get_lr(), 0.001)
    # weight decay (a float is an L2Decay) and a clip are taken
    assert Adam(parameters=[stray], weight_decay=0.1)._weight_decay.coeff \
        == 0.1
    clip = object()
    assert Adam(parameters=[stray], grad_clip=clip)._grad_clip is clip
