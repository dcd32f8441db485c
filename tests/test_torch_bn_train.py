"""The ResNet training slice's modules against the JAX reference: batch
norm with batch statistics, ``BatchNorm2D`` in training, ``cross_entropy``,
``Momentum`` and the running statistics under ``strategy.recompute``.

The same numpy inputs, made from a seed, go to both packages; the
reference's gradients come from ``jax.vjp`` (batch norm) or its eager
tape (cross entropy).  Tolerances, each with its reason at the test.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.vision.models import resnet18 as jresnet18

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.framework.io import (load_jax_state_dict,
                                           state_arrays)
from paddle_tpu_torch.nn import BatchNorm2D
from paddle_tpu_torch.nn.functional import (batch_norm, cross_entropy,
                                            softmax_with_cross_entropy)
from paddle_tpu_torch.nn.functional.common import BatchNormTrain, _moments
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet18, resnet50

jcommon = importlib.import_module("paddle_tpu.nn.functional.common")
jopts = importlib.import_module("paddle_tpu.optimizer.optimizers")

BF16 = jnp.bfloat16


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _jnp32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bn_inputs(fmt, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    shape = (4, 6, 5, 3) if fmt == "NCHW" else (4, 5, 3, 6)
    x = (rng.standard_normal(shape) * 2.0 + mean).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    gm = rng.standard_normal(6).astype(np.float32)
    gv = rng.standard_normal(6).astype(np.float32)
    rm = rng.normal(0, 1, 6).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    return x, w, b, g, gm, gv, rm, rv


def _round_bf16(a):
    return np.asarray(jnp.asarray(a, BF16).astype(jnp.float32))


# f32: the same f32 arithmetic in another order (1e-5 of the values'
# scale, measured ~1e-6); bf16: the outputs are rounded to bf16 once, so
# one bf16 step (2^-7 relative) plus the f32 order term
_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2.0 ** -7, atol=2e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_training_matches_jax(fmt, dtype):
    """Forward output, batch mean and variance, dx / dw / db under
    cotangents on all three outputs (``jax.vjp`` of the reference's
    ``_norm_train``), and the running statistics after the call."""
    x, w, b, g, gm, gv, rm, rv = _bn_inputs(fmt, 5)
    jdt = BF16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if dtype == "bfloat16":
        x, w, b, g = (_round_bf16(a) for a in (x, w, b, g))
    red = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
    outs, vjp = jax.vjp(
        lambda v, ww, bb: jcommon._norm_train(v, ww, bb, red, 1e-5),
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    jdx, jdw, jdb = vjp((jnp.asarray(g, jdt), jnp.asarray(gm),
                         jnp.asarray(gv)))
    tx, tw, tb = (_t(a, tdt).requires_grad_() for a in (x, w, b))
    out, m, var = BatchNormTrain.apply(tx, tw, tb, red, 1e-5)
    assert out.dtype == tdt and m.dtype == var.dtype == torch.float32
    dx, dw, db = torch.autograd.grad((out, m, var), (tx, tw, tb),
                                     (_t(g, tdt), _t(gm), _t(gv)))
    assert dx.dtype == dw.dtype == db.dtype == tdt
    tol = _TOL[dtype]
    for got, want in ((out, outs[0]), (m, outs[1]), (var, outs[2]),
                      (dx, jdx), (dw, jdw), (db, jdb)):
        np.testing.assert_allclose(_np(got), _jnp32(want), **tol)
    # the functional: output and the running statistics' update
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    jout = JF.batch_norm(paddle.to_tensor(jnp.asarray(x, jdt)), jrm, jrv,
                         paddle.to_tensor(jnp.asarray(w, jdt)),
                         paddle.to_tensor(jnp.asarray(b, jdt)),
                         training=True, momentum=0.9, data_format=fmt)
    trm, trv = _t(rm), _t(rv)
    tout = batch_norm(_t(x, tdt), trm, trv, _t(w, tdt), _t(b, tdt),
                      training=True, momentum=0.9, data_format=fmt)
    np.testing.assert_allclose(_np(tout), _jnp32(jout._value), **tol)
    assert trm.dtype == trv.dtype == torch.float32
    # momentum * running + 0.1 * batch: f32 either way
    np.testing.assert_allclose(trm.numpy(), _jnp32(jrm._value), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(trv.numpy(), _jnp32(jrv._value), rtol=1e-6,
                               atol=1e-6)


def test_batch_norm_two_pass_moments_on_uncentred_input():
    """A mean of 1e3 over unit variance: the one-pass E[x^2] - m^2 form
    loses the variance in f32, the two-pass moments keep it; the port
    matches the reference and an f64 truth."""
    x, w, b, _, _, _, rm, rv = _bn_inputs("NCHW", 7, mean=1e3)
    red = (0, 2, 3)
    xf = _t(x)
    m1 = xf.mean(dim=red)
    one_pass = (xf * xf).mean(dim=red) - m1 * m1
    true_var = x.astype(np.float64).var(axis=red)
    assert np.abs(one_pass.numpy() - true_var).max() > 0.05 * true_var.min()
    m, var, n = _moments(xf, red)
    assert n == 4 * 5 * 3
    np.testing.assert_allclose(var.numpy(), true_var, rtol=1e-4)
    out = batch_norm(xf, _t(rm), _t(rv), _t(w), _t(b), training=True)
    jout = JF.batch_norm(paddle.to_tensor(x), paddle.to_tensor(rm),
                         paddle.to_tensor(rv), paddle.to_tensor(w),
                         paddle.to_tensor(b), training=True)
    x64 = x.astype(np.float64)
    want = ((x64 - x64.mean(axis=red, keepdims=True))
            / np.sqrt(true_var.reshape(1, 6, 1, 1) + 1e-5)
            * w.reshape(1, 6, 1, 1) + b.reshape(1, 6, 1, 1))
    # an f32 x of 1e3 carries 6e-5 of absolute rounding: 1e-3 of the
    # normalised output's scale, in both packages
    np.testing.assert_allclose(out.numpy(), want, atol=1e-3)
    np.testing.assert_allclose(out.numpy(), _jnp32(jout._value), atol=1e-3)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_layer_train_then_eval(fmt):
    """``BatchNorm2D.train()`` end to end: two training calls move the
    running statistics as the reference's layer does, then eval applies
    them; tolerance as the f32 functional test."""
    rng = np.random.default_rng(9)
    jb = jnn.BatchNorm2D(6, data_format=fmt)
    tb = BatchNorm2D(6, data_format=fmt, device="cpu")
    arrays = {"weight": rng.uniform(0.5, 2, 6), "bias": rng.normal(0, 1, 6),
              "_mean": np.zeros(6), "_variance": np.ones(6)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    for k, v in arrays.items():
        getattr(jb, k)._value = jnp.asarray(v)
    load_jax_state_dict(tb, arrays)
    jb.train()
    tb.train()
    shape = (3, 6, 4, 4) if fmt == "NCHW" else (3, 4, 4, 6)
    for _ in range(2):
        x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
        np.testing.assert_allclose(_np(tb(_t(x))),
                                   _jnp32(jb(paddle.to_tensor(x))._value),
                                   rtol=1e-5, atol=1e-5)
    for k in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   _jnp32(getattr(jb, k)._value), rtol=1e-6,
                                   atol=1e-6)
    jb.eval()
    tb.eval()
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(_np(tb(_t(x))),
                               _jnp32(jb(paddle.to_tensor(x))._value),
                               rtol=1e-5, atol=1e-5)


_CE_CASES = {
    "mean": dict(), "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "weight_mean": dict(weight=True), "weight_sum": dict(weight=True,
                                                         reduction="sum"),
    "weight_none": dict(weight=True, reduction="none"),
    "ignore_mean": dict(ignore=True), "ignore_weight_mean": dict(
        ignore=True, weight=True),
    "ignore_none": dict(ignore=True, reduction="none"),
    "label_keeps_axis": dict(keep_axis=True),
    "soft_mean": dict(soft_label=True), "soft_none": dict(
        soft_label=True, reduction="none"),
    "axis1": dict(axis=1), "axis1_ignore": dict(axis=1, ignore=True),
    "no_softmax": dict(use_softmax=False),
    "custom_ignore_index": dict(ignore=True, ignore_index=2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CE_CASES))
def test_cross_entropy_matches_jax(case, dtype):
    """Loss and its input gradient over the reference's options.  f32:
    1e-5 (the same log-softmax in another order); bf16 logits: the loss
    and gradient are bf16, so 2^-6 relative (a rounding in each of two
    passes) and 2e-2 absolute on gradients of order 1."""
    kw = dict(_CE_CASES[case])
    rng = np.random.default_rng(sorted(_CE_CASES).index(case))
    axis = kw.get("axis", -1)
    shape = (6, 5, 3) if axis == 1 else (6, 5)
    C = 5
    x = rng.standard_normal(shape).astype(np.float32) * 2
    if kw.pop("use_softmax", True) is False:
        x = np.abs(x) / np.abs(x).sum(axis=axis, keepdims=True)
        kw["use_softmax"] = False
    lab_shape = (6, 3) if axis == 1 else (6,)
    if kw.get("soft_label"):
        lab = rng.uniform(0, 1, shape).astype(np.float32)
        lab /= lab.sum(axis=axis, keepdims=True)
    else:
        lab = rng.integers(0, C, lab_shape).astype(np.int64)
        ign = kw.pop("ignore_index", -100)
        if kw.pop("ignore", False):
            lab.reshape(-1)[[1, 4]] = ign
            kw["ignore_index"] = ign
        if kw.pop("keep_axis", False):
            lab = lab[:, None]
    if kw.pop("weight", False):
        kw["weight"] = rng.uniform(0.2, 2.0, C).astype(np.float32)
    kw.setdefault("axis", axis)
    jdt = "bfloat16" if dtype == "bfloat16" else "float32"
    if dtype == "bfloat16":
        x = _round_bf16(x)
    jx = paddle.to_tensor(x, dtype=jdt, stop_gradient=False)
    jkw = dict(kw)
    if "weight" in jkw:
        jkw["weight"] = paddle.to_tensor(jkw["weight"])
    jl = JF.cross_entropy(jx, paddle.to_tensor(lab), **jkw)
    cot = rng.standard_normal(np.shape(jl._value)).astype(np.float32)
    jl.backward(paddle.to_tensor(cot, dtype=str(jl._value.dtype)))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = _t(x, tdt).requires_grad_()
    tkw = dict(kw)
    if "weight" in tkw:
        tkw["weight"] = _t(tkw["weight"])
    tl = cross_entropy(tx, _t(lab, torch.float32 if kw.get("soft_label")
                              else torch.int64), **tkw)
    assert str(tl.dtype).split(".")[-1] == str(jl._value.dtype)
    (gx,) = torch.autograd.grad(tl, tx, _t(cot, tl.dtype))
    if dtype == "float32":
        tol_l, tol_g = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-5,
                                                        atol=1e-6)
    else:
        tol_l, tol_g = dict(rtol=2.0 ** -6, atol=1e-3), dict(rtol=2.0 ** -6,
                                                             atol=2e-2)
    np.testing.assert_allclose(_np(tl), _jnp32(jl._value), **tol_l)
    np.testing.assert_allclose(_np(gx), _jnp32(jx.grad._value), **tol_g)


def test_softmax_with_cross_entropy_keeps_the_axis():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    lab = rng.integers(0, 7, (4, 1)).astype(np.int64)
    jl, js = JF.softmax_with_cross_entropy(paddle.to_tensor(x),
                                           paddle.to_tensor(lab),
                                           return_softmax=True)
    tl, ts = softmax_with_cross_entropy(_t(x), _t(lab, torch.int64),
                                        return_softmax=True)
    assert tuple(tl.shape) == (4, 1)
    np.testing.assert_allclose(tl.numpy(), _jnp32(jl._value), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), _jnp32(js._value), rtol=1e-6)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_momentum_update_matches_jax(nesterov, dtype):
    """Five steps of the update rule, at two learning rates, bitwise
    equal to the reference's ``_update`` run eagerly (one rounding per
    operation, the same constants rounded to the parameter's dtype)."""
    rng = np.random.default_rng(11)
    jdt = BF16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    jp = jnp.asarray(p0, jdt)
    tp = _t(p0).to(tdt)
    jm = jopts.Momentum(learning_rate=0.1, momentum=0.9,
                        use_nesterov=nesterov,
                        parameters=[paddle.to_tensor(jp)])
    tm = Momentum(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
                  parameters=[tp])
    jst = {"velocity": jnp.zeros_like(jp)}
    tst = tm._create_state(tp)
    for i in range(5):
        lr = 0.1 if i < 3 else 0.01
        g = rng.standard_normal((7, 5)).astype(np.float32)
        jp, jst = jm._update(jp, jnp.asarray(g), jnp.asarray(lr,
                                                             jnp.float32),
                             jst)
        (tp,), (tst,) = tm.functional_update([tp], [_t(g)], [tst], lr)
        assert tp.dtype == tst["velocity"].dtype == tdt
        assert np.array_equal(_np(tp), _jnp32(jp)), i
        assert np.array_equal(_np(tst["velocity"]),
                              _jnp32(jst["velocity"])), i


def _jax_small_net():
    paddle.seed(3)
    return jresnet18(num_classes=10)


def test_recompute_moves_running_stats_once():
    """One step with ``strategy.recompute`` against one without, from the
    same weights: buffers, parameters and losses bitwise equal (the
    recomputed forward must not move the statistics a second time), and
    the buffers as the JAX step with recompute moves them (f32 forward
    in another order: 1e-4 of each buffer's scale, measured ~1e-6).
    ResNet-18 at batch 4, 32x32 keeps the JAX compile short."""
    jm = _jax_small_net()
    arrays = {k: np.asarray(v._value).astype(np.float32)
              for k, v in jm.state_dict().items()}
    rng = np.random.RandomState(0)
    img = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    lab = rng.randint(0, 10, (4,)).astype(np.int64)
    losses, states = [], []
    for rc in (False, True):
        tm = resnet18(num_classes=10, device="cpu")
        load_jax_state_dict(tm, arrays)
        s = DistributedStrategy()
        s.recompute = rc
        opt = Momentum(0.01, 0.9, parameters=list(tm.parameters()))
        step = DistributedTrainStep(
            tm, lambda a, b, m=tm: cross_entropy(m(a), b).mean(), opt, s)
        losses.append(step(_t(img), _t(lab, torch.int64)))
        states.append(state_arrays(tm))
    assert torch.equal(losses[0], losses[1])
    for k in states[0]:
        assert np.array_equal(states[0][k], states[1][k]), k
    js = JStrategy()
    js.recompute = True
    jopt = paddle.optimizer.Momentum(0.01, 0.9, parameters=jm.parameters())
    mesh = mesh_mod.init_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = JStep(jm, lambda a, b: JF.cross_entropy(jm(a), b).mean(), jopt,
                  js, mesh=mesh)
    jl = jstep(paddle.to_tensor(img), paddle.to_tensor(lab))
    np.testing.assert_allclose(float(losses[1]), float(jl._value),
                               rtol=1e-4)
    for k, v in jm.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            want = _jnp32(v._value)
            np.testing.assert_allclose(
                states[1][k], want, rtol=1e-4,
                atol=1e-4 * np.abs(want).max(), err_msg=k)
            assert not np.array_equal(want, arrays[k]), k


def test_resnet_defaults_to_the_card():
    """No ``device``: the model is built on ``cuda``, which raises
    without a card; ``device="cpu"`` trains."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet50()
    assert pt.optimizer.Momentum is Momentum
    assert pt.nn.functional.cross_entropy is cross_entropy
