"""The port's learning-rate schedules, gradient clips, weight decay, the
optimizer zoo and its wrappers against the JAX reference.

The same numpy parameters and gradients (from a seed) go through both
packages' eager ``step()``.  Tolerances:

- every schedule's lr over 50 steps: 1e-12 relative (both are the same
  Python float arithmetic; measured equal);
- every optimizer of the zoo, with and without a schedule, clip or
  weight decay, and each wrapper, over 3 steps: parameters and state
  within rtol 1e-5 / atol 1e-7 in f32 (the same f32 arithmetic; the sums
  of Lamb and Lars's norms and the clips' norms run in another order);
- the three clips alone: 1e-6 relative.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu import regularizer as jreg

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

RTOL, ATOL = 1e-5, 1e-7


# ---------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------

def _schedules(lr):
    return [
        ("noam", lambda: lr.NoamDecay(d_model=64, warmup_steps=10,
                                      learning_rate=2.0)),
        ("exp", lambda: lr.ExponentialDecay(0.1, gamma=0.9)),
        ("natural_exp", lambda: lr.NaturalExpDecay(0.1, gamma=0.05)),
        ("inverse_time", lambda: lr.InverseTimeDecay(0.1, gamma=0.2)),
        ("poly", lambda: lr.PolynomialDecay(0.1, decay_steps=20,
                                            end_lr=0.001, power=2.0)),
        ("poly_cycle", lambda: lr.PolynomialDecay(0.1, decay_steps=7,
                                                  cycle=True)),
        ("piecewise", lambda: lr.PiecewiseDecay([5, 20, 30],
                                                [0.1, 0.05, 0.01, 0.001])),
        ("warmup", lambda: lr.LinearWarmup(0.1, 10, 0.0, 0.1)),
        ("warmup_cosine", lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(0.1, T_max=30), 8, 0.001, 0.1)),
        ("step", lambda: lr.StepDecay(0.1, step_size=7, gamma=0.5)),
        ("multistep", lambda: lr.MultiStepDecay(0.1, [3, 11, 40])),
        ("lambda", lambda: lr.LambdaDecay(0.1, lambda e: 0.97 ** e)),
        ("multiplicative", lambda: lr.MultiplicativeDecay(
            0.1, lambda e: 0.95 if e % 2 else 0.99)),
        ("cosine", lambda: lr.CosineAnnealingDecay(0.1, T_max=17,
                                                   eta_min=0.002)),
        ("one_cycle", lambda: lr.OneCycleLR(0.1, total_steps=40)),
        ("one_cycle_3", lambda: lr.OneCycleLR(
            0.1, total_steps=40, three_phase=True, anneal_strategy="linear")),
        ("cyclic", lambda: lr.CyclicLR(0.01, 0.1, step_size_up=6,
                                       step_size_down=4)),
        ("cyclic2", lambda: lr.CyclicLR(0.01, 0.1, step_size_up=5,
                                        mode="triangular2")),
        ("cyclic_exp", lambda: lr.CyclicLR(0.01, 0.1, step_size_up=5,
                                           mode="exp_range",
                                           exp_gamma=0.98)),
    ]


@pytest.mark.parametrize("i", range(len(_schedules(tlr))),
                         ids=[n for n, _ in _schedules(tlr)])
def test_schedule_matches_jax_over_50_steps(i):
    (_, make_j), (_, make_t) = _schedules(jlr)[i], _schedules(tlr)[i]
    js, ts = make_j(), make_t()
    jv, tv = [], []
    for _ in range(50):
        jv.append(js())
        tv.append(ts())
        js.step()
        ts.step()
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
    assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau_matches_jax():
    rng = np.random.RandomState(3)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 10),
                              0.5 + 0.01 * rng.rand(30),
                              np.linspace(0.5, 0.2, 10)])
    for mode, kw in (("min", {}), ("max", dict(threshold_mode="abs",
                                               cooldown=2))):
        js = jlr.ReduceOnPlateau(0.1, mode=mode, patience=3, factor=0.5,
                                 **kw)
        ts = tlr.ReduceOnPlateau(0.1, mode=mode, patience=3, factor=0.5,
                                 **kw)
        jv, tv = [], []
        for m in metrics:
            js.step(float(m))
            ts.step(torch.tensor(float(m)))
            jv.append(js())
            tv.append(ts())
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
        assert min(tv) < 0.1


# ---------------------------------------------------------------------
# the optimizer zoo
# ---------------------------------------------------------------------

SHAPES = ((5, 3), (3,), (2, 2, 2))


def _params():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return [rng.randn(*s).astype(np.float32) * (0.5 + step) for s in SHAPES]


def _both(make, steps=3, set_lr=None):
    """``make(pkg, params)`` builds an optimizer of package ``pkg`` (the
    JAX ``paddle`` or the port's modules); both take the same gradients
    for ``steps`` eager steps.  Returns their parameters and states."""
    p0 = _params()
    jps = [jnn.Parameter(paddle.to_tensor(p)._value) for p in p0]
    tps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    jo = make(_J, jps)
    to = make(_T, tps)
    for s in range(steps):
        for jp, tp, g in zip(jps, tps, _grads(s)):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        if set_lr is not None:
            set_lr(jo, to)
    jres = [np.asarray(p._value) for p in jps]
    tres = [p.detach().numpy() for p in tps]
    return jres, tres, jo, to


class _J:
    opt = paddle.optimizer
    lr = jlr
    clip = jclip
    reg = jreg


class _T:
    opt = topt
    lr = tlr
    clip = tclip
    reg = treg


ZOO = {
    "sgd": lambda k, ps: k.opt.SGD(0.1, parameters=ps),
    "momentum": lambda k, ps: k.opt.Momentum(0.05, 0.9, parameters=ps),
    "nesterov": lambda k, ps: k.opt.Momentum(0.05, 0.9, parameters=ps,
                                             use_nesterov=True),
    "adam": lambda k, ps: k.opt.Adam(0.01, parameters=ps),
    "adamw": lambda k, ps: k.opt.AdamW(0.01, parameters=ps,
                                       weight_decay=0.1, lr_ratio=0.5),
    "adamax": lambda k, ps: k.opt.Adamax(0.02, parameters=ps),
    "adagrad": lambda k, ps: k.opt.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "adadelta": lambda k, ps: k.opt.Adadelta(1.0, rho=0.9, parameters=ps),
    "rmsprop": lambda k, ps: k.opt.RMSProp(0.01, parameters=ps),
    "rmsprop_centered": lambda k, ps: k.opt.RMSProp(
        0.01, momentum=0.9, centered=True, parameters=ps),
    "lamb": lambda k, ps: k.opt.Lamb(
        0.01, lamb_weight_decay=0.05, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "lars": lambda k, ps: k.opt.Lars(0.1, parameters=ps,
                                     lars_weight_decay=0.001),
    # weight decay (a float is an L2Decay), L1Decay, a clip, a schedule
    "momentum_l2": lambda k, ps: k.opt.Momentum(
        0.05, 0.9, parameters=ps, weight_decay=0.01),
    "sgd_l1": lambda k, ps: k.opt.SGD(0.1, parameters=ps,
                                      weight_decay=k.reg.L1Decay(0.02)),
    "adam_global_clip": lambda k, ps: k.opt.Adam(
        0.01, parameters=ps, grad_clip=k.clip.ClipGradByGlobalNorm(1.0)),
    "sgd_norm_clip": lambda k, ps: k.opt.SGD(
        0.1, parameters=ps, grad_clip=k.clip.ClipGradByNorm(0.7)),
    "momentum_value_clip": lambda k, ps: k.opt.Momentum(
        0.05, parameters=ps, grad_clip=k.clip.ClipGradByValue(0.8)),
    "adamw_step_decay": lambda k, ps: k.opt.AdamW(
        k.lr.StepDecay(0.01, step_size=1, gamma=0.5), parameters=ps),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_optimizer_matches_jax_over_3_steps(name):
    def sched_step(jo, to):
        for o in (jo, to):
            if not isinstance(o._learning_rate, float):
                o._learning_rate.step()

    jres, tres, jo, to = _both(ZOO[name], set_lr=sched_step)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    for jp, tp in zip(jo._parameter_list, to._parameter_list):
        jst, tst = jo._accumulators[id(jp)], to._accumulators[id(tp)]
        assert sorted(jst) == sorted(tst)
        for k in jst:
            np.testing.assert_allclose(
                np.asarray(tst[k]), np.asarray(jst[k], np.float32),
                rtol=RTOL, atol=ATOL, err_msg=f"{name} state {k}")
    assert to.get_lr() == pytest.approx(jo.get_lr(), rel=1e-12)


def test_optimizer_state_dict_round_trip():
    """``state_dict`` / ``set_state_dict`` (with the scheduler's state):
    a fresh optimizer loaded from it takes the next step bitwise as the
    original does."""
    p0 = _params()
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    qs = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    sa = tlr.StepDecay(0.01, step_size=2, gamma=0.5)
    sb = tlr.StepDecay(0.01, step_size=2, gamma=0.5)
    a = topt.Adam(sa, parameters=ps)
    b = topt.Adam(sb, parameters=qs)
    for s in range(2):
        for p, g in zip(ps, _grads(s)):
            p.grad = torch.from_numpy(g)
        a.step()
        sa.step()
    sd = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in a.state_dict().items()}
    b.set_state_dict(sd)
    with torch.no_grad():
        for p, q in zip(ps, qs):
            q.copy_(p)
    assert b.get_lr() == a.get_lr() and b._global_step == 2
    for o, prm in ((a, ps), (b, qs)):
        for p, g in zip(prm, _grads(2)):
            p.grad = torch.from_numpy(g)
        o.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        a.set_lr(0.1)


def test_parameter_regularizer_and_lr_multiplier():
    """A parameter's own ``regularizer`` overrides the optimizer's weight
    decay, and ``optimize_attr["learning_rate"]`` scales its lr, as in
    the reference."""
    def make(k, ps):
        ps[0].regularizer = k.reg.L1Decay(0.5)
        ps[1].optimize_attr = {"learning_rate": 0.25}
        return k.opt.SGD(0.1, parameters=ps, weight_decay=0.01)
    jres, tres, _, _ = _both(make)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------
# clips and the regularizers alone
# ---------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda c: c.ClipGradByValue(0.5),
    lambda c: c.ClipGradByValue(0.3, min=-0.1),
    lambda c: c.ClipGradByNorm(1.0),
    lambda c: c.ClipGradByGlobalNorm(1.0),
    lambda c: c.ClipGradByGlobalNorm(100.0),
], ids=["value", "value_min", "norm", "global", "global_no_op"])
def test_clip_matches_jax(make):
    gs = _grads(2)
    jout = make(jclip).apply_values([jnp.asarray(g) for g in gs])
    tout = make(tclip).apply_values([torch.from_numpy(g) for g in gs])
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    pairs = make(tclip)([(None, torch.from_numpy(g)) for g in gs])
    for (_, t), j in zip(pairs, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def test_global_norm_clip_no_nan_contagion():
    """One non-finite gradient makes the global norm non-finite; the clip
    then scales nothing, so the healthy gradients stay finite (the
    reference's rule)."""
    gs = _grads(1)
    gs[0][0, 0] = np.nan
    gs[1][1] = np.inf
    out = tclip.ClipGradByGlobalNorm(1.0).apply_values(
        [torch.from_numpy(g) for g in gs])
    assert torch.equal(out[2], torch.from_numpy(gs[2]))
    assert bool(torch.isfinite(out[0][1:]).all())
    jout = jclip.ClipGradByGlobalNorm(1.0).apply_values(
        [jnp.asarray(g) for g in gs])
    for j, t in zip(jout, out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
def test_regularizer_matches_jax(kind):
    p, g = _params()[0], _grads(0)[0]
    p[0, 0] = 0.0                              # sign(0) is 0
    j = getattr(jreg, kind)(0.03).apply_gradient(jnp.asarray(p),
                                                 jnp.asarray(g))
    t = getattr(treg, kind)(0.03).apply_gradient(torch.from_numpy(p),
                                                 torch.from_numpy(g))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7,
                               atol=0)


# ---------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------

def test_lookahead_matches_jax():
    def make(k, ps):
        return k.opt.LookaheadOptimizer(k.opt.SGD(0.1, parameters=ps),
                                        alpha=0.5, k=2)
    jres, tres, jo, to = _both(make, steps=5)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    for js, ts in zip(jo._slow, to._slow):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                                   atol=ATOL)
    assert to.get_lr() == pytest.approx(0.1)


def test_model_average_matches_jax():
    def make(k, ps):
        inner = k.opt.Momentum(0.05, 0.9, parameters=ps)
        avg = k.opt.ModelAverage(0.5, parameters=ps, min_average_window=2,
                                 max_average_window=4)

        class Both:
            _parameter_list = inner._parameter_list

            def step(self):
                inner.step()
                avg.step()

            def clear_grad(self):
                inner.clear_grad()

        b = Both()
        b.avg = avg
        return b
    jres, tres, jo, to = _both(make, steps=3)
    with jo.avg.apply(), to.avg.apply():
        javg = [np.asarray(p._value) for p in jo._parameter_list]
        tavg = [p.detach().numpy().copy() for p in to._parameter_list]
    for j, t in zip(javg, tavg):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    # restored after the with
    for j, t in zip(jres, [p.detach().numpy() for p in to._parameter_list]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert not np.allclose(tavg[0], tres[0])
    assert math.isclose(to.avg._denom, jo.avg._denom, rel_tol=1e-12)
