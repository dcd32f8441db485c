"""The port's AMP (``auto_cast``, ``GradScaler``), the train step's
float16 loss scaling, gradient merge and ``guard_health``, ``TrainGuard``
and the numeric chaos kinds against the JAX reference.

A small regression net (4 -> 8 tanh -> 1, the reference's guard tests'
net) starts from the JAX model's weights in both packages, and the same
seeded numpy batches go through both.  Tolerances:

- ``GradScaler`` over a planted overflow sequence: the scales equal
  (Python floats on both sides), skipped steps bitwise unchanged, the
  parameters within rtol 1e-6 (f32 SGD);
- the float16 step's scaling state ``(scale, good, bad)`` equal at every
  step, an overflow step's parameters and AdamW state bitwise those
  before it; its losses and parameters within rtol 2e-3 of the JAX step
  (float16 forward and backward in both, rounded at other points);
- ``fused_health``: the count exact, the norm within rtol 1e-6 (f32 sums
  in another order), the loss exact; ``TrainGuard``'s verdicts and
  events equal;
- gradient merge with k = 2: within rtol 1e-5 of one step on the whole
  batch (f32; the mean of the halves' gradients is the whole batch's up
  to summation order) and of the JAX merge step.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu import train_guard as jguard
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.distributed.fleet import chaos as jchaos
from paddle_tpu.framework.core import Tensor as JTensor

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import train_guard as tguard
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep, chaos)
from paddle_tpu_torch.framework.monitor import stat_get
from paddle_tpu_torch.optimizer import SGD, AdamW

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    chaos.uninstall()
    jchaos.uninstall()
    mesh_mod.set_mesh(None)
    yield
    chaos.uninstall()
    jchaos.uninstall()
    mesh_mod.set_mesh(None)


def _nets():
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 1))
    tnet = torch.nn.Sequential(tnn.Linear(4, 8, device="cpu"), tnn.Tanh(),
                               tnn.Linear(8, 1, device="cpu"))
    with torch.no_grad():
        for k, v in jnet.state_dict().items():
            tnet.state_dict()[k].copy_(torch.from_numpy(
                np.asarray(v._value).copy()))
    return jnet, tnet


def _batch(step, n=16, scale=1.0):
    rng = np.random.default_rng(1000 + step)
    x = rng.normal(size=(n, 4)).astype(np.float32) * scale
    return x, x.sum(1, keepdims=True).astype(np.float32) / 4


def _tmse(a, b):
    return torch.mean((a - b) ** 2)


def _weights(net):
    if isinstance(net, torch.nn.Module):
        return {k: v.detach().numpy().copy()
                for k, v in net.state_dict().items()}
    return {k: np.asarray(v._value) for k, v in net.state_dict().items()}


def _jmesh():
    return mesh_mod.init_mesh({"dp": 1}, devices=jax.devices()[:1])


# ---------------------------------------------------------------------
# auto_cast and decorate
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_auto_cast_casts_the_white_list_like_jax(dtype):
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5).astype(np.float32)
    w = rng.randn(5, 4).astype(np.float32)
    with jamp.auto_cast(dtype=dtype):
        j = JF.linear(paddle.to_tensor(x), paddle.to_tensor(w))
    with tamp.auto_cast(dtype=dtype):
        t = TF.linear(torch.from_numpy(x), torch.from_numpy(w))
        # a black-listed name and another dtype are left alone
        assert tamp.maybe_cast_inputs("softmax", t.float())[0].dtype == \
            torch.float32
        assert tamp.maybe_cast_inputs("linear", torch.ones(2,
                                      dtype=torch.int64))[0].dtype == \
            torch.int64
    assert str(t.dtype) == f"torch.{dtype}"
    assert str(np.asarray(j._value).dtype) == dtype
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j._value).astype(np.float32))
    # outside the context nothing is cast
    assert TF.linear(torch.from_numpy(x), torch.from_numpy(w)).dtype == \
        torch.float32
    assert tamp.amp_state() is None


def test_auto_cast_conv2d_and_decorate():
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.RandomState(1)
    x = rng.randn(1, 2, 5, 5).astype(np.float32)
    w = rng.randn(3, 2, 3, 3).astype(np.float32)
    with jamp.auto_cast(dtype="float16"):
        j = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=1)
    with tamp.auto_cast(dtype="float16"):
        t = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert t.dtype == torch.float16
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j._value).astype(np.float32),
                               rtol=2e-3, atol=2e-3)
    _, tnet = _nets()
    assert tamp.decorate(tnet, level="O1") is tnet
    m, o = tamp.decorate(tnet, optimizers="opt", level="O2",
                         dtype="bfloat16")
    assert o == "opt" and all(p.dtype == torch.bfloat16
                              for p in m.parameters())


# ---------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------

def test_grad_scaler_matches_jax_over_planted_overflows():
    """Scaled gradients with an overflow at steps 2, 3 and 6: the scale
    grows after 2 finite steps and shrinks after 2 bad ones, overflow
    steps are skipped bitwise, and both packages agree step by step."""
    jnet, tnet = _nets()
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jo = paddle.optimizer.SGD(0.05, parameters=jnet.parameters())
    to = SGD(0.05, parameters=list(tnet.parameters()))
    scales = []
    for step in range(8):
        bad = step in (2, 3, 6)
        x, y = _batch(step)
        jl = JF.mse_loss(jnet(paddle.to_tensor(x)), paddle.to_tensor(y))
        js.scale(jl).backward()
        tl = _tmse(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        ts.scale(tl).backward()
        if bad:
            jp = jo._parameter_list[0]
            g = np.asarray(jp.grad._value).copy()
            g[0, 0] = np.inf
            jp.grad = paddle.to_tensor(g)
            tnet[0].weight.grad[0, 0] = float("inf")
        before = _weights(tnet)
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        scales.append(ts.get_loss_scaling())
        after = _weights(tnet)
        if bad:
            assert all(np.array_equal(before[k], after[k]) for k in after)
        jw = _weights(jnet)
        for k in after:
            np.testing.assert_allclose(after[k], jw[k], rtol=1e-6,
                                       atol=1e-7)
    assert scales == [1024.0, 2048.0, 2048.0, 1024.0, 1024.0, 2048.0,
                      2048.0, 2048.0]
    assert ts.state_dict() == js.state_dict()


def test_grad_scaler_growth_capped_and_one_fetch():
    ts = tamp.GradScaler(init_loss_scaling=2.0 ** 31, incr_every_n_steps=1)
    for _ in range(5):
        ts._found_inf = False
        ts.update()
    assert ts.get_loss_scaling() == 2.0 ** 32
    _, tnet = _nets()
    opt = SGD(0.01, parameters=list(tnet.parameters()))
    x, y = _batch(0)
    ts2 = tamp.GradScaler(init_loss_scaling=8.0)
    ts2.scale(_tmse(tnet(torch.from_numpy(x)),
                    torch.from_numpy(y))).backward()
    n0 = tguard.host_sync_count()
    ts2.unscale_(opt)
    ts2.unscale_(opt)                  # once a step
    assert tguard.host_sync_count() - n0 == 1
    assert not ts2._found_inf


# ---------------------------------------------------------------------
# the train step: float16 scaling, guard_health, gradient merge
# ---------------------------------------------------------------------

def _fp16_strategy(pkg, dynamic=True):
    s = pkg()
    s.amp = True
    s.amp_configs = {"dtype": "float16", "init_loss_scaling": 2.0 ** 10,
                     "incr_every_n_steps": 2, "decr_every_n_nan_or_inf": 2,
                     "use_dynamic_loss_scaling": dynamic}
    return s


@pytest.mark.parametrize("dynamic", [True, False])
def test_fp16_step_scaling_state_machine_matches_jax(dynamic):
    """Batches scaled by 1,000 overflow float16 at steps 2, 3 and 6."""
    jnet, tnet = _nets()
    mesh = _jmesh()
    jo = paddle.optimizer.AdamW(0.01, parameters=jnet.parameters())
    to = AdamW(0.01, parameters=list(tnet.parameters()))
    jstep = JStep(jnet, lambda x, y: JF.mse_loss(jnet(x), y), jo,
                  _fp16_strategy(JStrategy, dynamic), mesh=mesh,
                  guard_health=True)
    tstep = DistributedTrainStep(tnet, lambda x, y: _tmse(tnet(x), y), to,
                                 _fp16_strategy(DistributedStrategy,
                                                dynamic),
                                 guard_health=True)
    states = []
    for step in range(8):
        bad = step in (2, 3, 6)
        x, y = _batch(step, scale=1000.0 if bad else 1.0)
        before = _weights(tnet)
        sbefore = [{k: v.clone() for k, v in s.items()}
                   for s in to.opt_state()]
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y)).item()
        js = tuple(np.asarray(v).item() for v in jstep._amp_state)
        tst = tuple(v.item() for v in tstep.amp_state)
        assert tst == js, (step, tst, js)
        states.append(tst)
        th, jh = tstep.last_health.numpy(), np.asarray(jstep.last_health)
        assert (th[1] == 0) == (jh[1] == 0) == (not bad)
        after = _weights(tnet)
        if bad:
            assert not np.isfinite(tl) and not np.isfinite(jl)
            assert all(np.array_equal(before[k], after[k]) for k in after)
            for s0, s1 in zip(sbefore, to.opt_state()):
                assert all(torch.equal(s0[k], s1[k]) for k in s0)
        else:
            np.testing.assert_allclose(tl, jl, rtol=2e-3)
            np.testing.assert_allclose(th, jh, rtol=2e-3)
        jw = _weights(jnet)
        for k in after:
            np.testing.assert_allclose(after[k], jw[k], rtol=2e-3,
                                       atol=1e-4)
    scales = [s[0] for s in states]
    if dynamic:
        assert scales == [1024.0, 2048.0, 2048.0, 1024.0, 1024.0, 2048.0,
                          2048.0, 2048.0]
    else:
        assert scales == [1024.0] * 8


def test_fp16_refusals_keep_the_reference_messages():
    _, tnet = _nets()
    s = _fp16_strategy(DistributedStrategy)
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2}
    with pytest.raises(NotImplementedError, match="gradient_merge"):
        DistributedTrainStep(tnet, _tmse, SGD(0.1, parameters=list(
            tnet.parameters())), s)
    s2 = DistributedStrategy()
    s2.hybrid_configs = {"pp_degree": 2}
    # pp is ported: a degree of 2 needs two ranks, which this world lacks
    with pytest.raises(ValueError, match="need that many ranks"):
        DistributedTrainStep(tnet, _tmse, SGD(0.1, parameters=list(
            tnet.parameters())), s2)


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_k2_equals_the_big_batch_and_jax(avg):
    """Two half batches through a k = 2 merge against one step on the
    whole batch (``avg``: the mean of the halves' gradients; without it
    their sum, which a whole-batch loss doubled gives), and against the
    JAX merge step; the health vector folds over the window."""
    jnet, tnet = _nets()
    _, tbig = _nets()
    mesh = _jmesh()
    s = DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2, "avg": avg}
    js = JStrategy()
    js.gradient_merge = True
    js.gradient_merge_configs = {"k_steps": 2, "avg": avg}
    tstep = DistributedTrainStep(
        tnet, lambda x, y: _tmse(tnet(x), y),
        AdamW(0.01, parameters=list(tnet.parameters())), s,
        guard_health=True)
    jstep = JStep(jnet, lambda x, y: JF.mse_loss(jnet(x), y),
                  paddle.optimizer.AdamW(0.01, parameters=jnet.parameters()),
                  js, mesh=mesh, guard_health=True)
    k = 1.0 if avg else 2.0
    big = DistributedTrainStep(
        tbig, lambda x, y: k * _tmse(tbig(x), y),
        AdamW(0.01, parameters=list(tbig.parameters())))
    for window in range(3):
        x, y = _batch(window, n=16)
        norms = []
        for half in (slice(0, 8), slice(8, 16)):
            before = _weights(tnet)
            tstep(torch.from_numpy(x[half]), torch.from_numpy(y[half]))
            jstep(paddle.to_tensor(x[half]), paddle.to_tensor(y[half]))
            norms.append(tstep.last_health[0].item())
            np.testing.assert_allclose(
                tstep.last_health.numpy(), np.asarray(jstep.last_health),
                rtol=1e-5)
            if half.start == 0:        # the first half applies nothing
                after = _weights(tnet)
                assert all(np.array_equal(before[k_], after[k_])
                           for k_ in after)
        assert norms[1] != norms[0]
        big(torch.from_numpy(x), torch.from_numpy(y))
        tw, bw, jw = _weights(tnet), _weights(tbig), _weights(jnet)
        for name in tw:
            np.testing.assert_allclose(tw[name], bw[name], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(tw[name], jw[name], rtol=1e-5,
                                       atol=1e-7)
        assert all(not a.any() for a in tstep._accum)


# ---------------------------------------------------------------------
# fused health and TrainGuard
# ---------------------------------------------------------------------

@pytest.mark.parametrize("precise", [True, False])
def test_fused_health_matches_jax(precise):
    rng = np.random.RandomState(4)
    gs = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    for poison in (False, True):
        if poison:
            gs[0][1, 1] = np.nan
            gs[1][:2] = [np.inf, -np.inf]
        j = np.asarray(jguard.fused_health([jnp.asarray(g) for g in gs],
                                           loss=jnp.float32(2.5),
                                           precise=precise))
        t = tguard.fused_health([torch.from_numpy(g) for g in gs],
                                loss=torch.tensor(2.5),
                                precise=precise).numpy()
        assert t[1] == j[1] and t[2] == j[2] == 2.5
        if np.isfinite(j[0]):
            np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
        else:
            assert not np.isfinite(t[0])
    assert t[1] == (3 if precise else 1)


def test_health_check_is_one_fetch():
    _, tnet = _nets()
    opt = SGD(0.1, parameters=list(tnet.parameters()))
    x, y = _batch(0)
    loss = _tmse(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    n0 = tguard.host_sync_count()
    h = tguard.health_check(opt, loss=loss)
    assert tguard.host_sync_count() == n0
    assert h.ok and h.nonfinite_count == 0 and h.loss == loss.item()
    want = np.sqrt(sum(float((p.grad.numpy() ** 2).sum())
                       for p in tnet.parameters()))
    assert np.isclose(h.global_norm, want, rtol=1e-5)
    assert tguard.host_sync_count() == n0 + 1


def test_train_guard_verdicts_match_jax():
    """A loss sequence with a spike, a NaN loss and three bad steps in a
    row (no rewind target: every bad step is a skip)."""
    losses = [1.0, 0.98, 0.97, 0.99, 0.96, 0.95, 5.0, 0.94, float("nan"),
              0.93, 9.0, 9.5, float("inf"), 0.92]
    jg = jguard.TrainGuard(min_history=4, spike_factor=8.0)
    tg = tguard.TrainGuard(min_history=4, spike_factor=8.0)
    jv, tv = [], []
    for i, lv in enumerate(losses):
        h = np.array([1.0, 0.0, lv], np.float32)
        jv.append(jg.check(jnp.asarray(h), step=i))
        tv.append(tg.check(torch.from_numpy(h), step=i))
    assert tv == jv
    assert tv.count("skip") == 5
    assert [e["reason"] for e in tg.events] == [e["reason"]
                                                for e in jg.events]


def test_nan_grad_chaos_skips_exactly_once_and_leaves_state_bitwise():
    chaos.install(chaos.plan_from_spec("nan:grad:step=4"))
    _, tnet = _nets()
    opt = AdamW(0.01, parameters=list(tnet.parameters()))
    guard = tguard.TrainGuard(optimizer=opt)
    n0 = tguard.host_sync_count()
    verdicts = []
    for step in range(8):
        x, y = _batch(step)
        _tmse(tnet(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        before = _weights(tnet)
        sbefore = [{k: v.clone() for k, v in s.items()}
                   for s in opt.opt_state()]
        verdicts.append(guard.step(step=step))
        if verdicts[-1] == "skip":
            after = _weights(tnet)
            assert all(np.array_equal(before[k], after[k]) for k in after)
            for s0, s1 in zip(sbefore, opt.opt_state()):
                assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert verdicts == ["ok"] * 3 + ["skip"] + ["ok"] * 4
    assert guard.skips == 1 and stat_get("guard_skips") >= 1
    assert opt._skipped_steps == 1 and opt._global_step == 7
    assert tguard.host_sync_count() - n0 == 8
    assert chaos.active().stats_dict() == {"nan:grad": 1}


def test_rewind_restores_the_pinned_checkpoint(tmp_path):
    """Three bad steps in a row rewind to the last healthy pinned step;
    the restored parameters are the ones saved there, and a spent budget
    raises NumericalDivergence."""
    _, tnet = _nets()
    opt = SGD(0.1, parameters=list(tnet.parameters()))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    saved = {}

    def state_fn():
        saved[len(saved)] = _weights(tnet)
        return {"model": {k: v.detach().clone()
                          for k, v in tnet.state_dict().items()}}

    def restore_fn(state):
        with torch.no_grad():
            for k, v in tnet.state_dict().items():
                v.copy_(torch.as_tensor(np.asarray(state["model"][k])))

    guard = tguard.TrainGuard(optimizer=opt, manager=mgr,
                              state_fn=state_fn, restore_fn=restore_fn,
                              rewind_budget=1)
    for step in range(3):
        x, y = _batch(step)
        _tmse(tnet(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        assert guard.step(step=step) == "ok"
    assert mgr.pinned_steps() == [2]
    verdicts = []
    for step in range(3, 6):
        x, y = _batch(step, scale=np.nan)
        _tmse(tnet(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        verdicts.append(guard.step(step=step))
    assert verdicts == ["skip", "skip", "rewind"]
    now = _weights(tnet)
    assert all(np.array_equal(now[k], saved[2][k]) for k in now)
    for step in range(6, 9):
        x, y = _batch(step, scale=np.nan)
        _tmse(tnet(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        if step < 8:
            guard.step(step=step)
    with pytest.raises(tguard.NumericalDivergence, match="budget"):
        guard.step(step=8)


def test_blame_bisects_to_the_poisoned_rows():
    guard = tguard.TrainGuard()
    bad = {3, 12}
    rows = guard.blame(lambda idx: not (set(idx.tolist()) & bad), 16,
                       step=5)
    assert rows == [3, 12] and guard.stats()["blamed_rows"] == 2


def test_dist_step_guard_health_plain_step_and_one_sync():
    """The plain step's health vector (one pass a gradient) is the JAX
    step's; a NaN batch flips its indicator to a skip verdict; a guard
    reading it makes one host fetch a step."""
    jnet, tnet = _nets()
    mesh = _jmesh()
    jstep = JStep(jnet, lambda x, y: JF.mse_loss(jnet(x), y),
                  paddle.optimizer.SGD(0.05, parameters=jnet.parameters()),
                  mesh=mesh, guard_health=True)
    tstep = DistributedTrainStep(
        tnet, lambda x, y: _tmse(tnet(x), y),
        SGD(0.05, parameters=list(tnet.parameters())), guard_health=True)
    guard = tguard.TrainGuard(min_history=10 ** 9)
    n0 = tguard.host_sync_count()
    for step in range(3):
        x, y = _batch(step)
        jstep(JTensor(jnp.asarray(x)), JTensor(jnp.asarray(y)))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(tstep.last_health.numpy(),
                                   np.asarray(jstep.last_health), rtol=1e-5)
        assert guard.check(tstep.last_health, step=step) == "ok"
    assert tguard.host_sync_count() - n0 == 3
    x, y = _batch(3, scale=np.nan)
    tstep(torch.from_numpy(x), torch.from_numpy(y))
    assert guard.check(tstep.last_health, step=3) == "skip"
    assert guard.last_health.fetch()[1] == 1.0


# ---------------------------------------------------------------------
# numeric chaos and the tool
# ---------------------------------------------------------------------

def test_chaos_corrupt_rows_and_tensors():
    chaos.install(chaos.plan_from_spec("inf:batch:step=2:arg=3"))
    x = np.ones((5, 2), np.float32)
    ids = np.arange(5)
    (a, b), fired = tguard.chaos_corrupt("batch", [ids, x])
    assert not fired and b is x
    (a, b), fired = tguard.chaos_corrupt("batch", [ids, x])
    assert fired and a is ids and np.isinf(b[:3]).all() and (b[3:] == 1).all()
    assert (x == 1).all()                  # copied, not written
    chaos.install(chaos.plan_from_spec("nan:loss:step=1"))
    t = torch.ones(4)
    out, fired = tguard.chaos_corrupt("loss", t)
    assert fired and torch.isnan(out[0]) and bool((out[1:] == 1).all())
    assert bool((t == 1).all())


@pytest.mark.parametrize("plan", ["nan_grad@3", "diverge@8"])
def test_chaos_numerics_tool_matches_jax(plan, tmp_path):
    """The port's tool in a subprocess on the CPU: exit 0, and the same
    skips, rewinds and blamed rows as the reference's tool run here."""
    env = dict(os.environ)
    env.pop("PADDLE_CHAOS", None)
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_numerics",
         "--plan", plan, "--steps", "16", "--device", "cpu",
         "--ckdir", str(tmp_path / "t")],
        capture_output=True, text=True, timeout=300, env=env, cwd=_REPO)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    rep = json.loads(p.stdout)
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        import chaos_numerics as jtool
    finally:
        sys.path.pop(0)
    jrep = jtool.run(plan, 16, 16, 0, str(tmp_path / "j"))
    for k in ("skips", "rewinds", "applied_steps", "pinned", "completed"):
        assert rep[k] == jrep[k], k
    assert [list(r) for _, r in rep["blamed"]] == \
        [list(r) for _, r in jrep["blamed"]]
    assert np.isfinite(rep["final_loss"])
