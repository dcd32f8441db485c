"""The port's DGC (``fleet/dgc.py`` and ``strategy.dgc`` in
``DistributedTrainStep``) against the JAX reference, at world 1 (no
process group) and at world 2 (two gloo processes on the CPU, started
once for the module by ``spawn``).

The reference's cases (``tests/test_dgc_dist_step.py``): a 6 -> 32 tanh
-> 2 classifier under ``Momentum`` with cross entropy on one batch of 16.
Tolerances: the ramp exact; ``dgc_compress`` bitwise JAX's on the same
state and gradients (``torch.topk`` and ``lax.top_k`` pick the same
entries where no two magnitudes tie); the warm-up steps bitwise the
port's dense step; whole DGC runs within rtol 1e-5 of the JAX step at
world 1 (f32, the same compressed entries); at world 2 the ranks'
parameters bitwise equal, the warm-up steps within 2e-5 of the JAX dense
step on two devices, and every compressed tensor sending exactly
``max(1, round(n (1 - sparsity)))`` entries a rank.  Both steps
compress the global gradient once (the JAX step's data-axis sum is in
its backward; the port all-reduces the ranks' gradients first), so ``u``
and ``v`` are the same on every rank, and world-2 runs, warm-up and
compressed steps, with and without clip and decay, are held within 2e-5
of the JAX DGC step on two devices."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.distributed.fleet import dgc as jdgc

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.distributed.fleet import dgc as tdgc
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Adam, Momentum

import torch_dist_worker as worker


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


def _weights(seed=0, sizes=(6, 32, 2)):
    paddle.seed(seed)
    m = jnn.Sequential(jnn.Linear(sizes[0], sizes[1]), jnn.Tanh(),
                       jnn.Linear(sizes[1], sizes[2]))
    return {k: np.asarray(v._value).copy() for k, v in m.state_dict().items()}


def _case(dgc=None, steps=25, lr=0.2, mesh=None, classes=2):
    """``classes`` 3: the head's gradient has no two entries of one
    magnitude (with 2, softmax's output bias gets ``g`` and ``-g``, a tie
    that ``torch.topk`` and ``lax.top_k`` may break either way)."""
    rng = np.random.RandomState(1)
    x = rng.randn(16, 6).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    if classes == 3:
        y = y + (x[:, 0] > 0.5)
    st = {}
    if dgc is not None:
        st = {"dgc": True, "dgc_configs": dgc}
    sizes = [6, 32, classes]
    return dict(weights=_weights(sizes=sizes), sizes=sizes, act="tanh",
                loss="ce",
                opt="Momentum", opt_kw={"momentum": 0.9}, lr=lr,
                strategy=st, mesh=mesh, xs=np.stack([x] * steps),
                ys=np.stack([y] * steps))


def _jax_run(case, ndev=1):
    mesh = jmesh.init_mesh(case["mesh"] or {"dp": 1},
                           devices=jax.devices()[:ndev])
    m = jnn.Sequential(jnn.Linear(6, 32), jnn.Tanh(),
                       jnn.Linear(32, case["sizes"][2]))
    m.set_state_dict({k: paddle.to_tensor(v)
                      for k, v in case["weights"].items()})
    kw = {}
    if "clip" in case:
        from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
        kw["grad_clip"] = JClip(case["clip"])
    if "weight_decay" in case["opt_kw"]:
        kw["weight_decay"] = case["opt_kw"]["weight_decay"]
    opt = paddle.optimizer.Momentum(learning_rate=case["lr"], momentum=0.9,
                                    parameters=m.parameters(), **kw)
    s = JStrategy()
    for k, v in case["strategy"].items():
        setattr(s, k, v)
    step = JStep(m, lambda a, b: JF.cross_entropy(m(a), b).mean(), opt, s,
                 mesh=mesh)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y))._value)
              for x, y in zip(case["xs"], case["ys"])]
    jmesh.set_mesh(None)
    return dict(losses=losses, params={
        k: np.asarray(v._value) for k, v in m.state_dict().items()})


def _clipped(case, clip=0.05, decay=0.01):
    case["clip"] = clip             # ClipGradByGlobalNorm, engaged
    case["opt_kw"] = dict(case["opt_kw"], weight_decay=decay)
    return case


W2 = [_case({"rampup_begin_step": 2, "rampup_step": 1, "sparsity": [0.75]},
            steps=8, mesh={"dp": 2}, classes=3),
      _case(None, steps=2, mesh={"dp": 2}, classes=3),
      _clipped(_case({"rampup_begin_step": 2, "rampup_step": 1,
                      "sparsity": [0.75]}, steps=6, mesh={"dp": 2},
                     classes=3))]


@pytest.fixture(scope="module", autouse=True)
def _ranks():
    ctx = spawn(worker.train_cases, args=(W2,), nprocs=2, backend="gloo",
                timeout=60, join=False)
    got = []
    yield lambda: got[0] if got else got.append(ctx.join(240)) or got[0]
    ctx.close()


# -- fleet/dgc.py --------------------------------------------------------

def test_rampup_schedule_matches_jax():
    for begin, ramp, spars in ((0, 1, [0.999]), (2, 10, [0.5, 0.75, 0.9]),
                               (5, 3, [0.1, 0.2])):
        for step in range(0, 20):
            assert tdgc.rampup_stage_index(step, begin, ramp, len(spars)) \
                == jdgc.rampup_stage_index(step, begin, ramp, len(spars))
            assert tdgc.rampup_sparsity(step, begin, ramp, spars) == \
                jdgc.rampup_sparsity(step, begin, ramp, spars)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 0.999])
def test_dgc_compress_is_bitwise_jax(sparsity):
    rng = np.random.RandomState(3)
    shapes = {"w": (8, 16), "b": (16,), "s": (3,)}
    st = {ax: {k: rng.randn(*s).astype(np.float32) for k, s in
               shapes.items()} for ax in ("u", "v")}
    g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jst, jout = jdgc.dgc_compress(
        {ax: {k: jnp.asarray(v) for k, v in d.items()}
         for ax, d in st.items()},
        {k: jnp.asarray(v) for k, v in g.items()}, momentum=0.9,
        sparsity=sparsity)
    tst, tout = tdgc.dgc_compress(
        {ax: {k: torch.from_numpy(v) for k, v in d.items()}
         for ax, d in st.items()},
        {k: torch.from_numpy(v) for k, v in g.items()}, momentum=0.9,
        sparsity=sparsity)
    for k, n in ((k, int(np.prod(s))) for k, s in shapes.items()):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
        for ax in ("u", "v"):
            np.testing.assert_array_equal(tst[ax][k].numpy(),
                                          np.asarray(jst[ax][k]))
        sent = int((tout[k] != 0).sum())
        assert sent == tdgc.topk_count(n, sparsity)
        assert not bool((tst["v"][k][tout[k] != 0]).any())
        assert not bool((tst["u"][k][tout[k] != 0]).any())
    z = tdgc.dgc_init({"w": torch.ones(2, 3)})
    assert not z["u"]["w"].any() and z["v"]["w"].shape == (2, 3)


# -- the step at world 1 --------------------------------------------------

def test_dgc_trains_close_to_dense_and_to_jax():
    dense = worker.train_case(_case())["losses"]
    cfg = {"rampup_begin_step": 0, "sparsity": [0.75], "momentum": 0.9}
    got = worker.train_case(_case(cfg))
    dgc = got["losses"]
    assert dgc[-1] < 0.5 * dgc[0]
    assert dgc[-1] < dense[0]
    assert abs(dgc[-1] - dense[-1]) < 0.25
    ref = _jax_run(_case(cfg))
    np.testing.assert_allclose(dgc, ref["losses"], rtol=1e-5, atol=1e-6)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for counts in got["masks"]:
        assert counts == {"0.weight": 48, "0.bias": 8, "2.weight": 16,
                          "2.bias": 1}


def test_dgc_warmup_is_the_dense_step_bitwise():
    dense = worker.train_case(_case(steps=5))
    dgc = worker.train_case(_case({"rampup_begin_step": 100,
                                   "sparsity": [0.999]}, steps=5))
    assert dgc["losses"] == dense["losses"]
    for k, v in dense["params"].items():
        np.testing.assert_array_equal(dgc["params"][k], v)
    assert dgc["masks"] == []


def _linear_step(opt_cls, cfg, **kw):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    opt = opt_cls(learning_rate=0.1, parameters=list(model.parameters()),
                  **kw)
    s = DistributedStrategy()
    s.dgc = True
    s.dgc_configs = cfg
    return model, opt, s


def test_dgc_post_warmup_uses_sgd_apply():
    model, opt, s = _linear_step(Momentum, {"rampup_begin_step": 0,
                                            "sparsity": [0.5]}, momentum=0.9)
    step = DistributedTrainStep(
        model, lambda x, y: F.cross_entropy(model(x), y).mean(), opt, s)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 2, (8,)).astype(np.int64))
    for _ in range(3):
        step(x, y)
    for st in opt.opt_state():
        assert float(st["velocity"].abs().sum()) == 0.0


def test_dgc_multi_stage_ramp_trains():
    got = worker.train_case(_case({"rampup_begin_step": 2,
                                   "rampup_step": 10,
                                   "sparsity": [0.5, 0.75, 0.9],
                                   "momentum": 0.9}, steps=30))
    assert got["losses"][-1] < 0.5 * got["losses"][0]
    # the ramp: 0.5 from step 2, 0.75 from step 6, 0.9 from step 9
    assert got["masks"][0]["0.weight"] == 96
    assert got["masks"][4]["0.weight"] == 48
    assert got["masks"][-1]["0.weight"] == tdgc.topk_count(192, 0.9)


def test_dgc_refusals_keep_the_reference_messages():
    model, opt, s = _linear_step(Adam, {})
    with pytest.raises(ValueError, match="Momentum or SGD"):
        DistributedTrainStep(model, lambda x: model(x).sum(), opt, s)
    model, opt, s = _linear_step(Momentum, {}, use_nesterov=True)
    with pytest.raises(NotImplementedError, match="nesterov"):
        DistributedTrainStep(model, lambda x: model(x).sum(), opt, s)
    model, opt, s = _linear_step(Momentum, {})
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2, "avg": True}
    with pytest.raises(NotImplementedError, match="gradient_merge"):
        DistributedTrainStep(model, lambda x: model(x).sum(), opt, s)
    model, opt, s = _linear_step(Momentum, {})
    with pytest.raises(NotImplementedError, match="DGC"):
        DistributedTrainStep(model, lambda x: model(x).sum(), opt, s,
                             guard_health=True)
    model, opt, s = _linear_step(SGD, {})
    s.amp = True
    s.amp_configs = {"dtype": "float16"}
    with pytest.raises(NotImplementedError, match="float16"):
        DistributedTrainStep(model, lambda x: model(x).sum(), opt, s)


def test_dgc_keeps_clip_and_decay_when_compressing():
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    w0 = model.weight.detach().clone()
    opt = Momentum(learning_rate=1.0, momentum=0.0, weight_decay=0.5,
                   grad_clip=ClipGradByGlobalNorm(1e-12),
                   parameters=list(model.parameters()))
    s = DistributedStrategy()
    s.dgc = True
    s.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.0]}
    step = DistributedTrainStep(
        model, lambda x, y: F.cross_entropy(model(x), y).mean(), opt, s)
    rng = np.random.RandomState(0)
    step(torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
         torch.from_numpy(rng.randint(0, 2, (8,)).astype(np.int64)))
    np.testing.assert_allclose(model.weight.detach().numpy(),
                               0.5 * w0.numpy(), rtol=1e-4, atol=1e-6)


def test_distributed_optimizer_warns_dgc_and_fp16_allreduce():
    s = DistributedStrategy()
    s.dgc = True
    s.fp16_allreduce = True
    m = torch.nn.Linear(2, 2)
    with pytest.warns(UserWarning) as rec:
        fleet.distributed_optimizer(Momentum(
            0.1, parameters=list(m.parameters())), s)
    text = " ".join(str(w.message) for w in rec)
    assert "no-op" in text and "not compressed" in text
    s2 = DistributedStrategy()
    s2.fp16_allreduce = True
    with pytest.warns(UserWarning, match="no-op"):
        DistributedTrainStep(m, lambda x: m(x).sum(),
                             Momentum(0.1, parameters=list(m.parameters())),
                             s2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DistributedTrainStep(m, lambda x: m(x).sum(),
                             Momentum(0.1, parameters=list(m.parameters())),
                             s2)        # once a strategy


# -- the step at world 2 ---------------------------------------------------

def test_world2_dgc_ranks_equal_and_send_k(_ranks):
    res = [r[0] for r in _ranks()]
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v)
    for r in res:
        assert len(r["masks"]) == 6            # steps 2..7 compress
        for counts in r["masks"]:
            assert counts == {"0.weight": tdgc.topk_count(192, 0.75),
                              "0.bias": 8,
                              "2.weight": tdgc.topk_count(96, 0.75),
                              "2.bias": 1}
    # the global gradient is compressed once: u and v are every rank's
    for k in res[0]["dgc"]:
        for ax in (0, 1):
            np.testing.assert_array_equal(res[0]["dgc"][k][ax],
                                          res[1]["dgc"][k][ax])
    assert res[0]["losses"][-1] < res[0]["losses"][0]


def test_world2_warmup_matches_jax_dense_on_two_devices(_ranks):
    res = _ranks()
    dgc0, dense = res[0][0], res[0][1]
    # the warm-up steps are the dense step: the same first two losses
    assert dgc0["losses"][:2] == dense["losses"]
    ref = _jax_run(W2[1], 2)
    np.testing.assert_allclose(dense["losses"], ref["losses"], rtol=2e-5,
                               atol=2e-5)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(dense["params"][k], v, rtol=2e-5,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("i", [0, 2])
def test_world2_matches_the_jax_dgc_step_on_two_devices(_ranks, i):
    """Case 0: no clip or decay, 8 steps; case 2: a global-norm clip that
    engages and L2 decay, 6 steps.  Both ranks' losses and parameters
    within 2e-5 of the JAX DGC step on a {"dp": 2} mesh of two CPU
    devices, the same weights and batches."""
    ref = _jax_run(W2[i], 2)
    for r in _ranks():
        got = r[i]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5,
                                   atol=2e-5)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=2e-5,
                                       atol=2e-5, err_msg=k)
