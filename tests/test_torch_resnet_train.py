"""The ResNet-50 training slice against the JAX reference: the bench's
``_bench_resnet`` step (``Momentum(momentum=0.9)``, ``cross_entropy``,
``DistributedTrainStep`` on a one-device mesh) at ``resnet50(
num_classes=10)``, batch 8, 32x32.

Weights are made by the JAX model from a seed and carried into the port;
before each step the port is given the reference's whole state
(parameters, running statistics and velocities), so each step is held to
the reference from the same state.  Two steps at lr 0.01, one at the
bench's lr 0.1.  ``test_torch_resnet_amp.py`` runs the bench's bf16 AMP
step on the same setup.

Why the velocity bounds are loose per parameter: at this size layer4
works on 1x1 maps, so its batch norms normalise over 8 values, and the
gradients of the deep layers are ill-conditioned in f32.  Measured from
the initial weights, the reference's own f32 gradient is up to 5 % (per
parameter, 0.4 % globally) from an f64 run of the port, and the port's
f32 one up to 8 % (1.2 % globally); between the two packages up to 16 %
of a parameter's largest velocity and 1.4 % globally.  The forward is
well conditioned: losses agree within 4e-5 and running statistics within
6e-5 of their scale.  Bounds, with the measured values:

- loss: relative 2e-4 (4e-5); running statistics: 5e-4 of each buffer's
  largest value (6e-5);
- velocities: 4e-2 of their global norm (1.4e-2) and 0.4 of each
  parameter's largest (0.16); parameters: lr times the same per-parameter
  bound (they differ by lr times the velocities' difference).
"""
import numpy as np
import pytest

import jax

import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.vision.models import resnet50 as jresnet50

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.framework.io import (load_jax_opt_state,
                                           load_jax_state_dict,
                                           opt_state_arrays, state_arrays)
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.vision.models import resnet50

LRS = (0.01, 0.01, 0.1)


def _strategies(amp):
    out = []
    for s in (JStrategy(), DistributedStrategy()):
        if amp:
            s.amp = True
            s.amp_configs = {"dtype": "bfloat16"}
        out.append(s)
    return out


def _setup():
    """Both packages' ResNet-50, Momentum and loss, from one seed, on a
    one-device mesh as the bench's ``_make_step`` builds it."""
    mesh_mod.set_mesh(None)
    registry.reset_counts()
    paddle.seed(0)
    jm = jresnet50(num_classes=10)
    tm = resnet50(num_classes=10, device="cpu")
    jopt = paddle.optimizer.Momentum(learning_rate=LRS[0], momentum=0.9,
                                     parameters=jm.parameters())
    topt = pt.optimizer.Momentum(learning_rate=LRS[0], momentum=0.9,
                                 parameters=list(tm.parameters()))

    def jloss(img, label):
        return JF.cross_entropy(jm(img), label).mean()

    def tloss(img, label):
        return pt.nn.functional.cross_entropy(tm(img), label).mean()

    rng = np.random.RandomState(0)
    img = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    label = rng.randint(0, 10, (8,)).astype(np.int64)
    return dict(jm=jm, tm=tm, jopt=jopt, topt=topt, jloss=jloss,
                tloss=tloss, img=img, label=label,
                mesh=mesh_mod.init_mesh({"dp": 1},
                                        devices=jax.devices()[:1]),
                jname={id(p): n for n, p in jm.named_parameters()})


def _jstate(ctx):
    arrays = {k: np.asarray(v._value).astype(np.float32)
              for k, v in ctx["jm"].state_dict().items()}
    vel = {ctx["jname"][id(p)]: {k: np.asarray(v) for k, v in st.items()}
           for p, st in zip(ctx["jopt"]._parameter_list,
                            ctx["jopt"].opt_state())}
    return arrays, vel


def _steps(ctx, lrs, amp):
    """One step per entry of ``lrs`` on both sides, the port given the
    reference's whole state before each; a record per step."""
    js, ts = _strategies(amp)
    jm, tm, jopt, topt = ctx["jm"], ctx["tm"], ctx["jopt"], ctx["topt"]
    jstep = JStep(jm, ctx["jloss"], jopt, js, mesh=ctx["mesh"])
    tstep = DistributedTrainStep(tm, ctx["tloss"], topt, ts)
    records = []
    for lr in lrs:
        arrays, vel = _jstate(ctx)
        load_jax_state_dict(tm, arrays)
        load_jax_opt_state(topt, tm, vel)
        jopt.set_lr(lr)
        topt._learning_rate = lr
        jl = float(np.asarray(jstep(paddle.to_tensor(ctx["img"]),
                                    paddle.to_tensor(ctx["label"]))._value))
        tl = tstep(torch.from_numpy(ctx["img"]),
                   torch.from_numpy(ctx["label"]))
        ja, jv = _jstate(ctx)
        records.append(dict(
            lr=lr, amp=amp, jax_loss=jl, loss=tl, jax=ja, jax_vel=jv,
            before=arrays,
            port=state_arrays(tm), port_vel=opt_state_arrays(topt, tm),
            dtypes={k: v.dtype for k, v in tm.state_dict().items()},
            vel_dtypes={st["velocity"].dtype for st in topt.opt_state()}))
    return records


@pytest.fixture(scope="module")
def runs():
    """Both packages through the three f32 steps."""
    records = _steps(_setup(), LRS, amp=False)
    yield records
    mesh_mod.set_mesh(None)
    registry.reset_counts()


def _buffers(rec):
    return [k for k in rec["jax"] if k.endswith(("_mean", "_variance"))]


def _vel_global(rec):
    names = sorted(rec["jax_vel"])
    a = np.concatenate([rec["jax_vel"][n]["velocity"].ravel()
                        for n in names])
    b = np.concatenate([rec["port_vel"][n]["velocity"].ravel()
                        for n in names])
    return np.linalg.norm(a - b) / np.linalg.norm(a)


@pytest.mark.parametrize("i", range(3))
def test_f32_step_loss(runs, i):
    rec = runs[i]
    assert rec["loss"].dtype == torch.float32 and rec["loss"].dim() == 0
    assert np.isfinite(float(rec["loss"]))
    np.testing.assert_allclose(float(rec["loss"]), rec["jax_loss"],
                               rtol=2e-4)


@pytest.mark.parametrize("i", range(3))
def test_f32_step_running_statistics(runs, i):
    rec = runs[i]
    keys = _buffers(rec)
    assert len(keys) == 2 * 53
    for k in keys:
        want, got = rec["jax"][k], rec["port"][k]
        assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max(), k


@pytest.mark.parametrize("i", range(3))
def test_f32_step_velocities_and_parameters(runs, i):
    rec = runs[i]
    assert _vel_global(rec) <= 4e-2
    assert len(rec["jax_vel"]) == 161
    for n, st in rec["jax_vel"].items():
        want, got = st["velocity"], rec["port_vel"][n]["velocity"]
        vmax = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.4 * vmax, n
        dp = np.abs(rec["port"][n] - rec["jax"][n]).max()
        assert dp <= rec["lr"] * 0.4 * vmax + 1e-7, n


def test_no_kernel_on_the_training_path(runs):
    """The reference's ResNet training runs no Pallas kernel, and the
    port's runs no kernel either: no launch and no plain-version call of
    any registered kernel (kernel 10 stays on its A/B path)."""
    assert all(v == 0 for v in registry.launch_counts().values())
    assert all(s.torch_ref_calls == 0 for s in registry.kernels().values())
