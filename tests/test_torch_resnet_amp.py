"""The ResNet-50 training slice's bf16 AMP step against the JAX reference:
the bench's strategy (``amp`` with ``amp_configs={"dtype": "bfloat16"}``,
f32 masters) on the setup of ``test_torch_resnet_train.py`` (weights made
by the JAX model from a seed; ``resnet50(num_classes=10)``, batch 8,
32x32, ``Momentum(lr 0.01, momentum 0.9)``), one step from the initial
weights.

Why the bounds are stage by stage: at initialisation this network is
chaotic under bf16 rounding, in the reference as in the port.  Measured
on these inputs, each package's bf16 forward is 0.3 %, 1.9 %, 6 %, 25 %
and 67 % (relative norm) from its own f32 forward after the stem and
layers 1 to 4, and the two bf16 forwards are 0, 0.3 %, 1.9 %, 9 % and
37 % apart; the reference's own bf16 gradient has cosine 0.06 with its
f32 gradient (the port's 0.04).  So the step is held where bf16 leaves
it well defined, with the measured values in brackets:

- the running statistics of the stem and layer1: 5e-3 of each buffer's
  largest value [1.4e-3]; layer2: 3e-2 [7.6e-3]; layers 3 and 4 finite;
- the loss: finite, relative 0.25 [0.15] (each package's bf16 loss is
  5 % and 22 % from its own f32 loss);
- masters, velocities and running statistics stay f32, the step moves
  each master by lr times its velocity, and no kernel runs.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch.ops.kernels import registry

from test_torch_resnet_train import LRS, _buffers, _setup, _steps

_STAGE_TOL = {"bn1.": 5e-3, "layer1.": 5e-3, "layer2.": 3e-2}


@pytest.fixture(scope="module")
def rec():
    (r,) = _steps(_setup(), LRS[:1], amp=True)
    yield r
    mesh_mod.set_mesh(None)
    registry.reset_counts()


@pytest.mark.parametrize("stage", sorted(_STAGE_TOL))
def test_amp_step_running_statistics(rec, stage):
    keys = [k for k in _buffers(rec) if k.startswith(stage)]
    assert keys
    for k in keys:
        want, got = rec["jax"][k], rec["port"][k]
        assert np.abs(got - want).max() <= _STAGE_TOL[stage] * np.abs(
            want).max(), k


def test_amp_step_loss_and_deep_statistics_finite(rec):
    assert rec["amp"] and rec["loss"].dtype == torch.float32
    assert np.isfinite(float(rec["loss"])) and np.isfinite(rec["jax_loss"])
    np.testing.assert_allclose(float(rec["loss"]), rec["jax_loss"],
                               rtol=0.25)
    for k in _buffers(rec):
        assert np.isfinite(rec["port"][k]).all(), k


def test_amp_step_keeps_f32_state_and_runs_no_kernel(rec):
    assert set(rec["dtypes"].values()) == {torch.float32}
    assert rec["vel_dtypes"] == {torch.float32}
    # from a zero velocity the step moves each master by lr times its
    # f32 velocity: one rounding of lr * v and of p - lr * v, and one
    # more here in p0 - p1
    for n, st in rec["port_vel"].items():
        v, p0, p1 = st["velocity"], rec["before"][n], rec["port"][n]
        step = np.float32(rec["lr"]) * v
        assert v.dtype == p1.dtype == np.float32 and np.isfinite(v).all()
        assert np.all(np.abs((p0 - p1) - step)
                      <= 2.0 ** -22 * (np.abs(p0) + np.abs(step))), n
    assert all(v == 0 for v in registry.launch_counts().values())
    assert all(s.torch_ref_calls == 0 for s in registry.kernels().values())
