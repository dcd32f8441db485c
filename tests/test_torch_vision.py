"""The port's vision layers and ResNet against the JAX reference.

Weights made by the JAX layers (from ``paddle.seed``, batch-norm
statistics from a numpy seed) are carried into the port with
``load_jax_state_dict``; the same numpy inputs then go through both.
Tolerances:

- ``Conv2D`` (oneDNN against XLA, f32): atol 1e-5, rtol 1e-5;
  ``BatchNorm2D``: atol 1e-6, rtol 1e-6 (the same four f32 operations in
  the same order; XLA may fuse a multiply and an add); ``MaxPool2D``:
  equal; ``AdaptiveAvgPool2D``: atol 1e-6 (a mean summed in another
  order);
- ``resnet18(num_classes=10)`` at 32x32 in f32: 1e-4 of the largest
  logit (measured 7.7e-7);
- the same model converted to int8 at f32 compute: no further from JAX's
  int8 logits than 5 % of JAX's own int8-versus-float distance (a
  last-bit difference in an activation may move a code by one quantum;
  measured 3.0e-6 of it);
- the bench's bf16 cast of both models (every float tensor but
  ``w_scale`` in bf16): measured 5.1e-3 of the largest logit for the
  float model (oneDNN's and XLA's bf16 convolutions round differently)
  and 0 for the int8 model (exact integer products, the same bf16
  elementwise roundings); both held to 2e-2, four times the float
  model's.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.quantization import (
    convert_to_int8_inference as jax_convert)
from paddle_tpu.vision.models import resnet18 as jax_resnet18

from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                                 MaxPool2D)
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.quantization import convert_to_int8_inference
from paddle_tpu_torch.vision.models import resnet18, resnet50


def _arrays(jm):
    return {k: np.array(v._value, np.float32) if v._value.dtype != jnp.int8
            else np.array(v._value) for k, v in jm.state_dict().items()}


def _run_jax(jm, x):
    return np.asarray(jm(paddle.to_tensor(x))._value).astype(np.float32)


def _run(tm, x, dtype=torch.float32):
    with torch.no_grad():
        return tm(torch.from_numpy(x).to(dtype)).float().numpy()


def _randomise_bn(jm, seed):
    """Running statistics that are not the identity, so every term of the
    inference batch norm is exercised."""
    rng = np.random.default_rng(seed)
    for name, t in jm.state_dict().items():
        if name.endswith("_mean"):
            t._value = jnp.asarray(rng.normal(0, 0.2, t._value.shape),
                                   jnp.float32)
        elif name.endswith("_variance"):
            t._value = jnp.asarray(rng.uniform(0.5, 2.0, t._value.shape),
                                   jnp.float32)
        elif name.endswith(("bn1.weight", "bn2.weight", "bn3.weight")):
            t._value = jnp.asarray(rng.uniform(0.5, 1.0, t._value.shape),
                                   jnp.float32)


def _cast_bf16(state):
    """The bench's cast: every float tensor but ``w_scale`` to bf16."""
    for name, t in state.items():
        if not name.endswith("w_scale") and t._value.dtype == jnp.float32:
            t._value = t._value.astype(jnp.bfloat16)


# ---------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------

# (data_format, stride, padding, dilation, groups, bias)
_CONV = [("NCHW", 1, 1, 1, 1, True), ("NHWC", 2, "SAME", 1, 1, False),
         ("NCHW", (1, 2), [[1, 2], [0, 1]], 2, 1, True),
         ("NCHW", 2, [1, 2, 0, 1], 1, 2, False),
         ("NHWC", 1, [[0, 0], [1, 1], [2, 0], [0, 0]], 1, 1, True)]


@pytest.mark.parametrize("case", _CONV)
def test_conv2d_matches_jax(case):
    fmt, stride, padding, dilation, groups, bias = case
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, bias_attr=None if bias else False,
              data_format=fmt)
    paddle.seed(1)
    jc = jnn.Conv2D(4, 6, 3, **kw)
    arrays = _arrays(jc)
    if bias:
        arrays["bias"] = np.linspace(-1, 1, 6, dtype=np.float32)
        jc.bias._value = jnp.asarray(arrays["bias"])
    tc = Conv2D(4, 6, 3, device="cpu", **kw)
    load_jax_state_dict(tc, arrays)
    shape = (2, 4, 9, 8) if fmt == "NCHW" else (2, 9, 8, 4)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(_run(tc, x), _run_jax(jc, x), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_inference_matches_jax(fmt):
    jb = jnn.BatchNorm2D(5, data_format=fmt)
    rng = np.random.default_rng(3)
    arrays = {"weight": rng.uniform(0.5, 2, 5), "bias": rng.normal(0, 1, 5),
              "_mean": rng.normal(0, 1, 5), "_variance": rng.uniform(0.1, 3, 5)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    for k, v in arrays.items():
        getattr(jb, k)._value = jnp.asarray(v)
    jb.eval()
    tb = BatchNorm2D(5, data_format=fmt, device="cpu")
    load_jax_state_dict(tb, arrays)
    tb.eval()
    shape = (2, 5, 4, 3) if fmt == "NCHW" else (2, 4, 3, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(_run(tb, x), _run_jax(jb, x), atol=1e-6,
                               rtol=1e-6)
    # training mode runs with the batch statistics and moves the running
    # ones as the reference does (f32 in another order: 1e-5)
    jb.train()
    np.testing.assert_allclose(_run(tb.train(), x), _run_jax(jb, x),
                               atol=1e-5, rtol=1e-5)
    for k in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(getattr(jb, k)._value),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", [dict(kernel_size=3, stride=2, padding=1),
                                dict(kernel_size=2, ceil_mode=True),
                                dict(kernel_size=3, stride=2, padding="SAME"),
                                dict(kernel_size=(2, 3), stride=1,
                                     padding=[[1, 0], [0, 1]])])
def test_max_pool_matches_jax(fmt, kw):
    shape = (2, 3, 7, 8) if fmt == "NCHW" else (2, 7, 8, 3)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    got = _run(MaxPool2D(data_format=fmt, **kw), x)
    want = _run_jax(jnn.MaxPool2D(data_format=fmt, **kw), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("out", [(1, 1), (3, 2), 4])
def test_adaptive_avg_pool_matches_jax(fmt, out):
    shape = (2, 3, 7, 6) if fmt == "NCHW" else (2, 7, 6, 3)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = _run(AdaptiveAvgPool2D(out, data_format=fmt), x)
    want = _run_jax(jnn.AdaptiveAvgPool2D(out, data_format=fmt), x)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------
# weights across
# ---------------------------------------------------------------------

def _jax_resnet18(seed=0, **kw):
    paddle.seed(seed)
    jm = jax_resnet18(num_classes=10, **kw)
    _randomise_bn(jm, seed + 100)
    jm.eval()
    return jm


def test_load_carries_parameters_and_buffers():
    jm = _jax_resnet18()
    arrays = _arrays(jm)
    assert "layer1.0.downsample.1._mean" not in arrays   # 64 -> 64
    assert {"layer2.0.downsample.1._mean", "bn1._variance",
            "fc.weight"} <= set(arrays)
    tm = resnet18(num_classes=10, device="cpu")
    load_jax_state_dict(tm, arrays)
    back = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    assert tuple(tm.fc.weight.shape) == (512, 10)        # [in, out]
    bad = dict(arrays)
    bad.pop("bn1._mean")
    with pytest.raises(KeyError, match="missing=\\['bn1._mean'\\]"):
        load_jax_state_dict(tm, bad)
    with pytest.raises(KeyError, match="extra=\\['x'\\]"):
        load_jax_state_dict(tm, {**arrays, "x": np.zeros(1)})
    with pytest.raises(ValueError, match="bn1._variance"):
        load_jax_state_dict(tm, {**arrays, "bn1._variance": np.ones(3)})


def test_load_keeps_int8_codes_and_f32_scales_in_a_bf16_model():
    jm = _jax_resnet18()
    jax_convert(jm)
    _cast_bf16(jm.state_dict())
    arrays = _arrays(jm)
    assert arrays["conv1.qweight"].dtype == np.int8
    tm = convert_to_int8_inference(resnet18(num_classes=10, device="cpu",
                                            dtype="bfloat16"))
    assert sorted(tm.state_dict()) == sorted(arrays)
    load_jax_state_dict(tm, arrays)
    st = tm.state_dict()
    assert st["conv1.qweight"].dtype == torch.int8
    assert st["layer4.1.conv2.w_scale"].dtype == torch.float32
    assert st["fc.bias"].dtype == st["bn1._mean"].dtype == torch.bfloat16
    for k, a in arrays.items():
        np.testing.assert_array_equal(st[k].float().numpy(),
                                      a.astype(np.float32), err_msg=k)


# ---------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------

def _x(fmt="NCHW", n=2):
    x = np.random.default_rng(6).standard_normal((n, 3, 32, 32)).astype(
        np.float32)
    return x if fmt == "NCHW" else x.transpose(0, 2, 3, 1).copy()


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_f32_matches_jax(fmt):
    jm = _jax_resnet18(data_format=fmt)
    tm = resnet18(num_classes=10, data_format=fmt, device="cpu").eval()
    load_jax_state_dict(tm, _arrays(jm))
    x = _x(fmt)
    want = _run_jax(jm, x)
    got = _run(tm, x)
    assert got.shape == (2, 10)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_resnet18_int8_matches_jax():
    jm = _jax_resnet18()
    x = _x()
    jax_float = _run_jax(jm, x)
    jax_convert(jm, compute_dtype=jnp.float32)
    jax_int8 = _run_jax(jm, x)
    tm = convert_to_int8_inference(
        resnet18(num_classes=10, device="cpu"), compute_dtype=torch.float32)
    load_jax_state_dict(tm, _arrays(jm))
    got = _run(tm, x)
    # 20 convolutions and the classifier, each one kernel call
    assert registry.spec("int8_matmul").torch_ref_calls >= 21
    d_jax = np.abs(jax_int8 - jax_float).max()
    assert d_jax > 0
    assert np.abs(got - jax_int8).max() <= 0.05 * d_jax


@pytest.mark.parametrize("int8", [False, True])
def test_resnet18_bench_bf16_cast_matches_jax(int8):
    jm = _jax_resnet18()
    tm = resnet18(num_classes=10, device="cpu", dtype="bfloat16").eval()
    if int8:
        jax_convert(jm)
        convert_to_int8_inference(tm)
    arrays = _arrays(jm)                  # f32 numbers, bf16-valued below
    _cast_bf16(jm.state_dict())
    load_jax_state_dict(tm, arrays)
    x = _x()
    want = _run_jax(jm, np.asarray(jnp.asarray(x, jnp.bfloat16)))
    got = _run(tm, x, torch.bfloat16)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_resnet50_int8_launch_count_and_layout():
    """54 kernel calls per forward (53 convolutions and the classifier),
    channels-last activations between them, NCHW logical shapes."""
    tm = convert_to_int8_inference(
        resnet50(num_classes=1000, device="cpu",
                 generator=torch.Generator().manual_seed(0)),
        compute_dtype=torch.float32)
    registry.reset_counts()
    with torch.no_grad():
        y = tm(torch.from_numpy(_x(n=1)))
    assert y.shape == (1, 1000) and torch.isfinite(y).all()
    assert registry.spec("int8_matmul").torch_ref_calls == 54
