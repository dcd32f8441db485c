"""The port's executed-int8 layers and ``int8_matmul`` against the JAX
reference.

The same numpy inputs, made from seeds, go through the JAX function (the
``int8_matmul`` registry entry in ``xla_ref`` mode, and the Pallas kernel
in interpret mode) and the port's counterpart.  On the CPU the port's
kernel entry point runs its plain version, because the tensors lie on
the CPU.  Tolerances:

- dynamic mode (int8 activations), ``Int8InferenceLinear`` and
  ``Int8InferenceConv2D``: bitwise equal (integer sums are order-free,
  and the quantisation and rescale are the reference's expressions);
- weight-only mode: the registered rtol (2e-2 at bf16, 1e-5 at f32) plus
  the same share of the row's RMS for outputs that cancel to near zero
  (``CARD_TOL``, the limit the card is held to);
- the weight-only convolution (cuDNN/oneDNN against XLA, f32): atol
  1e-5, rtol 1e-5.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``; ``chip_smoke.py`` runs it at the ResNet-50 shapes).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp

import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.meta_parallel import (
    ColumnParallelLinear as JaxColumnLinear)
from paddle_tpu.nn import Conv2D as JaxConv2D
from paddle_tpu.nn import Linear as JaxLinear
from paddle_tpu.nn import Sequential as JaxSequential
from paddle_tpu.ops.pallas import registry as jreg
from paddle_tpu.quantization import (
    Int8InferenceConv2D as JaxInt8Conv, Int8InferenceLinear as JaxInt8Linear,
    convert_to_int8_inference as jax_convert)

from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.nn import Conv2D, Linear
from paddle_tpu_torch.nn.layer import ColumnParallelLinear, RowParallelLinear
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.ops.kernels.int8_matmul import CARD_TOL, int8_matmul
from paddle_tpu_torch.quantization import (
    Int8InferenceConv2D, Int8InferenceLinear, convert_to_int8_inference,
    set_kernel_mode)

# the package re-exports functions under the module names
jim = importlib.import_module("paddle_tpu.ops.pallas.int8_matmul")


@pytest.fixture(autouse=True)
def _clean():
    registry.reset_counts()
    yield
    registry.reset_counts()
    jreg.set_mode("int8_matmul", None)


def _jax_out(layer, x, mode):
    jreg.set_mode("int8_matmul", mode)
    try:
        return np.asarray(layer(paddle.to_tensor(x))._value)
    finally:
        jreg.set_mode("int8_matmul", None)


def _np(t):
    return t.detach().float().numpy()


def _quantized_weight(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    sc = np.maximum(np.abs(w).max(0) / 127.0, 1e-9).astype(np.float32)
    return np.clip(np.round(w / sc), -127, 127).astype(np.int8), sc


# ---------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------

# (x shape, N): the stem's K = 147, M = 1, leading batch dims
_MM_CASES = [((5, 70), 33), ((6, 147), 64), ((1, 96), 40), ((2, 3, 70), 17)]


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _MM_CASES)
def test_int8_matmul_dynamic_plain_bitwise_vs_jax(case, cdt):
    shape, n = case
    rng = np.random.default_rng(7)
    qw, sc = _quantized_weight(rng, shape[-1], n)
    xq = rng.integers(-127, 128, shape).astype(np.int8)
    xs = np.float32(0.013)
    jdt = jnp.dtype(cdt)
    ref = jim.int8_matmul_ref(jnp.asarray(xq), jnp.asarray(qw),
                              jnp.asarray(sc), x_scale=xs, compute_dtype=jdt)
    ker = jim.int8_matmul_pallas(jnp.asarray(xq), jnp.asarray(qw),
                                 jnp.asarray(sc), x_scale=xs,
                                 compute_dtype=jdt, interpret=True)
    got = int8_matmul(torch.from_numpy(xq), torch.from_numpy(qw.T.copy()),
                      torch.from_numpy(sc), x_scale=torch.tensor(xs),
                      compute_dtype=cdt)
    assert str(got.dtype) == f"torch.{cdt}" and got.shape == ref.shape
    for want in (ref, ker):
        assert np.array_equal(_np(got), np.asarray(want, np.float32))
    s = registry.spec("int8_matmul")
    assert (s.torch_ref_calls, s.launches) == (1, 0)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _MM_CASES)
def test_int8_matmul_weight_only_plain_vs_jax(case, cdt):
    shape, n = case
    rng = np.random.default_rng(8)
    qw, sc = _quantized_weight(rng, shape[-1], n)
    x = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.dtype(cdt)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(qw.T.copy()),
                      torch.from_numpy(sc), compute_dtype=cdt)
    for want in (jim.int8_matmul_ref(jnp.asarray(x), jnp.asarray(qw),
                                     jnp.asarray(sc), compute_dtype=jdt),
                 jim.int8_matmul_pallas(jnp.asarray(x), jnp.asarray(qw),
                                        jnp.asarray(sc), compute_dtype=jdt,
                                        interpret=True)):
        want = torch.from_numpy(np.array(want, np.float32))
        _, share = registry.card_error(got, want, CARD_TOL[got.dtype])
        assert share <= 1.0


def test_cpu_tensors_never_reach_the_int8_kernel():
    rng = np.random.default_rng(9)
    qw, sc = _quantized_weight(rng, 32, 8)
    xq = torch.from_numpy(rng.integers(-127, 128, (4, 32)).astype(np.int8))
    args = (xq, torch.from_numpy(qw.T.copy()), torch.from_numpy(sc))
    int8_matmul(*args, x_scale=0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_matmul(*args, x_scale=0.1, mode="cuda")
    s = registry.spec("int8_matmul")
    assert (s.torch_ref_calls, s.launches) == (1, 0)


# ---------------------------------------------------------------------
# Int8InferenceLinear
# ---------------------------------------------------------------------

def _linear_pair(seed, fin=24, fout=12, bias=True):
    paddle.seed(seed)
    jl = JaxLinear(fin, fout, bias_attr=None if bias else False)
    tl = Linear(fin, fout, bias_attr=None if bias else False, device="cpu")
    load_jax_state_dict(tl, {k: np.asarray(v._value)
                             for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_quant", ["dynamic", None])
def test_int8_linear_matches_jax(act_quant, cdt):
    jl, tl = _linear_pair(0)
    jq = JaxInt8Linear(jl, compute_dtype=jnp.dtype(cdt), act_quant=act_quant)
    tq = Int8InferenceLinear(tl, compute_dtype=cdt, act_quant=act_quant)
    assert np.array_equal(tq.qweight.numpy(), np.asarray(jq.qweight._value))
    assert tq.qweight.dtype == torch.int8 and tq.w_scale.dtype == torch.float32
    assert np.array_equal(tq.w_scale.numpy(), np.asarray(jq.w_scale._value))
    x = np.random.default_rng(9).standard_normal((2, 3, 24)).astype(
        np.float32)
    got = tq(torch.from_numpy(x))
    assert got.shape == (2, 3, 12)
    for mode in ("xla_ref", "interpret"):
        want = _jax_out(jq, x, mode).astype(np.float32)
        if act_quant == "dynamic":
            assert np.array_equal(_np(got), want), mode
        else:
            _, share = registry.card_error(got, torch.from_numpy(want),
                                           CARD_TOL[got.dtype])
            assert share <= 1.0, mode


def test_int8_linear_config_errors_match_jax():
    _, tl = _linear_pair(1)
    with pytest.raises(ValueError, match="act_quant must be"):
        Int8InferenceLinear(tl, act_quant="static")
    with pytest.raises(TypeError, match="floating dtype"):
        Int8InferenceLinear(tl, compute_dtype=torch.int8)


# ---------------------------------------------------------------------
# Int8InferenceConv2D
# ---------------------------------------------------------------------

# (data_format, stride, padding, dilation, groups, bias, input H x W)
_CONV_CASES = [
    ("NCHW", 2, 1, 1, 1, True, (9, 9)),
    ("NHWC", 2, 1, 1, 1, True, (9, 9)),
    ("NCHW", 1, 0, 1, 1, False, (6, 7)),         # 1x1 below
    ("NHWC", 1, "SAME", 2, 1, False, (8, 8)),
    ("NCHW", (2, 1), [[1, 0], [2, 1]], 1, 1, True, (7, 8)),
    ("NCHW", 2, 3, 1, 1, False, (12, 12)),       # 7x7 stem, K = 147
    ("NCHW", 1, 1, 1, 2, True, (6, 6)),          # grouped
    ("NHWC", 2, "VALID", 1, 4, False, (9, 7)),   # grouped
]
_CONV_KERNELS = [3, 3, 1, 3, 3, 7, 3, 3]


def _conv_pair(seed, case, k):
    fmt, stride, padding, dilation, groups, bias, (h, w) = case
    cin = 3 if k == 7 else 4
    cout = 8
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, bias_attr=None if bias else False,
              data_format=fmt)
    paddle.seed(seed)
    jc = JaxConv2D(cin, cout, k, **kw)
    tc = Conv2D(cin, cout, k, device="cpu", **kw)
    arrays = {kk: np.asarray(v._value) for kk, v in jc.state_dict().items()}
    if bias:
        arrays["bias"] = np.random.default_rng(seed).standard_normal(
            cout).astype(np.float32)
        jc.bias._value = jnp.asarray(arrays["bias"])
    load_jax_state_dict(tc, arrays)
    shape = (2, cin, h, w) if fmt == "NCHW" else (2, h, w, cin)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return jc, tc, x


@pytest.mark.parametrize("i", range(len(_CONV_CASES)))
def test_int8_conv_dynamic_bitwise_vs_jax(i):
    jc, tc, x = _conv_pair(10 + i, _CONV_CASES[i], _CONV_KERNELS[i])
    jq = JaxInt8Conv(jc, compute_dtype=jnp.float32)
    tq = Int8InferenceConv2D(tc, compute_dtype=torch.float32)
    assert np.array_equal(tq.qweight.numpy(), np.asarray(jq.qweight._value))
    assert np.array_equal(tq.w_scale.numpy(), np.asarray(jq.w_scale._value))
    got = _np(tq(torch.from_numpy(x)))
    for mode in ("xla_ref", "interpret"):
        want = _jax_out(jq, x, mode)
        assert got.shape == want.shape, mode
        assert np.array_equal(got, want), (mode, np.abs(got - want).max())
    calls = registry.spec("int8_matmul").torch_ref_calls
    assert calls == (1 if _CONV_CASES[i][4] == 1 else 0)


@pytest.mark.parametrize("i", [0, 1, 6])
def test_int8_conv_weight_only_vs_jax(i):
    jc, tc, x = _conv_pair(30 + i, _CONV_CASES[i], _CONV_KERNELS[i])
    jq = JaxInt8Conv(jc, compute_dtype=jnp.float32, act_quant=None)
    tq = Int8InferenceConv2D(tc, compute_dtype=torch.float32, act_quant=None)
    np.testing.assert_allclose(_np(tq(torch.from_numpy(x))),
                               _jax_out(jq, x, "xla_ref"), atol=1e-5,
                               rtol=1e-5)


def test_int8_conv_bf16_compute_bitwise_vs_jax():
    """At bf16 the kernel rounds f32(acc) * scale to bf16 itself; the
    reference computes it in f32 and casts: the same bits."""
    jc, tc, x = _conv_pair(40, _CONV_CASES[0], 3)
    jq = JaxInt8Conv(jc, compute_dtype=jnp.bfloat16)
    tq = Int8InferenceConv2D(tc, compute_dtype=torch.bfloat16)
    got = tq(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = _jax_out(jq, np.asarray(jnp.asarray(x, jnp.bfloat16)), "xla_ref")
    assert np.array_equal(_np(got), want.astype(np.float32))


def test_int8_conv_typed_config_validation():
    tc = Conv2D(2, 2, 3, device="cpu")
    with pytest.raises(TypeError, match="wraps a Conv2D"):
        Int8InferenceConv2D(Linear(4, 4, device="cpu"))
    with pytest.raises(TypeError, match="floating dtype"):
        Int8InferenceConv2D(tc, compute_dtype=torch.int8)
    with pytest.raises(ValueError, match="act_quant must be"):
        Int8InferenceConv2D(tc, act_quant="static")


def test_kernel_mode_routes_every_int8_layer():
    _, tc, x = _conv_pair(50, _CONV_CASES[0], 3)
    m = torch.nn.Sequential(Int8InferenceConv2D(tc, torch.float32))
    xt = torch.from_numpy(x)
    a = m(xt)
    set_kernel_mode(m, "torch_ref")
    assert torch.equal(m(xt), a)
    set_kernel_mode(m, "cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        m(xt)
    s = registry.spec("int8_matmul")
    assert (s.torch_ref_calls, s.launches) == (2, 0)


def test_weight_rows_follow_a_reloaded_qweight():
    jc, tc, x = _conv_pair(60, _CONV_CASES[1], 3)
    tq = Int8InferenceConv2D(tc, compute_dtype=torch.float32)
    first = tq(torch.from_numpy(x))
    jq = JaxInt8Conv(jc, compute_dtype=jnp.float32)
    new = np.asarray(jq.qweight._value)[::-1].copy()     # other weights
    load_jax_state_dict(tq, {"qweight": new,
                             "w_scale": np.asarray(jq.w_scale._value),
                             "bias": np.asarray(jq.bias._value)})
    jq.qweight._value = jnp.asarray(new)
    got = _np(tq(torch.from_numpy(x)))
    assert not np.array_equal(got, _np(first))
    assert np.array_equal(got, _jax_out(jq, x, "xla_ref"))


# ---------------------------------------------------------------------
# convert_to_int8_inference
# ---------------------------------------------------------------------

def test_convert_swaps_linear_and_conv_only():
    paddle.seed(3)
    jm = JaxSequential(JaxConv2D(3, 4, 3), JaxLinear(4, 5),
                       JaxColumnLinear(5, 6))
    jax_convert(jm)
    tm = torch.nn.Sequential(Conv2D(3, 4, 3, device="cpu"),
                             Linear(4, 5, device="cpu"),
                             ColumnParallelLinear(5, 6, device="cpu"),
                             RowParallelLinear(6, 2, device="cpu"))
    out = convert_to_int8_inference(tm)
    assert out is tm and not tm.training
    assert [type(m).__name__ for m in tm] == [
        "Int8InferenceConv2D", "Int8InferenceLinear", "ColumnParallelLinear",
        "RowParallelLinear"]
    assert [type(m).__name__ for m in jm._sub_layers.values()] == [
        "Int8InferenceConv2D", "Int8InferenceLinear", "ColumnParallelLinear"]
    # the kernel's K-major weight copy is not part of the state dict
    keys = set(tm.state_dict())
    assert {"0.qweight", "0.w_scale", "1.qweight", "1.w_scale",
            "1.bias"} <= keys
    assert not any("_w_rows" in k for k in keys)
    assert set(jm.state_dict()) == keys - {"3.weight", "3.bias"}
