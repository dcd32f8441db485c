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

import chip_smoke
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
from paddle_tpu_torch.ops.kernels import int8_matmul as im
from paddle_tpu_torch.ops.kernels.int8_matmul import CARD_TOL, int8_matmul
from paddle_tpu_torch.quantization import (
    Int8InferenceConv2D, Int8InferenceLinear, convert_to_int8_inference,
    set_kernel_mode)
from paddle_tpu_torch.vision.models import resnet50

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


# ---------------------------------------------------------------------
# the dynamic kernel's launch plan
# ---------------------------------------------------------------------

# (rows a 224x224 image, K, N, calls a forward): every int8_matmul call of
# the int8 ResNet-50 (53 convolutions and the classifier), as
# test_recorded_resnet50_gemms finds them; at batch b the rows are b times
_RESNET50_GEMMS = [
    (12544, 147, 64, 1),                          # stem 7x7/2
    (3136, 64, 64, 1), (3136, 576, 64, 3), (3136, 64, 256, 4),
    (3136, 256, 64, 2), (3136, 256, 128, 1),      # layer1, layer2's conv1
    (784, 1152, 128, 4), (784, 128, 512, 4), (784, 256, 512, 1),
    (784, 512, 128, 3), (784, 512, 256, 1),       # layer2, layer3's conv1
    (196, 2304, 256, 6), (196, 256, 1024, 6), (196, 512, 1024, 1),
    (196, 1024, 256, 5), (196, 1024, 512, 1),     # layer3, layer4's conv1
    (49, 4608, 512, 3), (49, 512, 2048, 3), (49, 1024, 2048, 1),
    (49, 2048, 512, 2),                           # layer4
    (1, 2048, 1000, 1)]                           # classifier


def test_recorded_resnet50_gemms():
    """The int8 ResNet-50 at 224x224 sends exactly these GEMMs, 54 a
    forward, all dynamic with bf16 output (as chip_smoke.py's
    ``recorded_int8_shapes`` finds them, which its phase 3 reads the
    card's shape list from)."""
    gen = torch.Generator().manual_seed(0)
    model = convert_to_int8_inference(
        resnet50(num_classes=1000, device="cpu", generator=gen))
    with torch.no_grad(), chip_smoke.recorded_int8_shapes() as shapes:
        y = model(torch.randn(1, 3, 224, 224, generator=gen))
    assert y.shape == (1, 1000)
    assert dict(shapes) == {(m, k, n, torch.bfloat16, True): c
                            for m, k, n, c in _RESNET50_GEMMS}
    assert sum(shapes.values()) == 54
    assert registry.spec("int8_matmul").torch_ref_calls == 54


def test_recorded_shapes_counts_only_inside_the_block():
    """chip_smoke.py's recorder counts the int8 layers' calls made inside
    its block (nested blocks each theirs) and leaves the layers calling
    ``int8_matmul`` itself after it."""
    import paddle_tpu_torch.quantization as q
    torch.manual_seed(3)
    dyn = Int8InferenceLinear(Linear(40, 8, device="cpu"))
    wonly = Int8InferenceLinear(Linear(40, 8, device="cpu"),
                                compute_dtype="float32", act_quant=None)
    x = torch.randn(2, 3, 40)
    dyn(x)
    with chip_smoke.recorded_int8_shapes() as outer:
        with chip_smoke.recorded_int8_shapes() as inner:
            dyn(x)
        wonly(x)
    dyn(x)
    assert q.int8_matmul is int8_matmul
    assert inner == {(6, 40, 8, torch.bfloat16, True): 1}
    assert outer == {(6, 40, 8, torch.bfloat16, True): 1,
                     (6, 40, 8, torch.float32, False): 1}
    assert registry.spec("int8_matmul").torch_ref_calls == 4


def _check_plan(p, M, N, K, sms, out_bytes):
    """What the C entry checks of a plan, and what the plan promises."""
    bm, bn = p.block_m, p.block_n
    tiles_n = -(-N // bn)
    tiles = -(-M // bm) * tiles_n
    assert bm in (64, 128) and bn in (64, 128)
    assert bn == (64 if N <= 64 else 128)

    # the tile height whose blocks walk the fewer rows; 128 on a tie
    def rows_walked(h):
        return -(-(-(-M // h) * tiles_n) // sms) * h

    assert bm == (128 if rows_walked(128) <= rows_walked(64) else 64)
    # each tile walks K once, in whole 128-byte k-tiles: none empty
    assert (p.k_tiles - 1) * 128 < K <= p.k_tiles * 128
    # the grid: one block an SM at most, every SM busy where the tiles
    # allow
    assert p.grid == min(tiles, sms)
    assert p.threads == 128 * (bm // 64) + 32
    staging = (bm // 64) * 64 * bn * out_bytes
    assert 2 <= p.stages <= 8
    assert p.smem_bytes == 1152 + p.stages * (bm + bn) * 128 + staging
    assert p.smem_bytes <= 232_448
    assert p.smem_bytes + (bm + bn) * 128 > 232_448 or p.stages == 8
    # TMA stores need rows a multiple of 16 bytes; else plain stores
    assert p.tma_store == ((N * out_bytes) % 16 == 0)
    assert p.launch() == (bm, bn, p.stages, p.threads, p.smem_bytes,
                          p.grid, int(p.tma_store))


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("gemm", _RESNET50_GEMMS,
                         ids=[f"{m}x{k}x{n}" for m, k, n, _ in
                              _RESNET50_GEMMS])
def test_int8_mm_plan_at_resnet50_shapes(gemm, batch):
    m1, K, N, _ = gemm
    M = batch * m1
    for out_bytes in (2, 4):
        _check_plan(im.int8_mm_plan(M, N, K, 132, out_bytes), M, N, K, 132,
                    out_bytes)


@pytest.mark.parametrize("M,N,K,sms,want", [
    # layer4's 3x3 at batch 1: 4 tiles walk K = 4,608 (36 k-tiles)
    (49, 512, 4608, 132, (64, 128, 4)),
    # layer4's 3x3 at batch 32: 100 tiles of 64 rows (52 of 128 would
    # leave each block 128 rows to walk)
    (1568, 512, 4608, 132, (64, 128, 100)),
    # layer3's 3x3 at batch 32: 98 tiles of 128 rows in one wave, as few
    # rows a block as 196 tiles of 64 in two
    (6272, 256, 2304, 132, (128, 128, 98)),
    # the stem at batch 32: 3,136 tiles walked by 132 blocks
    (401408, 64, 147, 132, (128, 64, 132)),
    # the classifier at batch 1 and 32: 8 tiles, 16 k-tiles
    (1, 1000, 2048, 132, (64, 128, 8)),
    (32, 1000, 2048, 132, (64, 128, 8)),
    # long K on few tiles: 8 tiles each walk 64 k-tiles, 32 walk 128
    (8, 1024, 8192, 132, (64, 128, 8)),
    (1, 4096, 16384, 132, (64, 128, 32)),
    # K = 128 is one k-tile, K below one k-tile, K = 100, K = 147, N = 33
    (1, 8, 128, 132, (64, 64, 1)),
    (5, 33, 16, 132, (64, 64, 1)),
    (130, 70, 100, 132, (64, 128, 3)),
    (5, 33, 147, 132, (64, 64, 1)),
    # fewer SMs: the same shapes tile otherwise
    (1568, 512, 4608, 66, (128, 128, 52)),
    (8, 1024, 8192, 4, (64, 128, 4))])
def test_int8_mm_plan_edge_shapes(M, N, K, sms, want):
    for out_bytes in (2, 4):
        p = im.int8_mm_plan(M, N, K, sms, out_bytes)
        assert (p.block_m, p.block_n, p.grid) == want
        _check_plan(p, M, N, K, sms, out_bytes)


def test_int8_mm_plan_store_paths_and_errors():
    # N = 33 at bf16 (66-byte rows) and N = 70 at f32 (280) take plain
    # stores; N = 1000 at f32 (4,000 bytes) and bf16 (2,000) take TMA
    assert not im.int8_mm_plan(5, 33, 147, out_bytes=2).tma_store
    assert not im.int8_mm_plan(5, 70, 147, out_bytes=4).tma_store
    assert im.int8_mm_plan(32, 1000, 2048, out_bytes=4).tma_store
    assert im.int8_mm_plan(32, 1000, 2048, out_bytes=2).tma_store
    for bad in ((0, 8, 8), (8, 0, 8), (8, 8, 0)):
        with pytest.raises(ValueError, match="int8_mm_plan"):
            im.int8_mm_plan(*bad)
    with pytest.raises(ValueError, match="out_bytes"):
        im.int8_mm_plan(8, 8, 8, out_bytes=8)


@pytest.mark.parametrize("k", [1, 16, 100, 147, 2048])
def test_kernel_rows_copies_are_zero_past_k(k):
    """A copy by kernel_rows starts each row on 16 bytes and is zero from
    k to the next multiple of 16 (the dynamic kernel reads the weight
    there); rows already in that layout are returned as they are."""
    w = torch.arange(5 * k, dtype=torch.int32).remainder(255).sub(127).to(
        torch.int8).view(5, k)
    rows = im.kernel_rows(w)
    kp = -(-k // 16) * 16
    assert torch.equal(rows, w) and rows.stride() == (kp, 1)
    assert rows.data_ptr() % 16 == 0
    assert (rows is w) == (k % 16 == 0)
    full = rows.as_strided((5, kp), (kp, 1))
    assert not full[:, k:].any()


def test_weight_rows_are_zero_past_k_and_built_once():
    """The stem's weight (K = 7 * 7 * 3 = 147): the layer's kernel rows
    come in a 160-byte pitch, zero past K, and are built once."""
    torch.manual_seed(5)
    tq = Int8InferenceConv2D(Conv2D(3, 8, 7, stride=2, padding=3,
                                    device="cpu"))
    rows = tq.weight_rows()
    assert rows.shape == (8, 147) and rows.stride() == (160, 1)
    assert torch.equal(rows, tq.qweight.permute(0, 2, 3, 1).reshape(8, -1))
    assert not rows.as_strided((8, 160), (160, 1))[:, 147:].any()
    assert tq.weight_rows() is rows


def test_int8_forward_ab_pairs_runs_against_the_first_tree(monkeypatch,
                                                           capsys):
    """The A/B script's arithmetic, on made-up runs (it times only on a
    card): each pair as the other tree's numbers minus the first tree's,
    whichever ran first, and the summary's medians, quartiles and the
    pairs where the other tree was lower."""
    import json
    import types
    from paddle_tpu_torch.tools import int8_forward_ab as ab
    runs = iter([("P", 10.0, 1.0), ("C", 8.0, 1.5), ("C", 9.0, 0.5),
                 ("P", 12.0, 1.0)])

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return types.SimpleNamespace(stdout="H100, 700.00 W\n")
        tree, ms, us = next(runs)
        assert cmd[-2:] == ["--one", tree]
        return types.SimpleNamespace(stdout="noise\nAB " + json.dumps(
            {"tree": tree, "package": "x", "b1_int8_ms": ms,
             "call_host_us": us}) + "\n")

    monkeypatch.setattr(ab.subprocess, "run", fake_run)
    assert ab.main(["P", "C", "C", "P"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "H100, 700.00 W" and len(out) == 7
    pairs = json.loads(out[5].removeprefix("AB pairs "))
    assert pairs == [{"tree": "C", "b1_int8_ms": -2.0, "call_host_us": 0.5},
                     {"tree": "C", "b1_int8_ms": -3.0, "call_host_us": -0.5}]
    summary = json.loads(out[6].removeprefix("AB summary "))
    assert summary["b1_int8_ms"] == dict(
        first=11.0, other=8.5, first_quartiles=[9.5, 11.0, 12.5],
        other_lower=2, pairs=2)
    assert summary["call_host_us"]["other_lower"] == 1
