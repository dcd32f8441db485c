"""The weight-only mode of the port's ``int8_matmul``: its launch plan, its
split oracle and the weight-only int8 ResNet against the JAX reference.

The same numpy inputs, made from seeds, go through the JAX function
(``int8_matmul_pallas`` in interpret mode and ``int8_matmul_ref``) and
the port's counterpart.  On the CPU the port's kernel entry point runs
its plain version, because the tensors lie on the CPU; the split oracle
``int8_matmul_wonly_split_ref`` sums in the CUDA kernel's order (f32
partials over the plan's ranges of K, added in split order).  Tolerances:

- the split oracle and the plain version against either JAX function:
  ``CARD_TOL``, the registered rtol (2e-2 at bf16, 1e-5 at f32) plus the
  same share of the row's RMS for outputs that cancel to near zero (the
  sums run in different orders);
- the weight-only ResNet-18 at f32 compute: 1e-4 of the largest JAX
  logit (cuDNN/oneDNN against XLA convolutions in f32 through 20 layers,
  as ``tests/test_torch_vision.py`` holds the float model).

The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, marked ``cuda``; ``chip_smoke.py`` phases
3 and 10-12 run it on the weight-only ResNet-50).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp

import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import registry as jreg
from paddle_tpu.quantization import convert_to_int8_inference as jax_convert
from paddle_tpu.vision.models import resnet18 as jax_resnet18

import chip_smoke
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.ops.kernels import int8_matmul as im
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.ops.kernels.int8_matmul import (
    CARD_TOL, int8_matmul, int8_matmul_wonly_split_ref, int8_wonly_plan)
from paddle_tpu_torch.quantization import convert_to_int8_inference
from paddle_tpu_torch.vision.models import resnet18

# the package re-exports functions under the module names
jim = importlib.import_module("paddle_tpu.ops.pallas.int8_matmul")

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _clean():
    registry.reset_counts()
    yield
    registry.reset_counts()
    jreg.set_mode("int8_matmul", None)


# ---------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------

def _check_wplan(p, M, N, K, dt, sms):
    """What the C entry checks of a plan, and what the plan promises."""
    bm = p.block_m
    # the least height that holds M, the largest past it (f32: up to 64)
    heights = (8, 16, 32, 64, 128) if dt == torch.bfloat16 else (8, 16, 32,
                                                                 64)
    assert bm == min([b for b in heights if b >= M] or [heights[-1]])
    assert p.route == ("fma_f32" if dt == torch.float32 else
                       "wgmma_bf16" if bm == 128 else "mma_bf16")
    chunks = -(-K // 64)
    assert (p.tiles_n, p.tiles_m) == (-(-N // 64), -(-M // bm))
    tiles = p.tiles_n * p.tiles_m
    # every split holds whole chunks and none is empty
    assert p.splits == -(-chunks // p.chunks_a_split)
    assert (p.splits - 1) * p.chunks_a_split < chunks
    bounds = p.k_bounds(K)
    assert len(bounds) == p.splits and bounds[0][0] == 0
    assert bounds[-1][1] == K
    assert all(a < b for a, b in bounds)
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
    # two blocks an SM at most where the tiles leave room, at most 8
    # splits (a cluster), else one split
    assert p.grid == tiles * p.splits
    assert 1 <= p.splits <= 8
    assert p.splits == 1 or p.grid <= 2 * sms
    if 2 * sms // tiles >= 2 and chunks > 1:
        assert p.splits > 1
    elt = dt.itemsize
    stages = 8 if bm <= 16 else 4
    assert p.stages == stages and p.threads == 128
    if p.route == "wgmma_bf16":
        # 80-byte weight rows, 128-byte swizzled x rows, 1,024 to align
        assert p.smem_bytes == 1024 + stages * (64 * 80 + bm * 128)
    else:
        assert p.smem_bytes == (stages * (64 * 64 + bm * (64 * elt + 16))
                                + (64 * 68 * 4 if elt == 4 and bm > 16
                                   else 0))
    assert p.smem_bytes <= 232_448
    assert p.launch() == (bm, p.splits, p.chunks_a_split, stages, 128,
                          p.smem_bytes, p.grid)


@pytest.mark.parametrize("M,dt,bm,tiles_m", [
    (1, "bfloat16", 8, 1), (32, "bfloat16", 32, 1), (128, "bfloat16", 128, 1),
    (1, "float32", 8, 1), (32, "float32", 32, 1), (128, "float32", 64, 2)])
def test_int8_wonly_plan_at_path_shapes(M, dt, bm, tiles_m):
    """The weight-only ResNet-50's classifier (K 2,048, N 1,000) at batch
    1, 32 and 128: 16 weight tiles (f32 at 128: two tiles of 64 rows of
    x), K in 8 splits of 4 chunks."""
    p = int8_wonly_plan(M, 1000, 2048, dt)
    assert (p.block_m, p.tiles_n, p.tiles_m) == (bm, 16, tiles_m)
    assert (p.splits, p.chunks_a_split, p.grid) == (8, 4, 128 * tiles_m)
    assert p.k_bounds(2048) == [(256 * s, 256 * s + 256) for s in range(8)]
    _check_wplan(p, M, 1000, 2048, _DT[dt], 132)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K,sms,want", [
    # past the tallest block: more tiles of x, fewer splits as tiles grow
    # ((tiles_m, splits, grid) at bf16, then at f32)
    (129, 1000, 2048, 132, ((2, 8, 256), (3, 5, 240))),
    (1024, 1000, 2048, 132, ((8, 2, 256), (16, 1, 256))),
    (16384, 1000, 2048, 132, ((128, 1, 2048), (256, 1, 4096))),
    # BERT-base's FFN at batch 128 x 128: one split
    (16384, 3072, 768, 132, ((128, 1, 6144), (256, 1, 12288))),
    # N not a multiple of 64; K not a multiple of 16 (two chunks)
    (5, 70, 100, 132, ((1, 2, 4),) * 2),
    (5, 33, 147, 132, ((1, 3, 3),) * 2),
    # K not a multiple of the split: 33 chunks in 7 splits of 5 (the last
    # 3), and K = 2,000 (32 chunks, the last 16 wide)
    (32, 1000, 2100, 132, ((1, 7, 112),) * 2),
    (32, 1000, 2000, 132, ((1, 8, 128),) * 2),
    # one SM: no split
    (1, 1000, 2048, 1, ((1, 1, 16),) * 2),
    (128, 1000, 2048, 1, ((1, 1, 16), (2, 1, 32))),
    # K of one chunk: no split whatever the SMs; at most 8 splits
    (1, 1000, 64, 132, ((1, 1, 16),) * 2),
    (1, 64, 4096, 132, ((1, 8, 8),) * 2)])
def test_int8_wonly_plan_edge_shapes(M, N, K, sms, want, dt):
    p = int8_wonly_plan(M, N, K, dt, sms)
    assert (p.tiles_m, p.splits, p.grid) == want[dt == "float32"]
    _check_wplan(p, M, N, K, _DT[dt], sms)


def test_int8_wonly_plan_refusals():
    for bad in ((0, 8, 8), (8, 0, 8), (8, 8, 0)):
        with pytest.raises(ValueError, match="int8_wonly_plan: M"):
            int8_wonly_plan(*bad, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        int8_wonly_plan(8, 8, 8, torch.float16)
    with pytest.raises(ValueError, match="sm_count 0"):
        int8_wonly_plan(8, 8, 8, torch.float32, 0)
    with pytest.raises(ValueError, match="blocks, over"):
        int8_wonly_plan(2 ** 40, 1 << 20, 8, torch.float32)


# ---------------------------------------------------------------------
# the split oracle and the plain version against the JAX package
# ---------------------------------------------------------------------

def _quantized_weight(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    sc = np.maximum(np.abs(w).max(0) / 127.0, 1e-9).astype(np.float32)
    return np.clip(np.round(w / sc), -127, 127).astype(np.int8), sc


def _within(got, want):
    want = torch.from_numpy(np.asarray(want, np.float32))
    _, share = registry.card_error(got, want, CARD_TOL[got.dtype])
    assert share <= 1.0, share


# (K, splits): K 256 in 2 and 4 splits of whole 64-wide chunks, K 320 and
# 300 in 3 (uneven: 2, 2 and 1 chunks; the last 44 wide at 300), K 512 in 8
_SPLITS = [(256, 2), (256, 4), (320, 3), (300, 3), (512, 8)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 32, 128])
@pytest.mark.parametrize("ks", _SPLITS, ids=[f"K{k}s{s}" for k, s in
                                             _SPLITS])
def test_split_oracle_matches_jax(ks, M, dt):
    K, splits = ks
    N = 200
    # a card whose SMs give the split (two blocks an SM): 4 weight tiles
    # at N = 200, 8 with two tiles of x (f32 at M = 128)
    tiles = 4 * int8_wonly_plan(M, N, K, dt).tiles_m
    plan = int8_wonly_plan(M, N, K, dt, sm_count=splits * tiles // 2)
    assert plan.splits == splits and plan.tiles_n * plan.tiles_m == tiles
    rng = np.random.default_rng(M + K + splits)
    qw, sc = _quantized_weight(rng, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jdt = jnp.dtype(dt)
    args = (torch.from_numpy(x), torch.from_numpy(qw.T.copy()),
            torch.from_numpy(sc))
    got = int8_matmul_wonly_split_ref(*args, compute_dtype=dt, plan=plan)
    plain = int8_matmul(*args, compute_dtype=dt)
    assert got.dtype == _DT[dt] and got.shape == (M, N)
    for want in (jim.int8_matmul_ref(jnp.asarray(x), jnp.asarray(qw),
                                     jnp.asarray(sc), compute_dtype=jdt),
                 jim.int8_matmul_pallas(jnp.asarray(x), jnp.asarray(qw),
                                        jnp.asarray(sc), compute_dtype=jdt,
                                        interpret=True)):
        _within(got, want)
        _within(plain, want)
    _within(got, plain.float().numpy())
    # the partials, added in split order, are the oracle's sum
    w = args[1].to(_DT[dt]) * args[2].to(_DT[dt])[:, None]
    xs = args[0].to(_DT[dt])
    acc = None
    for k0, k1 in plan.k_bounds(K):
        part = xs[:, k0:k1].float() @ w[:, k0:k1].float().t()
        acc = part if acc is None else acc + part
    assert torch.equal(got, acc.to(_DT[dt]))


def test_split_oracle_defaults_to_the_h100_plan():
    """Without a plan the oracle splits as the kernel does on an H100,
    with leading batch dims collapsed to rows."""
    rng = np.random.default_rng(3)
    qw, sc = _quantized_weight(rng, 2048, 1000)
    x = torch.from_numpy(rng.standard_normal((2, 16, 2048)).astype(
        np.float32))
    w, s = torch.from_numpy(qw.T.copy()), torch.from_numpy(sc)
    got = int8_matmul_wonly_split_ref(x, w, s, "float32")
    plan = int8_wonly_plan(32, 1000, 2048, torch.float32)
    want = int8_matmul_wonly_split_ref(x.reshape(32, 2048), w, s,
                                       "float32", plan=plan)
    assert got.shape == (2, 16, 1000) and plan.splits == 8
    assert torch.equal(got.reshape(32, 1000), want)


def test_float_rows_copy_only_what_the_kernel_cannot_read():
    """x rows for the kernel start on 16 bytes and lie a multiple of 16
    bytes apart (the kernel reads them in 16-byte copies)."""
    x = torch.randn(6, 40)
    assert im._float_rows(x) is x                            # 160-byte rows
    xb = torch.randn(6, 36).to(torch.bfloat16)               # 72-byte rows
    rows = im._float_rows(xb)
    assert torch.equal(rows, xb) and rows.stride() == (40, 1)
    xt = torch.randn(40, 6).t()                              # column-major
    rows = im._float_rows(xt)
    assert torch.equal(rows, xt) and rows.stride() == (40, 1)
    one = torch.randn(1, 37)                                 # one row
    assert im._float_rows(one) is one


# ---------------------------------------------------------------------
# the slice: weight-only int8 ResNet-18 against the JAX model
# ---------------------------------------------------------------------

def _jax_arrays(jm):
    return {k: np.array(v._value, np.float32) if v._value.dtype != jnp.int8
            else np.array(v._value) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def wonly_pair():
    """The JAX resnet18(num_classes=10) and the port's, both converted with
    act_quant=None at f32 compute, the port's weights carried across."""
    paddle.seed(0)
    jm = jax_resnet18(num_classes=10)
    # running statistics that are not the identity
    rng = np.random.default_rng(100)
    for name, t in jm.state_dict().items():
        if name.endswith("_mean"):
            t._value = jnp.asarray(rng.normal(0, 0.2, t._value.shape),
                                   jnp.float32)
        elif name.endswith("_variance"):
            t._value = jnp.asarray(rng.uniform(0.5, 2.0, t._value.shape),
                                   jnp.float32)
    jm.eval()
    jax_convert(jm, compute_dtype=jnp.float32, act_quant=None)
    tm = convert_to_int8_inference(resnet18(num_classes=10, device="cpu"),
                                   compute_dtype=torch.float32,
                                   act_quant=None)
    load_jax_state_dict(tm, _jax_arrays(jm))
    x = np.random.default_rng(6).standard_normal((4, 3, 32, 32)).astype(
        np.float32)
    return jm, tm, x


@pytest.mark.parametrize("mode", ["xla_ref", "interpret"])
def test_weight_only_resnet18_matches_jax(wonly_pair, mode):
    jm, tm, x = wonly_pair
    jreg.set_mode("int8_matmul", mode)
    try:
        with paddle.no_grad():
            want = np.asarray(jm(paddle.to_tensor(x))._value).astype(
                np.float32)
    finally:
        jreg.set_mode("int8_matmul", None)
    registry.reset_counts()
    with torch.no_grad(), chip_smoke.recorded_int8_shapes() as shapes:
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # one weight-only call a forward (the classifier); the 20 convolutions
    # dequantise and convolve
    assert dict(shapes) == {(4, 512, 10, torch.float32, False): 1}
    s = registry.spec("int8_matmul")
    assert (s.torch_ref_calls, s.launches) == (1, 0)


def test_weight_only_resnet18_carries_int8_codes(wonly_pair):
    jm, tm, _ = wonly_pair
    st = tm.state_dict()
    assert st["fc.qweight"].dtype == torch.int8
    assert tuple(st["fc.qweight"].shape) == (512, 10)
    assert st["layer4.1.conv2.w_scale"].dtype == torch.float32
    for k, a in _jax_arrays(jm).items():
        np.testing.assert_array_equal(st[k].numpy(), a, err_msg=k)
    assert tm.fc.weight_rows().shape == (10, 512)
