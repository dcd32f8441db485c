"""The fused 1x1-conv + BN-statistics kernel's plain version against the
reference's Pallas kernel, and the routing rules of its wrapper.

The reference, ``tools/exp_conv_bn_kernel.py``, is imported from its file
and run in Pallas interpret mode (``pl.pallas_call`` with
``interpret=True`` for the length of the test; nothing in ``tools/``
changes).  The same seeded bf16 inputs go to both.  Tolerances, each with
its reason:

- ``y``: within one bf16 step (2^-7 of |y|): both round an f32
  accumulator once, and the two accumulators differ only by the order of
  their K additions, so a rounding may land one step apart;
- ``s1``: within 1e-5 of each column's sum of |acc| (a sum that may
  cancel, taken in two orders); ``s2``: relative 1e-5.

The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3, 26 and 27).
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental import pallas as pl

import torch

from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.ops.kernels.conv_bn_stats import (
    BLOCK_ROWS, CARD_TOL, fused_matmul_bn_stats, fused_matmul_bn_stats_ref)

_REF = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "exp_conv_bn_kernel.py"


@pytest.fixture(scope="module")
def ref_mod():
    spec = importlib.util.spec_from_file_location("_exp_conv_bn_ref", _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _counts():
    registry.reset_counts()
    yield
    registry.reset_counts()


def _inputs(M, K, N, seed=0):
    """Seeded inputs rounded to bf16 once, as numpy f32 and as the bf16
    tensors and arrays each package takes."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(M, K), jnp.bfloat16)
    w = jnp.asarray(rng.randn(K, N) * 0.05, jnp.bfloat16)
    xf = np.asarray(x.astype(jnp.float32))
    wf = np.asarray(w.astype(jnp.float32))
    return (x, w), (torch.from_numpy(xf.copy()).bfloat16(),
                    torch.from_numpy(wf.copy()).bfloat16()), xf, wf


def _assert_stats(got, want, xf, wf):
    y, s1, s2 = (np.asarray(jnp.asarray(v).astype(jnp.float32))
                 if not isinstance(v, torch.Tensor) else v.float().numpy()
                 for v in got)
    ry, r1, r2 = want
    # one bf16 step: 2^-7 of |y| bounds the spacing at y
    assert np.all(np.abs(y - ry) <= 2.0 ** -7 * np.abs(ry)), \
        np.abs(y - ry).max()
    abs_acc = np.abs(xf.astype(np.float64) @ wf.astype(np.float64)).sum(0)
    assert np.all(np.abs(s1 - r1) <= CARD_TOL["s1"] * abs_acc)
    np.testing.assert_allclose(s2, r2, rtol=CARD_TOL["s2"])


def test_plain_version_matches_pallas_kernel(monkeypatch, ref_mod):
    """M 1024, K 64, N 256 with the reference's tiles bm 256, bn 128, in
    interpret mode; then the same against its XLA baseline."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    (jx, jw), (tx, tw), xf, wf = _inputs(1024, 64, 256)
    jy, js1, js2 = ref_mod.fused_matmul_bn_stats(jx, jw, bm=256, bn=128)
    ref = tuple(np.asarray(jnp.asarray(v).astype(jnp.float32))
                for v in (jy, js1, js2))
    got = fused_matmul_bn_stats(tx, tw)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (1024, 256)
    assert got[1].dtype == torch.float32 and got[1].shape == (256,)
    _assert_stats(got, ref, xf, wf)
    s = registry.spec("conv_bn_stats")
    assert (s.launches, s.torch_ref_calls) == (0, 1)
    # the XLA baseline reads y back: its stats are of the rounded y, so
    # only y is held to the same bound there
    by, _, _ = ref_mod.xla_matmul_then_stats(jx, jw)
    by = np.asarray(by.astype(jnp.float32))
    assert np.all(np.abs(got[0].float().numpy() - by)
                  <= 2.0 ** -7 * np.abs(by))


@pytest.mark.parametrize("shape", [(1, 8, 8), (300, 24, 40), (129, 72, 136)])
def test_plain_version_ragged_shapes(shape):
    """Shapes the kernel's tiles do not divide (M tails, N 8) against an
    f64 product: the plain version is the kernel's oracle there."""
    M, K, N = shape
    _, (tx, tw), xf, wf = _inputs(M, K, N, seed=M)
    acc = xf.astype(np.float64) @ wf.astype(np.float64)
    ref = (torch.from_numpy(acc).float().bfloat16().float().numpy(),
           acc.sum(0), (acc * acc).sum(0))
    _assert_stats(fused_matmul_bn_stats(tx, tw), ref, xf, wf)
    y, s1, s2 = fused_matmul_bn_stats_ref(tx, tw)
    assert s1.shape == s2.shape == (N,) and y.shape == (M, N)


@pytest.mark.parametrize("bad, reason", [
    (lambda x, w: (x.float(), w.float()), "bfloat16"),
    (lambda x, w: (x[:, :60].contiguous(), w[:60].contiguous()),
     "multiples of 8"),
    (lambda x, w: (x, w[:, :20].contiguous()), "multiples of 8"),
    (lambda x, w: (x.t().contiguous().t(), w), "contiguous"),
    (lambda x, w: (x, w[:32]), r"\[M, K\] and \[K, N\]"),
    (lambda x, w: (x, w), "CUDA tensors"),
])
def test_kernel_route_refuses_what_it_cannot_take(bad, reason):
    """The CUDA route's argument check names the reason, reachable
    without a card by asking for the route explicitly; no plain version
    runs in its place."""
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=reason):
        fused_matmul_bn_stats(*bad(x, w), mode="cuda")
    s = registry.spec("conv_bn_stats")
    assert (s.launches, s.torch_ref_calls) == (0, 0)


def test_registration_and_device_defaults():
    """Registered with its TPU kernel; CPU tensors take the plain
    version; the A/B entry point raises without a card."""
    s = registry.spec("conv_bn_stats")
    assert s.replaces == "tools/exp_conv_bn_kernel.py:30"
    assert s.source.endswith("csrc/conv_bn_stats.cu")
    assert "bf16" in s.tolerance and BLOCK_ROWS == 128
    x = torch.ones(3, 8, dtype=torch.bfloat16)
    y, s1, s2 = fused_matmul_bn_stats(x, torch.ones(8, 16,
                                                    dtype=torch.bfloat16))
    assert torch.equal(y.float(), torch.full((3, 16), 8.0))
    assert torch.equal(s1, torch.full((16,), 24.0))
    assert torch.equal(s2, torch.full((16,), 192.0))
    assert (s.launches, s.torch_ref_calls) == (0, 1)
    from paddle_tpu_torch.tools import exp_conv_bn_kernel as ab
    assert ab.SHAPES[0] == (802_816, 256, 64) and len(ab.SHAPES) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            ab.main()
        with pytest.raises(RuntimeError, match="CUDA card"):
            ab.bench_one(256, 64, 64)


def test_matmul_then_stats_is_the_reference_baseline(ref_mod):
    """The A/B's yardstick computes what ``xla_matmul_then_stats`` does:
    y from the product, then the stats of the rounded y."""
    from paddle_tpu_torch.tools.exp_conv_bn_kernel import matmul_then_stats
    (jx, jw), (tx, tw), _, _ = _inputs(256, 64, 128, seed=3)
    jy, j1, j2 = ref_mod.xla_matmul_then_stats(jx, jw)
    ty, t1, t2 = matmul_then_stats(tx, tw)
    jyf = np.asarray(jy.astype(jnp.float32))
    assert np.all(np.abs(ty.float().numpy() - jyf) <= 2.0 ** -7 * np.abs(jyf))
    # a y one bf16 step apart moves its column's sum by at most 2^-7 |y|
    # and its square by at most 2^-6 y^2 (plus f32 sums in two orders)
    assert np.all(np.abs(t1.numpy() - np.asarray(j1))
                  <= 2.0 ** -7 * np.abs(jyf).sum(0) + 1e-5)
    assert np.all(np.abs(t2.numpy() - np.asarray(j2))
                  <= 2.0 ** -6 * (jyf * jyf).sum(0) + 1e-5)
