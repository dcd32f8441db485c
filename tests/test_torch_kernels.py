"""The PyTorch port's kernels against the JAX reference, plus the
port's package rules.

The same numpy inputs, made from a seed, go through the JAX function
(Pallas kernels in interpret mode, or their XLA references) and the
port's counterpart.  On the CPU the port's kernel entry points run their
plain versions -- routed there because the tensors lie on the CPU -- so
these tests hold the plain versions to the reference at the registered
tolerances:

- flash attention forward: atol 1e-4;
- flash attention backward (dq, dk, dv through the autograd Function,
  against ``jax.grad`` of the Pallas kernels in interpret mode): f32
  atol 1e-4; bf16 as stated at each test;
- int8 paged attention: atol 2e-5 / rtol 1e-4;
- segment sum: atol 1e-6 for float gradients, bitwise for integer ones;
- int8 row dequantisation: bitwise;
- fused optimizer apply: bitwise against the reference's numpy host
  engine; against the JAX ``opt_apply_ref`` and the Pallas kernel in
  interpret mode within the error of one FMA contraction per
  multiply-add (XLA on the CPU contracts them; see ``_fma_bounds``).

The hand-written CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, marked ``cuda``; ``chip_smoke.py`` runs
the same comparison at the serving shapes).
"""
import ast
import contextlib
import importlib
import itertools
import math
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from paddle_tpu.nn.functional.attention import _sdpa_ref as jax_sdpa_ref
from paddle_tpu.distributed.fleet import elastic as jelastic
from paddle_tpu.distributed.fleet import ps as jps
from paddle_tpu.ops.pallas import registry as jreg

from paddle_tpu_torch.nn.functional import _sdpa_ref
from paddle_tpu_torch.ops.kernels import _build, registry
from paddle_tpu_torch.ops.kernels.flash_attention import (
    CARD_TOL_BWD, _bwd_dkv_cuda, _bwd_dq_cuda, _flash_fwd_cuda, _rowmajor,
    attention_delta, flash_attention, flash_attention_bhsd,
    flash_attention_blockwise_ref, flash_attention_bwd_blockwise_ref,
    flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
    flash_attention_ref, flash_bwd_plan, flash_eligible, flash_fwd_plan)
from paddle_tpu_torch.ops.kernels.kv_attention import (
    int8_paged_attention, paged_attention_ref)
from paddle_tpu_torch.ops.kernels.opt_apply import (
    KINDS, SLOTS, opt_apply, opt_apply_ref, pack_hyper)
from paddle_tpu_torch.ops.kernels.pull_dequant import pull_dequant
from paddle_tpu_torch.ops.kernels.segment_sum import (
    hard_segment_cases, segment_plan, segment_sum, segment_sum_planned,
    segment_sum_sorted, segment_sum_sorted_planned, segment_tile_plan)

# the package re-exports functions under the module names
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jkv = importlib.import_module("paddle_tpu.ops.pallas.kv_attention")
jss = importlib.import_module("paddle_tpu.ops.pallas.segment_sum")
jpd = importlib.import_module("paddle_tpu.ops.pallas.pull_dequant")
jopt = importlib.import_module("paddle_tpu.ops.pallas.opt_apply")

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_counts():
    registry.reset_counts()
    yield
    registry.reset_counts()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------
# kernel 1: flash attention forward
# ---------------------------------------------------------------------

def _qkv(seed, B=1, H=2, S=256, D=64, Hkv=None):
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    return _rand(rng, B, H, S, D), _rand(rng, B, Hkv, S, D), \
        _rand(rng, B, Hkv, S, D)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_kernel_interpret(causal):
    q, k, v = _qkv(0)
    ref = jfa.flash_attention_bhsd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True, block_q=64, block_k=64)
    got = flash_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    assert registry.spec("flash_attention").torch_ref_calls == 1
    assert registry.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_ref_chunked(causal):
    q, k, v = _qkv(1, S=300)       # ragged against every block size
    sc = 1.0 / math.sqrt(q.shape[-1])
    ref = jfa._ref_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None, causal, sc)
    got = flash_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               scale=sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_flash_lse_matches_jax_kernel():
    q, k, v = _qkv(2, S=128)
    sc = 1.0 / math.sqrt(q.shape[-1])
    o_ref, lse_ref = jfa._pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True, sc,
        64, 64, True, with_lse=True)
    o, lse = flash_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_blockwise_plain_matches_chunked_in_f32(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, H=4, Hkv=2, S=200))
    got = flash_attention_blockwise_ref(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_blockwise_plain_matches_jax_kernel_in_bf16(causal, block_k):
    """The plain version the bf16 kernel is held to on the card rounds P
    to bf16 as the Pallas kernel does (``block_k``-key blocks, running
    max): 64 keys for the mma.sync kernel, 128 for the Hopper kernel of
    head_dim 128."""
    q, k, v = _qkv(7, S=256)
    ref = jfa.flash_attention_bhsd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        interpret=True, block_q=64, block_k=block_k)
    got = flash_attention_blockwise_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal,
        block_k=block_k)
    assert got.dtype == torch.bfloat16
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    # one rounding of the bf16 output apart
    err, share = registry.card_error(got, ref, (1e-5, 8e-3, 0.0))
    assert share <= 1.0, err
    # the chunked f32 version differs by the rounding of P, far more
    chunked = flash_attention_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal)
    assert (chunked.float() - ref).abs().max() > 2 * err


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_flash_plan_bhsd_takes_the_hopper_route():
    q = _bf16(2, 8, 2048, 128)
    plan = flash_fwd_plan(q, q, q)
    assert plan.route == "tma_wgmma"
    assert (plan.block_q, plan.block_k, plan.stages, plan.threads) == \
        (128, 128, 2, 384)
    # Q, two stages of K and V, the O staging tile, alignment slack and
    # 10 mbarriers fit a block's 227 KB
    assert plan.smem_bytes == 1024 + 6 * 32768 + 80 <= 232448
    # 256 work items over at most one block per SM (132 on an H100)
    assert plan.grid == (132, 1, 1)
    # (seq, head, batch) byte strides of q, k and v, then of the output
    # the wrapper allocates as (B, S, H, D)
    assert plan.tma_strides == (256, 2048 * 256, 8 * 2048 * 256) * 3 + (
        8 * 256, 256, 2048 * 8 * 256)
    assert plan.as_is == {"q": True, "k": True, "v": True}


def test_flash_plan_server_bshd_views_need_no_copy():
    """The server's batched prefill passes (B, S, H, D) tensors through
    ``flash_attention``: the kernel gets strided head views, and the
    tensor maps take their strides as they are."""
    B, S, H, D = 4, 1024, 32, 128
    q = _bf16(B, S, H, D).transpose(1, 2)
    plan = flash_fwd_plan(q, q, q)
    assert plan.route == "tma_wgmma"
    assert plan.tma_strides[:3] == (H * D * 2, D * 2, S * H * D * 2)
    assert all(plan.as_is.values())
    assert _rowmajor(q) is q
    assert plan.grid == (132, 1, 1)


def test_flash_plan_gqa_and_ragged():
    q, kv = _bf16(1, 8, 777, 128), _bf16(1, 2, 777, 128)
    plan = flash_fwd_plan(q, kv, kv)
    assert plan.route == "tma_wgmma"
    # 7 query tiles (ceil(777 / 128)) x 8 heads: a block each
    assert plan.grid == (56, 1, 1)
    # k and v have their own head count and strides; a batch of one
    # gets the span of the whole tensor as its (never stepped) stride
    assert plan.tma_strides[3:6] == (256, 777 * 256, 2 * 777 * 256)


@pytest.mark.parametrize("dtype,D,route,tile", [
    (torch.bfloat16, 64, "mma_sync", 64),
    (torch.bfloat16, 256, "mma_sync", 64),
    (torch.float32, 128, "fma", 32)])
def test_flash_plan_other_routes_keep_the_first_kernel(dtype, D, route,
                                                       tile):
    q = torch.zeros(1, 2, 300, D, dtype=dtype)
    plan = flash_fwd_plan(q, q, q)
    assert (plan.route, plan.block_q, plan.block_k) == (route, tile, tile)
    assert plan.grid == (-(-300 // tile), 2, 1) and plan.tma_strides == ()


class _FakeFn:
    def __init__(self, calls, name):
        self.calls, self.name, self.argtypes = calls, name, None

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _FakeLib:
    def __init__(self):
        self.calls = []
        self.flash_attention_fwd = _FakeFn(self.calls, "flash_attention_fwd")
        self.flash_attention_fwd_sm90 = _FakeFn(self.calls,
                                                "flash_attention_fwd_sm90")
        for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv_sm90",
                     "flash_attention_bwd_dq_sm90"):
            setattr(self, name, _FakeFn(self.calls, name))
        self.segment_sum_f32 = _FakeFn(self.calls, "segment_sum_f32")
        self.segment_sum_sorted_f32 = _FakeFn(self.calls,
                                              "segment_sum_sorted_f32")


@pytest.fixture
def fake_flash_lib(monkeypatch):
    """The wrapper's launch with the CUDA library replaced by a recorder:
    which C entry point it calls, and with what."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bhsd", "bshd", "sliced", "gqa"])
def test_flash_bf16_d128_never_routes_to_the_first_kernel(fake_flash_lib,
                                                          layout, causal):
    B, H, S, D = 2, 4, 300, 128
    if layout == "bshd":
        q = k = v = _bf16(B, S, H, D).transpose(1, 2)
    elif layout == "sliced":
        # a sequence window one row in: rows start 256 bytes in, fine
        q = k = v = _bf16(B, H, S + 1, D)[:, :, 1:]
    elif layout == "gqa":
        q, k, v = _bf16(B, H, S, D), _bf16(B, 2, S, D), _bf16(B, 2, S, D)
    else:
        q = k = v = _bf16(B, H, S, D)
    o, lse = _flash_fwd_cuda(q, k, v, causal=causal, return_lse=True)
    ((name, args),) = fake_flash_lib.calls
    assert name == "flash_attention_fwd_sm90"
    plan = flash_fwd_plan(q, k, v)
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[5:10] == (B, H, k.shape[1], S, S)
    assert tuple(args[10]) == plan.tma_strides
    # the output's tensor-map strides are those of the tensor returned
    elt = o.element_size()
    assert plan.tma_strides[9:] == (o.stride(2) * elt, o.stride(1) * elt,
                                    o.stride(0) * elt)
    assert tuple(args[11]) == (128, 128, 2, 384, plan.smem_bytes) + plan.grid
    assert args[12] == int(causal)
    assert o.shape == (B, H, S, D) and lse.shape == (B, H, S)
    assert registry.launch_counts()["flash_attention"] == 1


def test_flash_stride_tma_cannot_take_is_copied_not_rerouted(fake_flash_lib):
    """A head view whose rows are 8 bytes off 16-byte alignment, and a
    tensor strided on D: both are made row-major by ``_rowmajor`` and
    still launch the Hopper kernel."""
    base = _bf16(1, 2, 200, 132)
    odd = base[..., 4:]                 # rows start 8 bytes in
    strided = _bf16(1, 2, 200, 256)[..., ::2]
    for t in (odd, strided):
        assert not flash_fwd_plan(t, t, t).as_is["q"]
        fixed = _rowmajor(t)
        assert fixed is not t and fixed.is_contiguous()
        assert flash_fwd_plan(fixed, fixed, fixed).as_is["q"]
        fake_flash_lib.calls.clear()
        _flash_fwd_cuda(t, t, t, causal=False)
        ((name, args),) = fake_flash_lib.calls
        assert name == "flash_attention_fwd_sm90"
        assert args[0] != t.data_ptr()          # the row-major copy
        assert tuple(args[10])[:3] == (256, 200 * 256, 2 * 200 * 256)


def test_flash_first_kernel_takes_bf16_d64(fake_flash_lib):
    q = _bf16(1, 2, 300, 64)
    _flash_fwd_cuda(q, q, q, causal=True)
    ((name, args),) = fake_flash_lib.calls
    assert name == "flash_attention_fwd" and args[10] == 64


# ---------------------------------------------------------------------
# kernels 2 and 3: the backward's launch plan and launchers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype,D,route,dkv_rows,dq_rows,streamed", [
    (torch.bfloat16, 128, "tma_wgmma", 128, 128, 64),
    (torch.bfloat16, 64, "mma_sync", 64, 64, 64),
    (torch.bfloat16, 256, "mma_sync", 32, 64, 64),
    (torch.float32, 128, "fma", 32, 32, 32)])
def test_flash_bwd_plan_route_by_dtype_and_head_dim(dtype, D, route,
                                                    dkv_rows, dq_rows,
                                                    streamed):
    """bf16 at head_dim 128 takes the Hopper kernels (128 resident rows
    an item, 64-row streamed tiles, persistent blocks); the other dtypes
    and head dims keep the first kernels' tiles and one block an item."""
    q = torch.zeros(1, 2, 300, D, dtype=dtype)
    plan = flash_bwd_plan(q, q, q, q, causal=True)
    assert plan.route == route
    assert (plan.dkv.block_res, plan.dq.block_res) == (dkv_rows, dq_rows)
    assert plan.dkv.block_str == plan.dq.block_str == streamed
    if route == "tma_wgmma":
        for kp in (plan.dkv, plan.dq):
            assert (kp.stages, kp.threads) == (2, 384)
            # two buffers of the resident pair, two stages of the streamed
            # pair, LSE/delta rows, 8 mbarriers, alignment slack: within a
            # block's 227 KB
            assert kp.smem_bytes == (1024 + 4 * 32768 + 4 * 16384 + 2048
                                     + 64) <= 232448
            assert kp.grid == (kp.items, 1, 1) == (3 * 2, 1, 1)
    else:
        assert plan.dkv.tma_strides == plan.dq.tma_strides == ()
        assert plan.dkv.grid == (-(-300 // dkv_rows), 2, 1)
        assert plan.dq.grid == (-(-300 // dq_rows), 2, 1)


@pytest.mark.parametrize("B,H,S,grid", [(4, 16, 2048, 132), (1, 1, 100, 1),
                                        (1, 8, 4096, 132), (2, 4, 1000, 64)])
def test_flash_bwd_plan_grid_is_at_most_the_sm_count(B, H, S, grid):
    """One persistent block per SM at most (132 on an H100, the count
    used where no card is at hand); fewer only where the items are
    fewer."""
    q = _bf16(B, H, S, 128)
    plan = flash_bwd_plan(q, q, q, q, causal=True)
    items = -(-S // 128) * H * B
    for kp in (plan.dkv, plan.dq):
        assert kp.items == items
        assert kp.grid == (min(items, 132), 1, 1) == (grid, 1, 1)


@pytest.mark.parametrize("H,Hkv,S,causal,dkv_tiles,dq_tiles", [
    # the proxy: 16 key (query) tiles of 128 a head; causal, key tile t
    # streams query tiles 2t..31, query tile t key tiles 0..2t+1
    (16, 16, 2048, True, 272 * 64, 272 * 64),
    (16, 16, 2048, False, 16 * 32 * 64, 16 * 32 * 64),
    # GQA 8 / 2, ragged: dK/dV streams the 4 query heads of its group
    (8, 2, 777, True, (13 + 11 + 9 + 7 + 5 + 3 + 1) * 4 * 2,
     (2 + 4 + 6 + 8 + 10 + 12 + 13) * 8),
    (8, 2, 777, False, 7 * 13 * 4 * 2, 7 * 13 * 8)])
def test_flash_bwd_plan_counts_items_and_streamed_tiles(H, Hkv, S, causal,
                                                        dkv_tiles,
                                                        dq_tiles):
    B = 4 if S == 2048 else 1
    q, kv = _bf16(B, H, S, 128), _bf16(B, Hkv, S, 128)
    plan = flash_bwd_plan(q, kv, kv, q, causal=causal)
    n_rt = -(-S // 128)
    assert plan.dkv.items == n_rt * Hkv * B
    assert plan.dq.items == n_rt * H * B
    assert (plan.dkv.tiles, plan.dq.tiles) == (dkv_tiles, dq_tiles)


def test_flash_bwd_plan_takes_bshd_views_and_names_the_outputs():
    """The model's (B, S, H, D) tensors reach the backward as head views:
    the tensor maps take their strides as they are, and the outputs'
    strides are those of the (B, S, heads, D) tensors the wrappers
    allocate."""
    B, S, H, Hkv, D = 2, 1000, 8, 2, 128
    q = _bf16(B, S, H, D).transpose(1, 2)
    kv = _bf16(B, S, Hkv, D).transpose(1, 2)
    plan = flash_bwd_plan(q, kv, kv, q)
    assert plan.as_is == {"q": True, "k": True, "v": True, "do": True}
    qs = (H * D * 2, D * 2, S * H * D * 2)
    ks = (Hkv * D * 2, D * 2, S * Hkv * D * 2)
    assert plan.dkv.tma_strides == qs + ks + ks + qs + ks + ks
    assert plan.dq.tma_strides == qs + ks + ks + qs + qs
    odd = _bf16(B, H, S, 132)[..., 4:]          # rows 8 bytes off
    assert not flash_bwd_plan(odd, kv, kv, q).as_is["q"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bshd", "gqa", "odd"])
def test_flash_bwd_bf16_d128_launches_the_sm90_entries(fake_flash_lib,
                                                      layout, causal):
    B, H, S, D = 2, 4, 300, 128
    if layout == "bshd":
        q = k = v = do = _bf16(B, S, H, D).transpose(1, 2)
    elif layout == "gqa":
        q, do = _bf16(B, H, S, D), _bf16(B, H, S, D)
        k = v = _bf16(B, 2, S, D)
    else:
        # a view TMA cannot take: copied row-major, still the sm90 entry
        q = k = v = do = _bf16(B, H, S, 132)[..., 4:]
    lse = delta = torch.zeros(B, H, S)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    dq = _bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal)
    (n1, a1), (n2, a2) = fake_flash_lib.calls
    assert (n1, n2) == ("flash_attention_bwd_dkv_sm90",
                        "flash_attention_bwd_dq_sm90")
    rm = [_rowmajor(t) for t in (q, k, v, do)]
    plan = flash_bwd_plan(*rm, causal=causal)
    for args, kp, outs in ((a1, plan.dkv, (dk, dv)), (a2, plan.dq, (dq,))):
        n = 6 + len(outs)
        assert args[4:n] == tuple(t.data_ptr() for t in
                                  (lse, delta, *outs))
        if layout == "odd":             # the wrapper's own row-major copy
            assert args[0] != q.data_ptr()
        else:
            assert args[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
        assert args[n:n + 5] == (B, H, k.shape[1], S, S)
        assert tuple(args[n + 5]) == kp.tma_strides
        assert tuple(args[n + 6]) == (128, 64, 2, 384, kp.smem_bytes,
                                      *kp.grid)
        assert args[n + 7] == int(causal)
        # the outputs' tensor-map strides are those of the tensors
        # returned
        for i, o in enumerate(outs):
            assert kp.tma_strides[12 + 3 * i:15 + 3 * i] == tuple(
                o.stride(j) * 2 for j in (2, 1, 0))
    assert dk.shape == k.shape and dq.shape == q.shape
    assert registry.launch_counts()["flash_attention_bwd_dkv"] == 1
    assert registry.launch_counts()["flash_attention_bwd_dq"] == 1


def test_flash_bwd_other_routes_launch_the_first_kernels(fake_flash_lib):
    for dtype, D in ((torch.bfloat16, 64), (torch.float32, 128)):
        fake_flash_lib.calls.clear()
        q = torch.zeros(1, 2, 300, D, dtype=dtype)
        lse = torch.zeros(1, 2, 300)
        _bwd_dkv_cuda(q, q, q, q, lse, lse, causal=True)
        _bwd_dq_cuda(q, q, q, q, lse, lse, causal=True)
        (n1, a1), (n2, a2) = fake_flash_lib.calls
        assert (n1, n2) == ("flash_attention_bwd_dkv",
                            "flash_attention_bwd_dq")
        # B, H, Hkv, Sq, Sk, D after the 8 (dK/dV) or 7 (dQ) pointers
        assert a1[8:14] == a2[7:13] == (1, 2, 2, 300, 300, D)
        assert a1[-2] == a2[-2] == int(dtype == torch.bfloat16)


def test_flash_gqa_indexes_kv_head_like_repeat():
    q, k, v = _qkv(3, H=4, Hkv=2, S=64)
    rep = lambda a: jnp.repeat(jnp.asarray(a), 2, axis=1)  # noqa: E731
    ref = jfa.flash_attention_bhsd(jnp.asarray(q), rep(k), rep(v),
                                   causal=True, interpret=True,
                                   block_q=64, block_k=64)
    got = flash_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_flash_paddle_layout_entry():
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _qkv(4, S=64))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, interpret=True,
                              block_q=64, block_k=64)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


# ---------------------------------------------------------------------
# kernels 2 and 3: flash attention backward (dK/dV and dQ)
# ---------------------------------------------------------------------

def _jax_grads(q, k, v, g, causal, dtype):
    """dq, dk, dv of the Pallas kernels in interpret mode (64-row blocks:
    ``_pallas_backward`` runs both backward kernels), as f32 numpy."""
    def loss(q_, k_, v_):
        o = jfa.flash_attention_bhsd(q_, k_, v_, causal=causal,
                                     interpret=True, block_q=64, block_k=64)
        return (o.astype(jnp.float32) * jnp.asarray(g)).sum()
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return [np.array(x.astype(jnp.float32))
            for x in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, g, causal, dtype, mode=None):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = flash_attention_bhsd(*ts, causal=causal, mode=mode)
    return [x.float().numpy() for x in torch.autograd.grad(
        o, ts, torch.from_numpy(g).to(dtype))]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_plain_match_jax_kernels_interpret_f32(causal):
    q, k, v = _qkv(20, H=2, S=256)
    g = _qkv(21, H=2, S=256)[0]
    ref = _jax_grads(q, k, v, g, causal, jnp.float32)
    got = _port_grads(q, k, v, g, causal, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        # both are exact f32 FlashAttention-2 math in another order
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=name)
    assert registry.spec("flash_attention_bwd_dkv").torch_ref_calls == 1
    assert registry.spec("flash_attention_bwd_dq").torch_ref_calls == 1
    assert registry.launch_counts()["flash_attention_bwd_dkv"] == 0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_plain_match_jax_kernels_interpret_bf16(causal):
    """The registered plain versions keep P and dS in f32 where the
    Pallas kernels round them to bf16 (and round P in the forward that
    makes o and delta): the two differ by those roundings, a few bf16
    steps of a gradient's row scale.  They are held to the bf16 backward
    kernels' card limit ``CARD_TOL_BWD`` (one output rounding, 2 % of the
    row's RMS, 1e-3 of the whole output's RMS); measured, the worst
    element uses about half of it."""
    q, k, v = _qkv(22, H=2, S=256)
    g = _qkv(23, H=2, S=256)[0]
    ref = _jax_grads(q, k, v, g, causal, jnp.bfloat16)
    got = _port_grads(q, k, v, g, causal, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, share = registry.card_error(torch.from_numpy(a),
                                         torch.from_numpy(b),
                                         CARD_TOL_BWD[torch.bfloat16])
        assert share <= 1.0, (name, err, share)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_blockwise_plain_matches_jax_kernels_in_bf16(causal):
    """The plain version the bf16 backward kernels are held to on the card
    rounds P and dS to bf16 as the Pallas kernels do: fed the same q, k,
    v, o, lse and dO it matches ``_pallas_backward`` (interpret mode)
    within the bf16 card limit, and much closer than the unrounded plain
    versions do."""
    q, k, v = _qkv(24, H=2, S=256)
    g = _qkv(25, H=2, S=256)[0]
    sc = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    o, lse = jfa._pallas_forward(jq, jk, jv, None, causal, sc, 64, 64, True,
                                 with_lse=True)
    ref = jfa._pallas_backward(jq, jk, jv, o, lse, jg, causal, sc, 64, 64,
                               True)
    T = lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x.astype(jnp.float32)))
    tq, tk, tv, tg, to = (T(x).bfloat16() for x in (jq, jk, jv, jg, o))
    tl = T(lse)[..., 0]
    delta = attention_delta(to, tg)
    got = flash_attention_bwd_blockwise_ref(tq, tk, tv, tg, tl, delta,
                                            causal=causal)
    unrounded = (flash_attention_bwd_dq_ref(tq, tk, tv, tg, tl, delta,
                                            causal=causal),
                 *flash_attention_bwd_dkv_ref(tq, tk, tv, tg, tl, delta,
                                              causal=causal))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, unrounded):
        assert a.dtype == torch.bfloat16
        r = T(b)
        err, share = registry.card_error(a, r, CARD_TOL_BWD[torch.bfloat16])
        assert share <= 1.0, (name, err, share)
        far, _ = registry.card_error(c, r, CARD_TOL_BWD[torch.bfloat16])
        assert far >= err, (name, far, err)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_plain_match_autograd_of_plain_forward(causal):
    """GQA and a ragged length: the Function's gradients against torch
    autograd through the chunked plain forward (f32, atol 1e-5)."""
    q, k, v = _qkv(26, H=4, Hkv=2, S=200)
    g = _qkv(27, H=4, S=200)[0]
    got = _port_grads(q, k, v, g, causal, torch.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention_ref(*ts, causal=causal)
    want = torch.autograd.grad(o, ts, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_flash_grads_torch_ref_mode_is_the_cpu_route():
    q, k, v = _qkv(28, S=128)
    g = _qkv(29, S=128)[0]
    a = _port_grads(q, k, v, g, True, torch.float32)
    b = _port_grads(q, k, v, g, True, torch.float32, mode="torch_ref")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert registry.launch_counts() == dict.fromkeys(registry.kernels(), 0)


def test_flash_no_grad_call_skips_the_function():
    q, k, v = (torch.from_numpy(a) for a in _qkv(30, S=64))
    with torch.no_grad():
        flash_attention_bhsd(q.requires_grad_(), k, v)
    o = flash_attention_bhsd(q.detach(), k, v)
    assert o.grad_fn is None
    assert registry.spec("flash_attention").torch_ref_calls == 2


@pytest.mark.parametrize("seq,head_dim,want", [
    (1024, 64, True), (2048, 128, True), (4096, 256, True),
    (1023, 128, False), (2048, 96, False), (64, 64, False)])
def test_flash_eligible_follows_reference_rule(seq, head_dim, want):
    assert flash_eligible(seq, head_dim) is want


@pytest.mark.parametrize("sq,sk", [(32, 32), (8, 32)])
def test_sdpa_ref_matches_jax(sq, sk):
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 2, sq, 3, 16), _rand(rng, 2, sk, 3, 16), \
        _rand(rng, 2, sk, 3, 16)
    ref = jax_sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       None, 0.0, True, None)
    got = _sdpa_ref(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), None, 0.0, True, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------
# kernel 4: int8 paged attention
# ---------------------------------------------------------------------

def _kv_case(seed, B=2, S=1, G=2, R=2, D=16, bs=8, M=4, nb=9):
    rng = np.random.default_rng(seed)
    qh = _rand(rng, B, S, G * R, D)
    kpool = rng.integers(-127, 128, (nb, bs, G, D)).astype(np.int8)
    vpool = rng.integers(-127, 128, (nb, bs, G, D)).astype(np.int8)
    ks = (rng.random((nb, bs)) * 0.01 + 1e-3).astype(np.float32)
    vs = (rng.random((nb, bs)) * 0.01 + 1e-3).astype(np.float32)
    tbl = rng.integers(1, nb, (B, M)).astype(np.int32)
    pos = rng.integers(0, bs * M, (B, S)).astype(np.int32)
    pos.sort(axis=1)
    return [qh, kpool, vpool, ks, vs, tbl, pos], G


def _trash_rows(args):
    """Row 0: a live sequence inside its first block; row 1: an idle
    decode slot (all-zero table = trash block 0, position 0)."""
    args = list(args)
    S = args[6].shape[1]
    args[5] = np.array([[3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    args[6] = np.array([np.arange(2, 2 + S), np.zeros(S)], np.int32)
    return args


@pytest.mark.parametrize("case", [
    dict(S=1),                                 # decode, GQA R=2
    dict(S=3, M=6),                            # verify block S>1
    dict(S=1, trash=True),                     # trash + position-0 rows
    dict(S=3, trash=True),
    dict(S=1, G=4, R=1, D=64, bs=16),          # MHA at a kernel head_dim
])
def test_int8_paged_plain_matches_jax(case):
    case = dict(case)
    trash = case.pop("trash", False)
    args, G = _kv_case(7, **case)
    if trash:
        args = _trash_rows(args)
    jargs = [jnp.asarray(a) for a in args]
    ker = jkv.int8_paged_attention(*jargs, G, interpret=True)
    xref = jkv.paged_attention_ref(*jargs, G)
    got = int8_paged_attention(*[torch.from_numpy(a) for a in args], G)
    assert got.shape == ker.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ker), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(xref), atol=2e-5,
                               rtol=1e-4)
    assert registry.spec("int8_kv_attention").torch_ref_calls == 1


def test_paged_plain_fp_pools_matches_jax():
    rng = np.random.default_rng(8)
    qh = _rand(rng, 2, 2, 4, 16)
    kp, vp = _rand(rng, 9, 8, 2, 16), _rand(rng, 9, 8, 2, 16)
    tbl = rng.integers(1, 9, (2, 4)).astype(np.int32)
    pos = np.array([[5, 6], [20, 21]], np.int32)
    ref = jkv.paged_attention_ref(*(jnp.asarray(a) for a in
                                    (qh, kp, vp)), None, None,
                                  jnp.asarray(tbl), jnp.asarray(pos), 2)
    got = paged_attention_ref(*(torch.from_numpy(a) for a in (qh, kp, vp)),
                              None, None, torch.from_numpy(tbl),
                              torch.from_numpy(pos), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------
# kernel 7: segment sum of embedding-gradient rows
# ---------------------------------------------------------------------

def test_segment_sum_plain_matches_jax_float(record_property):
    """The reference's documented bound, atol 1e-6, against both its XLA
    reference and its Pallas kernel in interpret mode; whether the result
    is bitwise is recorded beside the test."""
    rng = np.random.default_rng(14)
    g = _rand(rng, 37, 9)
    inv = rng.integers(0, 13, 37).astype(np.int32)
    got = segment_sum(torch.from_numpy(g), inv, 16).numpy()
    for name, fn in (("ref", jss.segment_sum_ref),
                     ("interpret", lambda *a: jss.segment_sum_pallas(
                         *a, interpret=True))):
        want = np.asarray(fn(jnp.asarray(g), jnp.asarray(inv), 16))
        np.testing.assert_allclose(got, want, atol=1e-6)
        record_property(f"bitwise_vs_jax_{name}", np.array_equal(got, want))
    assert not got[13:].any()
    assert registry.spec("segment_sum").torch_ref_calls == 1


@pytest.mark.parametrize("inv_type", ["int32", "int64", "tensor"])
def test_segment_sum_plain_integer_grads_bitwise_jax(inv_type):
    rng = np.random.default_rng(15)
    g = rng.integers(-50, 50, (64, 5)).astype(np.float32)
    inv = rng.integers(0, 7, 64).astype(np.int32)
    want = np.asarray(jss.segment_sum_pallas(jnp.asarray(g), jnp.asarray(inv),
                                             8, interpret=True))
    arg = (torch.from_numpy(inv) if inv_type == "tensor"
           else inv.astype(inv_type))
    got = segment_sum(torch.from_numpy(g), arg, 8).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        want, np.asarray(jss.segment_sum_ref(jnp.asarray(g), jnp.asarray(inv),
                                             8)))


@pytest.mark.parametrize("n,dim,nseg", [(1, 16, 1), (50, 13, 64), (0, 4, 3),
                                        (300, 16, 8)])
def test_segment_sum_plain_adds_in_row_order(n, dim, nseg):
    """Bitwise the sequential row-order sum (what the kernel and the
    native host merge compute), with Zipf-like repeats on segment 0."""
    rng = np.random.default_rng(n + dim)
    g = (_rand(rng, n, dim) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(
        np.float32)
    inv = np.minimum(rng.zipf(1.3, n) - 1, nseg - 1)
    want = np.zeros((nseg, dim), np.float32)
    for i in range(n):
        want[inv[i]] += g[i]
    got = segment_sum(torch.from_numpy(g), inv, nseg)
    assert got.shape == (nseg, dim) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_segment_plan_orders_rows_stably_by_segment():
    rng = np.random.default_rng(16)
    inv = rng.integers(0, 9, 200)
    order, offsets = segment_plan(inv, 12, "cpu")
    assert order.dtype == offsets.dtype == torch.int32
    assert np.array_equal(order.numpy(), np.argsort(inv, kind="stable"))
    counts = np.bincount(inv, minlength=12)
    assert np.array_equal(offsets.numpy(),
                          np.concatenate([[0], np.cumsum(counts)]))
    assert torch.equal(offsets[-3:], torch.full((3,), 200, dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        segment_plan(np.array([0, 12]), 12, "cpu")


@pytest.mark.parametrize("n,nseg,dim,aligned,want", [
    # the wide&deep push, the online merge and vocab scale (dim 16)
    (26_624, 8_192, 16, True, (4, 16, 16, 1, 192, (512, 1))),
    (26_624, 6_242, 16, True, (4, 16, 16, 1, 192, (391, 1))),
    (256, 200_000, 16, True, (4, 16, 16, 16, 32, (782, 1))),
    (26_624, 8_192, 16, False, (1, 16, 16, 1, 48, (512, 1))),
    (5_000, 5_000, 13, True, (1, 13, 19, 1, 59, (264, 1))),
    (300, 50, 5, True, (1, 5, 51, 1, 153, (1, 1))),
    (20, 3, 4_096, True, (4, 128, 2, 1, 24, (2, 32))),
    (0, 7, 16, True, (4, 16, 16, 1, 32, (1, 1))),
    (10 ** 6, 10 ** 6, 16, True, (4, 16, 16, 16, 64, (3_907, 1)))])
def test_segment_tile_plan_at_the_main_path_shapes(n, nseg, dim, aligned,
                                                   want):
    """16 segments a tile at dim 16 (a thread a column), so the 6,242-
    and 8,192-segment merges give 391 and 512 blocks for the card's 132
    SMs; at vocab scale a block takes 16 tiles in turn; a stage of about
    four average tiles' rows (a full 192-row stage at the merges, the
    least, 32 rows, at vocab scale); 4-byte copies off 16-byte rows."""
    p = segment_tile_plan(n, nseg, dim, aligned)
    assert (p.vec, p.width, p.tile, p.reps, p.chunk, p.grid) == want


@pytest.mark.parametrize("nseg,sms,reps", [
    (8_192, 132, 1), (8_448, 132, 1), (8_449, 132, 2), (200_000, 132, 16),
    (200_000, 66, 16), (50_000, 132, 6), (50_000, 66, 12), (8_192, 4, 16)])
def test_segment_tile_plan_takes_tiles_in_turn_past_one_wave(nseg, sms,
                                                             reps):
    """A block takes tiles in turn only where the 16-segment tiles
    outnumber the blocks the card holds at once (4 an SM: 528 on 132
    SMs), at most 16, so the grid stays within one wave where it can."""
    p = segment_tile_plan(1000, nseg, 16, sms=sms)
    assert p.reps == reps
    assert p.grid[0] <= 4 * sms or p.reps == 16


def test_segment_tile_plan_fits_the_block():
    """What ``csrc/segment_sum.cu``'s ``plan_ok`` checks, over a sweep:
    a tile's (segment, column) pairs fit 256 threads, at most 16 tiles a
    block, a stage's copies fit 768, 16-byte copies only on dims
    divisible by 4, and the grid covers every segment and column."""
    for n, nseg, dim, aligned in itertools.product(
            (0, 1, 999, 26_624, 10 ** 6), (1, 5, 4_096, 200_000, 10 ** 7),
            (1, 3, 4, 13, 16, 64, 100, 128, 129, 4_096), (True, False)):
        p = segment_tile_plan(n, nseg, dim, aligned)
        assert p.vec in (1, 4) and (p.vec == 1 or dim % 4 == 0 and aligned)
        assert 1 <= p.width <= min(dim, 128) and p.width % p.vec == 0
        assert 1 <= p.tile and p.tile * p.width <= 256
        assert 1 <= p.reps <= 16
        assert 1 <= p.chunk and p.chunk * (p.width // p.vec) <= 768
        assert p.grid == (-(-nseg // (p.tile * p.reps)), -(-dim // p.width))
    with pytest.raises(ValueError, match="nseg"):
        segment_tile_plan(4, 0, 16)


@pytest.mark.parametrize("offset", [0, 1])
def test_segment_launchers_pass_the_tile_plan(fake_flash_lib, offset):
    """Both launchers call their entry point of ``csrc/segment_sum.cu``
    with the pointers in its order and :func:`segment_tile_plan`'s plan;
    rows one float off 16-byte alignment take 4-byte copies."""
    g = torch.zeros(100 * 16 + 1)[offset:offset + 100 * 16].view(100, 16)
    inv = np.random.default_rng(18).integers(0, 40, 100)
    order, offsets = segment_plan(inv, 40, "cpu")
    seg = torch.from_numpy(np.sort(inv).astype(np.int32))
    out7 = segment_sum_planned(g, order, offsets)
    out8 = segment_sum_sorted_planned(g, seg, 40)
    plan = segment_tile_plan(100, 40, 16, offset == 0)
    assert plan.vec == (1 if offset else 4)
    tail = (100, 40, 16, plan.tile, plan.reps, plan.width, plan.chunk,
            plan.vec, 0)
    assert fake_flash_lib.calls == [
        ("segment_sum_f32", (g.data_ptr(), order.data_ptr(),
                             offsets.data_ptr(), out7.data_ptr()) + tail),
        ("segment_sum_sorted_f32", (g.data_ptr(), seg.data_ptr(),
                                    out8.data_ptr()) + tail)]
    for name, args in fake_flash_lib.calls:
        assert len(getattr(fake_flash_lib, name).argtypes) == len(args)
    assert out7.shape == out8.shape == (40, 16)
    counts = registry.launch_counts()
    assert counts["segment_sum"] == counts["segment_sum_sorted"] == 1


def _plain_cases():
    """(label, ascending ids, dim, nseg): the card's hard cases for
    kernels 7 and 8 (``hard_segment_cases``, rows aligned or not alike on
    the CPU) and the main path's odd shapes at a small size."""
    rng = np.random.default_rng(40)
    cases = [(f"{label} dim {dim}", seg, dim, nseg)
             for label, seg, dim, nseg, _ in hard_segment_cases(rng)]
    return cases + [
        ("zipf merge", np.sort(np.minimum(rng.zipf(1.3, 600) - 1, 63)), 16,
         64),
        ("n=1", np.zeros(1, np.int64), 16, 1),
        ("vocab scale", np.sort(rng.integers(0, 200_000, 256)), 16, 200_000),
        ("dim 5", np.sort(rng.integers(0, 50, 300)), 5, 50),
        ("dim 4096", np.sort(rng.integers(0, 3, 20)), 4096, 3)]


_PLAIN_CASES = _plain_cases()


@pytest.mark.parametrize("kernel", [7, 8])
@pytest.mark.parametrize("case", range(len(_PLAIN_CASES)),
                         ids=[c[0] for c in _PLAIN_CASES])
def test_plain_versions_on_the_hard_cases_match_jax(kernel, case):
    """The plain versions the card holds kernels 7 and 8 to, bitwise, on
    the card's hard cases: on float gradients bitwise the sequential
    row-order sum; on integer ones bitwise the reference's
    ``segment_sum_ref`` (kernel 7, rows in shuffled order) or
    ``segment_sum_sorted_ref`` (kernel 8)."""
    _, seg, dim, nseg = _PLAIN_CASES[case]
    n = seg.size
    rng = np.random.default_rng(kernel)
    if kernel == 8:
        inv, plain, jref = seg, segment_sum_sorted, jss.segment_sum_sorted_ref
    else:
        inv, plain, jref = (seg[rng.permutation(n)], segment_sum,
                            jss.segment_sum_ref)
    g = (_rand(rng, n, dim) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(
        np.float32)
    want = np.zeros((nseg, dim), np.float32)
    for i in range(n):
        want[inv[i]] += g[i]
    assert np.array_equal(plain(torch.from_numpy(g), inv, nseg).numpy(),
                          want)
    gi = rng.integers(-50, 50, (n, dim)).astype(np.float32)
    ref = jref(jnp.asarray(gi), jnp.asarray(inv.astype(np.int32)), nseg)
    assert np.array_equal(plain(torch.from_numpy(gi), inv, nseg).numpy(),
                          np.asarray(ref))


# ---------------------------------------------------------------------
# kernel 9: dequantisation of int8 PS rows
# ---------------------------------------------------------------------

@pytest.mark.parametrize("m,dim", [(37, 24), (1, 1), (5, 13), (0, 16)])
def test_pull_dequant_plain_bitwise_jax(m, dim):
    rng = np.random.default_rng(m * 31 + dim)
    rows = (rng.standard_normal((m, dim)) * 3).astype(np.float32)
    if m > 5:
        rows[5] = 0.0        # an all-zero row ships scale 0
    codes, scales = jps.quantize_rows_q8(rows)
    got = pull_dequant(torch.from_numpy(codes), torch.from_numpy(scales))
    assert got.shape == (m, dim) and got.dtype == torch.float32
    got = got.numpy()
    assert np.array_equal(got, jps.dequantize_rows_q8(codes, scales))
    if m:
        want = np.asarray(jpd.pull_dequant_pallas(
            jnp.asarray(codes), jnp.asarray(scales), interpret=True))
        assert np.array_equal(got, want)
    if m > 5:
        assert not got[5].any() and np.isfinite(got).all()


def test_ps_kernels_raise_on_cpu_tensors_in_cuda_mode():
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_sum(torch.zeros(4, 2), np.zeros(4, np.int64), 2, mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pull_dequant(torch.zeros(4, 2, dtype=torch.int8), torch.zeros(4),
                     mode="cuda")
    assert registry.launch_counts() == dict.fromkeys(registry.kernels(), 0)


# ---------------------------------------------------------------------
# kernel 5: fused optimizer apply over a flat ZeRO shard
# ---------------------------------------------------------------------

_HYPER = dict(lr=0.01, betas=(0.9, 0.999), eps=1e-8, momentum=0.9)


def _opt_state(seed, n, kind):
    """p, g and the kind's slots (adam's v non-negative), f32 numpy."""
    rng = np.random.default_rng(seed)
    p, g = _rand(rng, n), _rand(rng, n)
    slots = {"u": _rand(rng, n) * np.float32(0.1),
             "m": _rand(rng, n) * np.float32(0.1),
             "v": np.square(_rand(rng, n)) * np.float32(0.01)}
    return p, g, [slots[k] for k in SLOTS[kind]]


def _numpy_engine(kind, p, g, slots, t):
    """The reference's host numpy engine: its flat optimizer with
    ``fused=False``, loaded at step t - 1 and stepped once."""
    cls = {"sgd": jelastic._FlatSGD, "momentum": jelastic._FlatMomentum,
           "adam": jelastic._FlatAdam}[kind]
    o = cls(_HYPER["lr"], betas=_HYPER["betas"], eps=_HYPER["eps"],
            momentum=_HYPER["momentum"], fused=False)
    o.load(dict(zip(SLOTS[kind], slots)), t=t - 1)
    p_n = o.update(p, g)
    return [p_n] + [getattr(o, k) for k in SLOTS[kind]]


def _port(kind, p, g, slots, t):
    hyper = pack_hyper(kind, t=t, **_HYPER)
    out = opt_apply(kind, torch.from_numpy(p), torch.from_numpy(g),
                    [torch.from_numpy(s) for s in slots], hyper)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("t", [1, 7, 10_000])
@pytest.mark.parametrize("kind", KINDS)
def test_opt_apply_plain_bitwise_numpy_host_engine(kind, t):
    """The plain version (what the CPU runs, and what the kernel is held
    to bitwise on the card) is bitwise the reference's numpy engine."""
    p, g, slots = _opt_state(50 + t, 4097, kind)
    got = _port(kind, p, g, slots, t)
    want = _numpy_engine(kind, p, g, slots, t)
    assert len(got) == 1 + len(SLOTS[kind])
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert registry.spec("opt_apply").torch_ref_calls == 1


def _fma_bounds(kind, p, g, slots, t):
    """Per-output limits on |port - JAX| from one FMA contraction per
    multiply-add (XLA contracts them on the CPU; the port rounds every
    operation).  Contracting ``a*b + c*d`` skips one product's rounding
    and may move the sum's rounding: at most 2^-24 |a*b| + 2^-23 |sum|
    <= 2^-22 (|a*b| + |c*d|).  So

    - sgd:      |dp| <= 2^-22 (|p| + |lr g|)
    - momentum: |du| <= 2^-22 (|mu u| + |g|);
                |dp| <= 2^-22 (|p| + 2 lr (|mu u| + |g|))
    - adam:     |dm| <= 2^-22 (|b1 m| + |(1-b1) g|);
                |dv| <= 2^-22 (|b2 v| + |(1-b2) g^2|);
                |dp| <= 2^-22 (|p| + 4 U), U = lr (|b1 m| + |(1-b1) g|)
                / (c1 (sqrt(v'/c2) + eps)): m' may cancel, so its error
                reaches p' through the update's m term at full size;
                v' adds non-negative terms (no cancellation) and the
                update's own roundings stay below 2^-21 |update|.
    """
    f64 = [np.asarray(a, np.float64) for a in (p, g, *slots)]
    p, g, slots = f64[0], f64[1], f64[2:]
    lr = float(np.float32(_HYPER["lr"]))
    e = 2.0 ** -22
    if kind == "sgd":
        return [e * (abs(p) + abs(lr * g))]
    if kind == "momentum":
        (u,) = slots
        mu = float(np.float32(_HYPER["momentum"]))
        su = abs(mu * u) + abs(g)
        return [e * (abs(p) + 2 * lr * su), e * su]
    m, v = slots
    h = pack_hyper("adam", t=t, **_HYPER)[0].astype(np.float64)
    b1, b2, eps, c1, c2, omb1, omb2 = h[[1, 2, 3, 4, 5, 7, 8]]
    sm = abs(b1 * m) + abs(omb1 * g)
    sv = abs(b2 * v) + abs(omb2 * g * g)
    v_n = b2 * v + omb2 * g * g
    U = lr * sm / (c1 * (np.sqrt(v_n / c2) + eps))
    return [e * (abs(p) + 4 * U), e * sm, e * sv]


@pytest.mark.parametrize("t", [1, 7, 10_000])
@pytest.mark.parametrize("kind", KINDS)
def test_opt_apply_plain_matches_jax_ref_and_interpret(kind, t,
                                                       record_property):
    p, g, slots = _opt_state(60 + t, 4097, kind)
    got = _port(kind, p, g, slots, t)
    bounds = _fma_bounds(kind, p, g, slots, t)
    hyper = pack_hyper(kind, t=t, **_HYPER)
    args = (kind, jnp.asarray(p), jnp.asarray(g),
            tuple(jnp.asarray(s) for s in slots), hyper)
    for name, fn in (("ref", jax.jit(jopt.opt_apply_ref, static_argnums=0)),
                     ("interpret", lambda *a: jopt.opt_apply_pallas(
                         *a, interpret=True))):
        want = [np.asarray(w) for w in fn(*args)]
        share = 0.0
        for i, (a, b, lim) in enumerate(zip(got, want, bounds)):
            err = np.abs(a.astype(np.float64) - b)
            assert (err <= lim).all(), (name, i, float(err.max()),
                                        float((err / lim).max()))
            share = max(share, float((err / lim).max()))
        record_property(f"max_share_of_limit_vs_jax_{name}", share)
        record_property(f"bitwise_vs_jax_{name}",
                        all(np.array_equal(a, b) for a, b in zip(got, want)))


def test_pack_hyper_bitwise_reference():
    for kind, kw in (("adam", dict(lr=0.01, t=1)),
                     ("adam", dict(lr=3e-4, betas=(0.8, 0.95), eps=1e-6,
                                   t=10_000)),
                     ("momentum", dict(lr=0.5, momentum=0.95, t=3)),
                     ("sgd", dict(lr=np.float32(0.1), t=7))):
        got, want = pack_hyper(kind, **kw), jopt.pack_hyper(kind, **kw)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_opt_apply_shard_update_is_the_slice_of_the_full_update(kind):
    """The ZeRO invariant: the update of [lo, hi) is bitwise the same
    slice of the full vector's update."""
    n = 1000
    p, g, slots = _opt_state(70, n, kind)
    full = _port(kind, p, g, slots, 5)
    for lo, hi in ((0, 1), (0, 500), (500, 1000), (3, 4), (333, 777),
                   (999, 1000), (1, 1000)):
        part = _port(kind, p[lo:hi], g[lo:hi], [s[lo:hi] for s in slots], 5)
        for a, b in zip(part, full):
            assert np.array_equal(a, b[lo:hi]), (lo, hi)


def test_opt_apply_rejects_what_it_does_not_take():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        opt_apply("adam", p, p, [p, p], pack_hyper("adam", lr=0.1),
                  mode="cuda")
    with pytest.raises(ValueError, match="takes slots"):
        opt_apply("adam", p, p, [p], pack_hyper("adam", lr=0.1))
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        opt_apply("lamb", p, p, [], pack_hyper("sgd", lr=0.1))
    with pytest.raises(ValueError, match="hyper has"):
        opt_apply_ref("sgd", p, p, [], np.zeros(3, np.float32))
    # what the kernel's eligibility check names on a card
    spec = registry.spec("opt_apply")
    assert "unknown optimizer kind" in spec.eligible_fn(
        "lamb", p, p, (), None)
    assert "CUDA tensors" in spec.eligible_fn("sgd", p, p, (), None)
    assert registry.launch_counts() == dict.fromkeys(registry.kernels(), 0)


# ---------------------------------------------------------------------
# registry, build, kernel sources
# ---------------------------------------------------------------------

def test_registry_names_and_tolerances_match_reference():
    ours, theirs = registry.kernels(), jreg.kernels()
    assert sorted(ours) == ["conv_bn_stats", "flash_attention",
                            "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dq", "int8_kv_attention",
                            "int8_matmul", "opt_apply", "pull_dequant",
                            "segment_sum", "segment_sum_sorted"]
    for name, s in ours.items():
        if name == "conv_bn_stats":
            # kernel 10 is an experiment under tools/ in the reference,
            # never registered there: the port states its own tolerance
            assert "conv_bn_stats" not in theirs
            assert s.replaces == "tools/exp_conv_bn_kernel.py:30"
            continue
        # the reference registers its flash forward and custom-vjp
        # backward as one entry
        their = "flash_attention" if name.startswith("flash") else name
        assert s.tolerance == theirs[their].tolerance, name


def test_cpu_tensors_never_reach_the_kernel():
    args, G = _kv_case(9)
    targs = [torch.from_numpy(a) for a in args]
    int8_paged_attention(*targs, G)
    int8_paged_attention(*targs, G, mode="torch_ref")
    s = registry.spec("int8_kv_attention")
    assert (s.torch_ref_calls, s.launches) == (2, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_paged_attention(*targs, G, mode="cuda")
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bhsd(q, q, q, mode="cuda")
    with pytest.raises(ValueError, match="mode must be one of"):
        flash_attention_bhsd(q, q, q, mode="interpret")
    lse = torch.zeros(1, 2, 8)
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            registry.dispatch(name, q, q, q, q, lse, lse, mode="cuda")
    assert registry.launch_counts() == dict.fromkeys(registry.kernels(), 0)


def test_missing_nvcc_raises_only_when_building(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_keeps_the_ptxas_log_beside_a_cached_library(monkeypatch,
                                                          tmp_path):
    """A build writes nvcc's output beside the library; a later build
    that finds the library reads that log back into ``build_logs``, so a
    check of ptxas's report (spills) also sees a cached library."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=\"$2\"; shift; done\n"
        "echo \"ptxas info : Compiling entry function 'k'\" >&2\n"
        "echo \"ptxas info : Used 40 registers, 0 bytes spill stores\" >&2\n"
        ": > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    (lib,) = _build.build(["segment_sum.cu"])
    log = _build.build_logs["segment_sum.cu"]
    assert "Used 40 registers" in log
    assert "segment_sum.cu" in _build.build_seconds
    assert lib.with_suffix(".log").read_text() == log
    assert sorted(p.name for p in lib.parent.iterdir()) == [
        lib.with_suffix(".log").name, lib.name]
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    nvcc.unlink()                      # cached: nvcc is not run again
    assert _build.build(["segment_sum.cu"]) == [lib]
    assert _build.build_logs == {"segment_sum.cu": log}
    assert _build.build_seconds == {}


def test_build_target_follows_the_included_header(monkeypatch, tmp_path):
    """A library's name hashes the source and every ``csrc/`` header it
    includes, so an edit to the shared sm90 header rebuilds both flash
    sources; system headers are not followed."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <stdint.h>\n#include "h.cuh"\n'
                               "int x;\n")
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._target("a.cu")
    assert _build._target("a.cu") == first
    (csrc / "h.cuh").write_text("// two\n")
    assert _build._target("a.cu") != first
    assert _build._target("a.cu").name.startswith("a-")
    monkeypatch.undo()
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        assert '#include "sm90.cuh"' in (_build.CSRC / src).read_text()
        assert (_build._source_bytes(src)
                == (_build.CSRC / src).read_bytes()
                + (_build.CSRC / "sm90.cuh").read_bytes())


def test_kernel_sources_carry_their_note():
    for s in registry.kernels().values():
        src = (REPO / s.source).read_text()
        assert f"Replaces: {s.replaces}" in src.replace("\n// ", " ")
        assert "What bounds it on this card" in src
        assert "What the design does about it" in src
        assert "sm_90a" in src
        assert pathlib.Path(s.source).name in _build.SOURCES
        jfile, line = s.replaces.split(":")
        assert "def _" in (REPO / jfile).read_text().splitlines()[
            int(line) - 1]


# ---------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------

def test_import_pulls_in_no_jax_and_no_reference_module():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.text.models, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.distributed.fleet, "
            "paddle_tpu_torch.distributed.launch, paddle_tpu_torch.io, "
            "paddle_tpu_torch.observability, "
            "paddle_tpu_torch.framework.monitor, "
            "paddle_tpu_torch.vision.models, paddle_tpu_torch.quantization\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_source_imports_no_jax_or_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        for name in _imported_roots(ast.parse(f.read_text())):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "paddle_tpu",
                                "ml_dtypes"), (f, name)
