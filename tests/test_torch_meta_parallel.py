"""The port's tensor-parallel layers (``distributed/meta_parallel.py``),
``distributed.split`` and tp x fsdp at ZeRO-3 against the JAX reference.

The port's side runs as four gloo rank processes on the CPU (one world
for the module, ``spawn``), the cases in ``tests/torch_dist_worker.py``;
the JAX side on the 8 virtual devices of ``tests/conftest.py`` on the
same mesh.  The same numpy weights and inputs go to both.  Tolerances
(f32): the layers' outputs and gradients within 1e-5 (relative and
absolute) of JAX's at tp 2 and 4; ``split`` within 1e-6 of the same
layer made whole in one process from the same seed; the Llama step at
tp 2 x fsdp 2, ZeRO-3: loss within 1e-5 relative, every gradient within
1e-4 of the largest, two steps' losses within 1e-5.  At tp 1 each layer
is a plain linear or embedding bitwise, and ranks that hold the same
block of a gradient hold it bitwise (``gather_blocks`` checks)."""
import numpy as np
import pytest

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models import LlamaForCausalLM as JLlama
from paddle_tpu.text.models import llama_tiny as jtiny

import torch

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import meta_parallel as mp
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.framework.io import gather_blocks
from paddle_tpu_torch.nn import functional as F

import torch_dist_worker as worker
from torch_llama_ref import check_llama, eager_uncached, mesh_shape

WORLD = 4


def _layer_weights(seed=0):
    paddle.seed(seed)
    col = jdist.ColumnParallelLinear(16, 64)
    row = jdist.RowParallelLinear(64, 16)
    emb = jdist.VocabParallelEmbedding(64, 8)
    w = {}
    for layer, pre in ((col, "col."), (row, "row."), (emb, "emb.")):
        for k, v in layer.state_dict().items():
            w[pre + k] = np.asarray(v._value).copy()
    # nonzero biases, so their gradients and the sums show
    rng = np.random.RandomState(seed + 1)
    w["col.bias"] = rng.randn(64).astype(np.float32) * 0.1
    w["row.bias"] = rng.randn(16).astype(np.float32) * 0.1
    return w


def _layer_case(mesh, gather):
    rng = np.random.RandomState(7)
    return dict(kind="layers", mesh=mesh, gather=gather,
                weights=_layer_weights(),
                x=rng.randn(4, 16).astype(np.float32),
                ids=np.array([[0, 5, 63], [7, 8, 40]], np.int64),
                e_ct=rng.randn(2, 3, 8).astype(np.float32))


# tied embeddings: the head is the vocab-split table (its logits gathered)
LLAMA_CFG = dict(compute_dtype="float32", scan_layers=True,
                 tie_word_embeddings=True)


def _llama_weights(cfg):
    paddle.seed(0)
    m = JLlama(jtiny(**cfg))
    return {k: np.asarray(v._value).copy() for k, v in m.state_dict().items()}


def _ids():
    return np.random.RandomState(0).randint(0, 256, (4, 32)).astype("int32")


ZERO3 = {"sharding": True, "sharding_configs": {"stage": 3}}

CASES = [_layer_case({"tp": 4}, True), _layer_case({"tp": 4}, False),
         _layer_case({"dp": 2, "tp": 2}, True),
         _layer_case({"dp": 2, "tp": 2}, False),
         dict(kind="split", mesh={"tp": 4},
              x=np.random.RandomState(3).randn(2, 8).astype(np.float32),
              ids=np.array([[1, 9, 63]], np.int64)),
         dict(kind="llama", mesh={"fsdp": 2, "tp": 2}, cfg=LLAMA_CFG,
              weights=_llama_weights(LLAMA_CFG), ids=_ids(), steps=2,
              strategy=ZERO3),
         dict(kind="fleet", strategy={
             "tensor_parallel": True,
             "tensor_parallel_configs": {"tensor_parallel_degree": 2}})]


@pytest.fixture(scope="module")
def ranks():
    ctx = spawn(worker.meta_parallel_cases, args=(CASES,), nprocs=WORLD,
                backend="gloo", timeout=60, join=False)
    got = []
    yield lambda: got[0] if got else got.append(ctx.join(300)) or got[0]
    ctx.close()


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


def _jax_layers(case):
    """The JAX layers on the case's mesh: outputs and gradients."""
    n = int(np.prod(list(case["mesh"].values())))
    jmesh.init_mesh(case["mesh"], devices=jax.devices()[:n])
    col = jdist.ColumnParallelLinear(16, 64, gather_output=True)
    row = jdist.RowParallelLinear(64, 16)
    emb = jdist.VocabParallelEmbedding(64, 8)
    for layer, pre in ((col, "col."), (row, "row."), (emb, "emb.")):
        layer.set_state_dict({k: paddle.to_tensor(case["weights"][pre + k])
                              for k in layer.state_dict()})
    x = paddle.to_tensor(case["x"])
    x.stop_gradient = False
    with eager_uncached():
        y = row(col(x))
        (y * y).sum().backward()
        e = emb(paddle.to_tensor(case["ids"].astype(np.int32)))
        (e * paddle.to_tensor(case["e_ct"])).sum().backward()
    grads = {}
    for layer, pre in ((col, "col."), (row, "row."), (emb, "emb.")):
        for k, p in layer.named_parameters():
            grads[pre + k] = np.asarray(p.grad._value)
    return dict(y=np.asarray(y._value), e=np.asarray(e._value),
                x_grad=np.asarray(x.grad._value), grads=grads)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_layers_match_jax_at_tp_4_and_2(ranks, i):
    case = CASES[i]
    got = [r[i] for r in ranks()]
    ref = _jax_layers(case)
    for r in got:
        assert r["split"] == (True, True)
        np.testing.assert_allclose(r["y"], ref["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["e"], ref["e"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["x_grad"], ref["x_grad"], rtol=1e-5,
                                   atol=1e-5)
    whole = gather_blocks([r["grads"] for r in got], got[0]["specs"],
                          mesh_shape(case["mesh"]))
    for k, v in ref["grads"].items():
        np.testing.assert_allclose(whole[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # each rank holds its block: 64 / tp columns, rows, vocab rows
    tp = case["mesh"]["tp"]
    blk = got[0]["grads"]
    assert blk["col.weight"].shape == (16, 64 // tp)
    assert blk["col.bias"].shape == (64 // tp,)
    assert blk["row.weight"].shape == (64 // tp, 16)
    assert blk["row.bias"].shape == (16,)
    assert blk["emb.weight"].shape == (64 // tp, 8)


def test_split_three_cases_match_the_whole_layer(ranks):
    case = CASES[4]
    x = torch.from_numpy(case["x"])
    ids = torch.from_numpy(case["ids"])
    want = {}
    for name, kw, arg in (("col", dict(size=(8, 16), operation="linear",
                                       axis=1, gather_out=True), x),
                          ("row", dict(size=(8, 16), operation="linear",
                                       axis=0), x),
                          ("emb", dict(size=(64, 8),
                                       operation="embedding"), ids)):
        torch.manual_seed(5)
        want[name] = tdist.split(arg, **kw).detach().numpy()
    assert want["col"].shape == (2, 16) and want["emb"].shape == (1, 3, 8)
    for r in ranks():
        for name, v in want.items():
            np.testing.assert_allclose(r[4][name], v, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    with pytest.raises(ValueError, match="unsupported split"):
        tdist.split(x, (8, 16), "conv")


def test_tp_times_fsdp_zero3_matches_jax(ranks):
    got = [r[5] for r in ranks()]
    check_llama(got, CASES[5])
    # ZeRO-3 over fsdp composes with the tp blocks: the annotation wins
    specs = dict(got[0]["grad_specs"])
    assert "lm_head.weight" not in specs
    assert specs["model.decoder.self_attn__q_proj__weight"] == \
        ("pp", "fsdp", "tp")
    assert specs["model.embed_tokens.weight"] == ("tp", "fsdp")


def test_collective_fleet_init_takes_a_tp_degree(ranks):
    """``fleet.init(is_collective=True)`` over a tensor_parallel degree of
    2 in a world of 4: dp absorbs the rest, tp pairs neighbouring ranks."""
    for r, got in enumerate(ranks()):
        g = got[6]
        assert {k: v for k, v in g["shape"].items() if v > 1} == \
            {"dp": 2, "tp": 2}
        assert g["tp_ranks"] == [r - r % 2, r - r % 2 + 1]


def test_layers_are_plain_bitwise_at_tp_1():
    torch.manual_seed(0)
    x = torch.randn(3, 16)
    col = mp.ColumnParallelLinear(16, 32, device="cpu")
    row = mp.RowParallelLinear(32, 16, device="cpu")
    with torch.no_grad():
        col.bias.normal_()
        row.bias.normal_()
    emb = mp.VocabParallelEmbedding(50, 8, device="cpu")
    ids = torch.tensor([[0, 49, 7]])
    assert not col.split() and not row.split()
    assert torch.equal(col(x), F.linear(x, col.weight, col.bias))
    assert torch.equal(row(col(x)), F.linear(F.linear(x, col.weight,
                                                      col.bias),
                                             row.weight, row.bias))
    assert torch.equal(emb(ids), F.embedding(ids, emb.weight))
    assert col.weight.dist_spec == (None, "tp")
    assert col.bias.dist_spec == ("tp",)
    assert row.weight.dist_spec == ("tp", None)
    assert emb.weight.dist_spec == ("tp", None)


def test_nn_layer_reexports_the_parallel_layers():
    from paddle_tpu_torch.nn import layer
    from paddle_tpu_torch.nn.layer import common
    assert layer.ColumnParallelLinear is mp.ColumnParallelLinear
    assert common.RowParallelLinear is mp.RowParallelLinear
    assert layer.VocabParallelEmbedding is mp.VocabParallelEmbedding
    assert tdist.ColumnParallelLinear is mp.ColumnParallelLinear


def test_rng_state_tracker_regions():
    tr = mp.get_rng_state_tracker()
    tr.add("local", 11)
    tr.add("global", 0)
    before = torch.random.get_rng_state()
    with tr.rng_state("local"):
        a = torch.rand(4)
    with tr.rng_state("local"):
        b = torch.rand(4)
    with tr.rng_state("global"):
        c = torch.rand(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.random.get_rng_state(), before)
