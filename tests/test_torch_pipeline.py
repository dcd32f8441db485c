"""The port's pipelines (``distributed/pipeline.py``: GPipe and 1F1B over
``pp``) and the stacked decoder against the JAX reference.

The port's side runs as four gloo rank processes on the CPU (one world
for the module), the cases in ``tests/torch_dist_worker.py``: the
reference's stacked tanh-linear block (``tests/test_pipeline_1f1b.py``)
over pp 4 and over pp 2 x dp 2, and the Llama step over pp 2 x fsdp 2 at
ZeRO-3 with recompute and tied embeddings.  The JAX side: the
reference's ground truth (plain autodiff over the whole block), its
``pipeline_apply`` / ``pipeline_train_1f1b`` on the same mesh of the 8
virtual devices, and its Llama on the same mesh.  Tolerances (f32, the
reference's): outputs within 1e-5, losses within 1e-5 relative,
gradients within 2e-4 relative and 1e-5 absolute of the ground truth;
1F1B within 1e-5 of GPipe's (the same products, another order of
microbatch sums); the stacked decoder within 1e-5 of the layer list; the
Llama step as ``test_torch_meta_parallel.check_llama``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import pipeline as jpl
from paddle_tpu.text.models import LlamaForCausalLM as JLlama
from paddle_tpu.text.models import llama_tiny as jtiny

import torch

from paddle_tpu_torch.distributed import pipeline as pl
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny

import torch_dist_worker as worker
from torch_llama_ref import check_llama, eager_uncached


def _stage_fn(local_params, h):
    def body(carry, wb):
        w, b = wb
        return jnp.tanh(carry @ w + b), None
    out, _ = jax.lax.scan(body, h, local_params)
    return out


def _head_loss(h, y):
    return jnp.mean((h - y) ** 2)


def _setup(L=4, d=8, B=8, seed=0):
    rng = np.random.RandomState(seed)
    return dict(w=(rng.randn(L, d, d) * 0.3).astype(np.float32),
                b=(rng.randn(L, d) * 0.1).astype(np.float32),
                x=rng.randn(B, d).astype(np.float32),
                y=rng.randn(B, d).astype(np.float32))


def _pipe(mesh, M, seed):
    return dict(kind="tanh", mesh=mesh, M=M, **_setup(seed=seed))


LLAMA_CFG = dict(compute_dtype="float32", scan_layers=True, remat=True,
                 tie_word_embeddings=True, pp_num_microbatches=2)


def _llama_case():
    paddle.seed(1)
    m = JLlama(jtiny(**LLAMA_CFG))
    return dict(kind="llama", mesh={"fsdp": 2, "pp": 2}, cfg=LLAMA_CFG,
                weights={k: np.asarray(v._value).copy()
                         for k, v in m.state_dict().items()},
                ids=np.random.RandomState(5).randint(
                    0, 256, (4, 32)).astype("int32"), steps=2,
                strategy={"sharding": True,
                          "sharding_configs": {"stage": 3}})


CASES = [_pipe({"pp": 4}, 4, 0), _pipe({"pp": 4}, 2, 1),
         _pipe({"pp": 2, "dp": 2}, 4, 3), _llama_case()]


@pytest.fixture(scope="module")
def ranks():
    ctx = spawn(worker.pipeline_cases, args=(CASES,), nprocs=4,
                backend="gloo", timeout=60, join=False)
    got = []
    yield lambda: got[0] if got else got.append(ctx.join(300)) or got[0]
    ctx.close()


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


def _ground_truth(case):
    stacked = (jnp.asarray(case["w"]), jnp.asarray(case["b"]))

    def whole(params, h):
        return _head_loss(_stage_fn(params, h), case["y"])
    loss, (dp, dx) = jax.value_and_grad(whole, argnums=(0, 1))(
        stacked, jnp.asarray(case["x"]))
    out = _stage_fn(stacked, jnp.asarray(case["x"]))
    return float(loss), dp, np.asarray(dx), np.asarray(out)


def _whole_layers(got, key):
    """The stages' blocks of a stacked gradient, in stage order."""
    by_stage = {}
    for r in got:
        by_stage.setdefault(r["stage"], r[key])
    return np.concatenate([by_stage[s] for s in sorted(by_stage)])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_gpipe_matches_a_single_stage_and_jax(ranks, i):
    """GPipe's output, loss and gradients against the block run whole and
    against the reference's ``pipeline_apply`` on the same mesh."""
    case = CASES[i]
    got = [r[i] for r in ranks()]
    loss, (dw, db), dx, out = _ground_truth(case)
    n = int(np.prod(list(case["mesh"].values())))
    mesh = jmesh.init_mesh(case["mesh"], devices=jax.devices()[:n])
    jout = np.asarray(jpl.pipeline_apply(
        lambda p, h, e: _stage_fn(p, h),
        (jnp.asarray(case["w"]), jnp.asarray(case["b"])),
        jnp.asarray(case["x"]), num_microbatches=case["M"], mesh=mesh))
    for r in got:
        np.testing.assert_allclose(r["out"], out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["out"], jout, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["dx"], dx, rtol=2e-4, atol=1e-5)
        assert r["per"] == 4 // case["mesh"]["pp"]
    np.testing.assert_allclose(_whole_layers(got, "dw"), np.asarray(dw),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(_whole_layers(got, "db"), np.asarray(db),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_1f1b_matches_ground_truth_jax_and_gpipe(ranks, i):
    case = CASES[i]
    got = [r[i] for r in ranks()]
    loss, (dw, db), dx, _ = _ground_truth(case)
    n = int(np.prod(list(case["mesh"].values())))
    mesh = jmesh.init_mesh(case["mesh"], devices=jax.devices()[:n])
    jloss, _, jdx = jpl.pipeline_train_1f1b(
        _stage_fn, (jnp.asarray(case["w"]), jnp.asarray(case["b"])),
        jnp.asarray(case["x"]), jnp.asarray(case["y"]), _head_loss,
        num_microbatches=case["M"], mesh=mesh)
    for r in got:
        np.testing.assert_allclose(r["f_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["f_loss"], float(jloss), rtol=1e-5)
        np.testing.assert_allclose(r["f_dx"], dx, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(r["f_dx"], np.asarray(jdx), rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["f_loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["f_dw"], r["dw"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["f_db"], r["db"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["f_dx"], r["dx"], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(_whole_layers(got, "f_dw"), np.asarray(dw),
                               rtol=2e-4, atol=1e-5)


def test_pp_times_zero3_llama_step_matches_jax(ranks):
    got = [r[3] for r in ranks()]
    check_llama(got, CASES[3])
    specs = got[0]["grad_specs"]
    assert specs["model.decoder.mlp__down_proj__weight"][0] == "pp"


def test_single_stage_fallback_is_plain_autodiff():
    case = _setup()
    loss, (dw, db), dx, out = _ground_truth(case)
    w, b = (torch.from_numpy(case["w"]), torch.from_numpy(case["b"]))
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    got = pl.pipeline_train_1f1b(worker._tanh_stage, (w, b), x, y,
                                 worker._mse, num_microbatches=2)
    np.testing.assert_allclose(float(got[0]), loss, rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), dx, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(dw),
                               rtol=1e-5, atol=1e-7)
    o = pl.pipeline_apply(lambda p, h, e: worker._tanh_stage(p, h), (w, b),
                          x, num_microbatches=2)
    np.testing.assert_allclose(o.numpy(), out, rtol=1e-6, atol=1e-6)



def test_schedule_ticks_and_ring_size_match_the_reference():
    for S in (1, 2, 4, 8):
        for M in (1, S, 2 * S, 8 * S):
            for kind in ("1F1B", "gpipe"):
                assert pl.schedule_ticks(M, S, kind) == \
                    jpl.schedule_ticks(M, S, kind)
            assert pl.ring_size(M, S) == jpl.ring_size(M, S)
    assert pl.schedule_ticks(8, 4) == 14 and pl.ring_size(64, 4) == 7


def test_stacked_decoder_matches_the_layer_list_and_jax():
    """The stacked decoder (``scan_layers``) on the layer list's weights
    gives the layer list's logits, and both the reference's."""
    cfg = dict(compute_dtype="float32", num_hidden_layers=3)
    paddle.seed(2)
    jm = JLlama(jtiny(**cfg))
    sd = {k: np.asarray(v._value).copy() for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(0).randint(0, 256, (2, 16)).astype("int32")
    with eager_uncached():
        ref = np.asarray(jm(paddle.to_tensor(ids))._value)
    lst = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(lst, sd)
    stk = LlamaForCausalLM(llama_tiny(scan_layers=True, **cfg), device="cpu")
    dec = stk.model.decoder
    st = {k: v for k, v in sd.items() if not k.startswith("model.layers.")}
    for n in dec._names:
        st["model.decoder." + n.replace(".", "__")] = np.stack(
            [sd[f"model.layers.{i}.{n}"] for i in range(3)])
    load_jax_state_dict(stk, st)
    with torch.no_grad():
        a = lst(torch.from_numpy(ids)).numpy()
        b = stk(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-5)
    for p in stk.model.decoder.parameters():
        assert p.dist_spec[0] == "pp" and p.full_shape[0] == 3
