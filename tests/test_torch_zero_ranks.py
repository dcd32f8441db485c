"""The port's ZeRO at world 2 and 4 against the JAX reference: gloo rank
processes on the CPU, two and four, started once each for the module by
``spawn`` (beside its in-process work), every rank running every case of
``zero_cases`` (``torch_dist_worker.train_cases``), the JAX step on its
host mesh restricted to as many devices.  Tolerances
(``tests/test_torch_zero.py`` states them all): the ranks' parameters
bitwise equal; within rtol / atol 2e-5 of the JAX step in f32; bf16 AMP
within 1e-2 and bf16 / int8 slots within 1e-3 of the JAX step with the
same settings, int8 within 5e-2 of f32; rows a rank as ``sharded_numel``
gives; a JAX ZeRO-3 int8 state loads as each rank's rows bitwise."""
import numpy as np
import pytest

import jax

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep

from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.distributed.spec_layout import get_layout

import torch_dist_worker as worker
from zero_cases import (SPLIT_NORM_CASES, W2_CASES, W4_CASES, _close,
                        _jax_run, _load_case, _ranks_equal)

W2_LOAD = []


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


@pytest.fixture(scope="module", autouse=True)
def _ranks():
    """Both worlds start with the module and run beside its in-process
    tests; each is joined (bounded) where a test first needs it."""
    load, ref = _load_case()
    W2_LOAD[:] = [load, ref]
    started = {n: spawn(worker.train_cases, args=(cases,), nprocs=n,
                        backend="gloo", timeout=60, join=False)
               for n, cases in ((2, W2_CASES + [load]), (4, W4_CASES))}
    results = {}

    def get(n):
        if n not in results:
            results[n] = started[n].join(240)
        return results[n]

    yield get
    for ctx in started.values():
        ctx.close()


@pytest.fixture(scope="module")
def world2(_ranks):
    return _ranks(2)


@pytest.fixture(scope="module")
def world4(_ranks):
    return _ranks(4)


@pytest.mark.parametrize("i", range(4))
def test_world2_stages_match_jax_on_two_devices(world2, i):
    """dp 2 (no ZeRO), then fsdp 2 at stages 1, 2, 3 (the reference's
    test_dist_train_step cases) against the JAX step on two devices."""
    _ranks_equal([r[i] for r in world2])
    ref = _jax_run(W2_CASES[i], 2)
    got = world2[0][i]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5,
                               atol=2e-5)
    _close(got["params"], ref["params"], 2e-5, f"case {i}")


@pytest.mark.parametrize("i", SPLIT_NORM_CASES)
def test_world2_norms_over_split_parameters_match_jax(world2, i):
    """fsdp 2: a global-norm clip at stage 1, a per-tensor norm clip at
    stage 3, Lamb at stage 2 and Lars at stage 3, whose norms span the
    rows both ranks hold, against the JAX step on two devices."""
    _ranks_equal([r[i] for r in world2])
    ref = _jax_run(W2_CASES[i], 2)
    got = world2[0][i]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5,
                               atol=2e-5)
    _close(got["params"], ref["params"], 2e-5, f"case {i}")


def test_world2_rows_held_follow_sharded_numel(world2):
    lay = get_layout()
    sizes = {"dp": 1, "fsdp": 2}
    for i, stage in ((1, 1), (2, 2), (3, 3)):
        for r in world2:
            res = r[i]
            for n, (pn, slots) in res["held"].items():
                shape = W2_CASES[i]["weights"][n].shape
                assert pn == lay.sharded_numel(shape, res["specs"][n], sizes)
                assert slots["m"] == lay.sharded_numel(
                    shape, res["slot_specs"][n], sizes)
                if stage == 3:
                    assert "fsdp" in res["specs"][n]
                else:
                    assert pn == int(np.prod(shape))


def test_world2_bf16_amp_with_zero2_trains(world2):
    """test_amp_dist_step's case: bf16 AMP composes with ZeRO-2."""
    res = [r[4] for r in world2]
    _ranks_equal(res)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    ref = _jax_run(W2_CASES[4], 2)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=1e-2)


def test_world2_bf16_moments_stage3(world2):
    res = [r[5] for r in world2]
    _ranks_equal(res)
    assert res[0]["slot_dtypes"]["0.weight"]["m"] == "torch.bfloat16"
    ref = _jax_run(W2_CASES[5], 2)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=1e-3)


def test_world4_dp_by_fsdp_matches_jax(world4):
    res = [r[0] for r in world4]
    _ranks_equal(res)
    ref = _jax_run(W4_CASES[0], 4)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=2e-5,
                               atol=2e-5)
    _close(res[0]["params"], ref["params"], 2e-5, "dp2 x fsdp2")


def test_world4_int8_moments_dp_by_fsdp(world4):
    """test_offload_moments' int8 case on dp 2 x fsdp 2: codes and
    per-row scales a rank (a split last dim keeps whole-row scales),
    losses within 5e-2 of f32 and near the JAX int8 step."""
    res = [r[1] for r in world4]
    f32 = world4[0][2]
    _ranks_equal(res)
    r0 = res[0]
    dt = r0["slot_dtypes"]["0.weight"]
    assert dt["m"] == "torch.int8" and dt["m@scale"] == "torch.float32"
    # 0.weight [32, 64] splits its last dim: scales for all 32 rows
    assert r0["held"]["0.weight"][1]["m"] == 32 * 32
    assert r0["held"]["0.weight"][1]["m@scale"] == 32
    # 2.weight [64, 8] splits dim 0: scales for its 32 rows
    assert r0["held"]["2.weight"][1]["m@scale"] == 32
    assert r0["losses"][-1] < r0["losses"][0]
    np.testing.assert_allclose(r0["losses"], f32["losses"], rtol=5e-2)
    ref = _jax_run(W4_CASES[1], 4)
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-3)


def test_world2_ranks_load_their_rows_of_a_jax_zero3_int8_state(world2):
    """``load_jax_opt_state(..., step=)`` at fsdp 2: each rank keeps the
    rows of the JAX step's whole int8 codes and scales the spec rules
    give it (a split last dim keeps whole-row scales), the gathered state
    is the JAX state bitwise, and the next step's loss is the JAX step's
    next loss."""
    load, ref = W2_LOAD
    for r in world2:
        got = r[len(W2_CASES)]
        ld = got["loaded"]
        i = ld["fsdp_index"]
        for n, st in load["load_state"].items():
            d = [j for j, ax in enumerate(got["slot_specs"][n])
                 if ax == "fsdp"]
            for k, whole in st.items():
                np.testing.assert_array_equal(ld["whole"][n][k], whole,
                                              err_msg=f"{n}.{k}")
                want = whole
                if d and (np.ndim(whole) == len(got["slot_specs"][n])
                          or d[0] < np.ndim(whole)):
                    size = whole.shape[d[0]] // 2
                    want = np.take(whole, range(i * size, (i + 1) * size),
                                   axis=d[0])
                np.testing.assert_array_equal(ld["rows"][n][k], want,
                                              err_msg=f"{n}.{k}")
    jmesh.set_mesh(None)
    mesh = jmesh.init_mesh({"fsdp": 2}, devices=jax.devices()[:2])
    js = JStrategy()
    js.sharding = True
    js.sharding_configs = {"stage": 3, "moment_dtype": "int8"}
    m = ref["model"]
    jstep = JStep(m, lambda a, b: JF.cross_entropy(m(a), b), ref["opt"], js,
                  mesh=mesh)
    jl = float(jstep(paddle.to_tensor(load["xs"][0]),
                     paddle.to_tensor(load["ys"][0]))._value)
    assert abs(world2[0][len(W2_CASES)]["losses"][0] - jl) < 1e-5
