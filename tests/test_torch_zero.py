"""The port's ZeRO (``strategy.sharding`` stages 1-3, ``moment_dtype``,
``offload``) in ``DistributedTrainStep``, its spec rules and q8 codec,
and optimizer state carried across, against the JAX reference.

This file holds the in-process cases (world 1: no process group);
``tests/test_torch_zero_ranks.py`` holds the port's ranks as gloo
processes on the CPU (two, then four) against the JAX step on its host
mesh restricted to as many devices (the configurations:
``tests/zero_cases.py``).  Tolerances:

- the spec rules (``zero3_augment``, ``moment_spec``, ``sharded_numel``,
  ``batch``) equal ``SpecLayout``'s entry for entry;
- the q8 codec bitwise JAX's (codes, scales and decoded values): both
  take the correctly rounded f32 square root;
- at world 1 (no process group) every stage bitwise the port's plain
  step, and within rtol / atol 2e-4 of the JAX step (the reference's own
  bound between its sharded and one-device runs);
- at world 2 and 4 the ranks' parameters bitwise equal, and within rtol
  / atol 2e-5 of the JAX step on the same mesh (f32; the mean of the
  ranks' gradients sums in another order); int8 and bf16 slots train
  within 5e-2 of f32 (the reference's bound) and hold ``sharded_numel``
  elements a rank.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.distributed.fleet import dist_step as jds
from paddle_tpu.distributed.planner.spec_layout import SpecLayout

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)
from paddle_tpu_torch.optimizer import slot_codec as tcodec
from paddle_tpu_torch.distributed.spec_layout import get_layout
from paddle_tpu_torch.framework.io import (load_jax_opt_state,
                                           opt_state_arrays)
from paddle_tpu_torch.optimizer import AdamW

import torch_dist_worker as worker
from zero_cases import _case, _close, _jax_run


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


def _llama_shapes(cfg):
    from paddle_tpu.framework import core
    from paddle_tpu.text.models import LlamaForCausalLM
    with core.abstract_init():
        m = LlamaForCausalLM(cfg)
    return sorted({tuple(p._value.shape) for p in m.parameters()})


@pytest.mark.parametrize("which", ["proxy", "llama_tiny"])
def test_spec_rules_match_spec_layout(which):
    from paddle_tpu.text.models import llama_tiny
    cfg = llama_tiny() if which == "llama_tiny" else llama_tiny(
        vocab_size=32000, hidden_size=2048, intermediate_size=5504,
        num_hidden_layers=8, num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=2048, scan_layers=True, remat=True)
    shapes = _llama_shapes(cfg) + [(7,), (3, 5), ()]
    ref, port = SpecLayout(), get_layout()
    for fsdp in (1, 2, 4, 8):
        sizes = {"dp": 2, "fsdp": fsdp}
        for shape in shapes:
            z = ref.zero3_augment(shape, None, fsdp)
            assert port.zero3_augment(shape, None, fsdp) == tuple(z), shape
            for stage in (0, 1, 2, 3):
                pspec = z if stage >= 3 else ref.replicated(len(shape))
                want = ref.moment_spec(shape, None, pspec, stage, fsdp)
                got = port.moment_spec(shape, None, tuple(pspec), stage,
                                       fsdp)
                assert got == tuple(want), (shape, stage)
                assert port.sharded_numel(shape, got, sizes) == \
                    ref.sharded_numel(shape, want, sizes)
    for axes in (("dp",), ("dp", "fsdp")):
        from jax.sharding import PartitionSpec as P
        assert P(*port.batch(3, axes)) == ref.batch(3, axes)
    assert port.replicated(2) == (None, None) and port.replicated() == ()


def test_model_axis_roles_match_spec_layout():
    """The roles tp, sp and pp need (``param_spec``, ``act_axis``,
    ``stack``) and ZeRO-3 over their annotations, entry for entry the
    reference's ``SpecLayout`` on the proxy's and ``llama_tiny``'s
    stacked shapes."""
    from jax.sharding import PartitionSpec as P
    ref, port = SpecLayout(), get_layout()
    for role in ref.param_roles:
        assert sorted(port.param_roles) == sorted(ref.param_roles)
        for ndim in (None, 2, 3):
            try:
                want = ref.param_spec(role, ndim)
            except ValueError:
                with pytest.raises(ValueError):
                    port.param_spec(role, ndim)
                continue
            assert P(*port.param_spec(role, ndim)) == want, (role, ndim)
    with pytest.raises(KeyError):
        port.param_spec("nope")
    for role in ref.act_roles:
        assert port.act_axis(role) == ref.act_axis(role)
    assert port.stack_axis == ref.stack_axis == "pp"
    shapes = {(8, 2048, 2048): "attn_qkv", (8, 5504, 2048): "mlp_out",
              (8, 2048, 5504): "mlp_in", (2, 64, 64): "attn_out",
              (8, 2048): "norm", (2, 64): "norm"}
    for shape, role in shapes.items():
        inner = ref.param_spec(role, len(shape) - 1)
        want = ref.stack(tuple(inner), len(shape))
        got = port.stack(port.param_spec(role, len(shape) - 1), len(shape))
        assert P(*got) == want, shape
        for fsdp in (1, 2, 4):
            z = ref.zero3_augment(shape, tuple(want), fsdp)
            assert P(*port.zero3_augment(shape, got, fsdp)) == z
            sizes = {"fsdp": fsdp, "tp": 2, "pp": 2}
            assert port.sharded_numel(shape, tuple(z), sizes) == \
                ref.sharded_numel(shape, z, sizes)
    for role in ("embedding", "logits", "col_linear", "row_linear"):
        shape = (32000, 2048) if role == "embedding" else (2048, 32000)
        ann = port.param_spec(role, 2)
        for fsdp in (2, 8):
            assert P(*port.zero3_augment(shape, ann, fsdp)) == \
                ref.zero3_augment(shape, tuple(ref.param_spec(role, 2)),
                                  fsdp)


# -- the q8 codec --------------------------------------------------------

def _moments(seed, shape=(64, 128)):
    rng = np.random.RandomState(seed)
    m = (rng.randn(*shape) ** 3 * 1e-3).astype(np.float32)
    v = (np.abs(rng.randn(*shape)) ** 4 * 1e-6).astype(np.float32)
    return m, v


@pytest.mark.parametrize("round_up", [False, True])
def test_q8_codec_is_bitwise_jax(round_up):
    for seed in range(2):
        for x in _moments(seed) + (np.zeros((4, 8), np.float32),
                                   np.array([1.0, -2.5, 0.0], np.float32)):
            jq, js = jds._q8_encode(jnp.asarray(x), round_up=round_up)
            tq, ts = tcodec._q8_encode(torch.from_numpy(x), round_up=round_up)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(
                tcodec._q8_decode(tq, ts).numpy(),
                np.asarray(jds._q8_decode(jq, js)))


def test_transform_slots_matches_jax_and_keeps_v_alive():
    """The reference's hazard case: a row whose |g| spans 1 and 1e-3 must
    not decode v to 0 where m survives; encode / decode bitwise JAX's."""
    g = np.zeros((1, 128), np.float32)
    g[0, :64] = 1.0
    g[0, 64:] = 1e-3
    st_t = {"m": torch.from_numpy(g), "v": torch.from_numpy(g * g),
            "beta1_pow": torch.tensor(0.9), "beta2_pow": torch.tensor(0.999)}
    st_j = {"m": jnp.asarray(g), "v": jnp.asarray(g * g),
            "beta1_pow": jnp.asarray(0.9, jnp.float32),
            "beta2_pow": jnp.asarray(0.999, jnp.float32)}
    enc_t = tcodec._transform_slots(st_t, (1, 128), torch.int8, "encode")
    enc_j = jds._transform_slots(st_j, (1, 128), jnp.int8, "encode")
    assert sorted(enc_t) == sorted(enc_j)
    for k in enc_j:
        np.testing.assert_array_equal(np.asarray(enc_t[k]),
                                      np.asarray(enc_j[k]), err_msg=k)
    dec = tcodec._transform_slots(enc_t, (1, 128), torch.int8, "decode")
    assert sorted(dec) == ["beta1_pow", "beta2_pow", "m", "v"]
    m_dec, v_dec = dec["m"].numpy(), dec["v"].numpy()
    alive = np.abs(m_dec) > 0
    assert alive.any() and np.all(v_dec[alive] > 0)
    step = np.abs(m_dec) / (np.sqrt(np.maximum(v_dec, 0.0)) + 1e-8)
    assert float(step.max()) < 10.0
    bf = tcodec._transform_slots(st_t, (1, 128), torch.bfloat16, "encode")
    assert bf["m"].dtype == torch.bfloat16 and \
        bf["beta1_pow"].dtype == torch.float32


def test_q8_encode_decode_accuracy():
    x, _ = _moments(0)
    q, s = tcodec._q8_encode(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == (64,)
    err = np.abs(tcodec._q8_decode(q, s).numpy() - x).max(axis=1)
    assert float((err / np.maximum(np.abs(x).max(axis=1), 1e-12)).max()) \
        < 0.05


# -- world 1: no process group -------------------------------------------

@functools.lru_cache(maxsize=None)
def _plain_world1():
    return worker.train_case(_case(0))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_world1_stages_are_the_plain_step_bitwise_and_match_jax(stage):
    plain = _plain_world1()
    got = worker.train_case(_case(stage))
    assert got["losses"] == plain["losses"]
    for k, v in plain["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    ref = _jax_run(_case(stage), 1)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4,
                               atol=2e-4)
    _close(got["params"], ref["params"], 2e-4, f"stage {stage}")


@pytest.mark.parametrize("mdt", ["bfloat16", "int8"])
def test_world1_low_precision_moments_track_f32(mdt):
    """The reference's test_offload_moments cases at world 1: storage
    dtypes, scales beside int8 codes, losses within 5e-2 of f32, and the
    losses against the JAX step with the same moment dtype."""
    f32 = worker.train_case(_case(3, kind="adamw", steps=8))
    got = worker.train_case(_case(3, mdt=mdt, kind="adamw", steps=8))
    dt = got["slot_dtypes"]["0.weight"]
    assert dt["m"] == dt["v"] == f"torch.{mdt}"
    assert dt["beta1_pow"] == "torch.float32"
    if mdt == "int8":
        assert dt["m@scale"] == "torch.float32"
        assert got["held"]["0.weight"][1]["m@scale"] == 32
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], f32["losses"], rtol=5e-2)
    ref = _jax_run(_case(3, mdt=mdt, kind="adamw", steps=8), 1)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-3)


def test_moment_dtype_typo_raises_and_offload_rules():
    m = torch.nn.Linear(4, 2)
    s = DistributedStrategy()
    s.sharding_configs = {"moment_dtype": "bf61"}
    with pytest.raises(ValueError, match="moment_dtype"):
        DistributedTrainStep(m, lambda x: m(x).sum(),
                             AdamW(parameters=list(m.parameters())), s)
    s = DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"offload": True}
    with pytest.raises(NotImplementedError, match="offload"):
        DistributedTrainStep(m, lambda x: m(x).sum(),
                             AdamW(parameters=list(m.parameters())), s)
    s = DistributedStrategy()
    s.sharding_configs = {"offload": True}     # ignored without sharding
    step = DistributedTrainStep(m, lambda x: m(x).sum(),
                                AdamW(parameters=list(m.parameters())), s)
    assert step._offload is False


def test_int8_state_dict_round_trip_decodes():
    """The reference's checkpoint case: a state dict saved from an int8
    step restores as plain f32 slots, the codes decoded."""
    case = _case(3, mdt="int8", kind="adamw", steps=3)
    model = worker._mlp(case["weights"], case["sizes"], tnn.ReLU)
    opt = AdamW(learning_rate=1e-2, parameters=list(model.parameters()))
    s = DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": 3, "moment_dtype": "int8"}
    from paddle_tpu_torch.nn import functional as F
    step = DistributedTrainStep(
        model, lambda x, y: F.cross_entropy(model(x), y).mean(), opt, s)
    for x, y in zip(case["xs"], case["ys"]):
        step(torch.from_numpy(x), torch.from_numpy(y))
    st = opt.opt_state()
    sd = opt.state_dict()
    model2 = worker._mlp(case["weights"], case["sizes"], tnn.ReLU)
    opt2 = AdamW(learning_rate=1e-2, parameters=list(model2.parameters()))
    opt2.set_state_dict(sd)
    st2 = opt2.opt_state()
    assert st2[0]["m"].dtype == torch.float32 and "m@scale" not in st2[0]
    np.testing.assert_array_equal(
        st2[0]["m"].numpy(), tcodec._q8_decode(st[0]["m"],
                                            st[0]["m@scale"]).numpy())
    loss = F.cross_entropy(model2(torch.from_numpy(case["xs"][0])),
                           torch.from_numpy(case["ys"][0])).mean()
    loss.backward()
    opt2.step()


def test_load_jax_opt_state_carries_int8_and_bf16_slots():
    """A JAX step's int8 codes and scales, and its bf16 slots, load into
    the port's step bitwise, and the next step agrees."""
    for mdt in ("int8", "bfloat16"):
        case = _case(3, mdt=mdt, kind="adamw", steps=3)
        ref = _jax_run(case, 1)
        jopt, jm = ref["opt"], ref["model"]
        names = [n for n, _ in jm.named_parameters()]
        jstate = {n: {k: np.asarray(v.astype(jnp.float32)
                                    if v.dtype == jnp.bfloat16 else v)
                      for k, v in st.items()}
                  for n, st in zip(names, jopt.opt_state())}
        model = worker._mlp(case["weights"], case["sizes"], tnn.ReLU)
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(torch.from_numpy(ref["params"][k]))
        opt = AdamW(learning_rate=1e-2, parameters=list(model.parameters()))
        s = DistributedStrategy()
        s.sharding = True
        s.sharding_configs = {"stage": 3, "moment_dtype": mdt}
        from paddle_tpu_torch.nn import functional as F
        step = DistributedTrainStep(
            model, lambda x, y: F.cross_entropy(model(x), y).mean(), opt, s)
        load_jax_opt_state(opt, model, jstate, step=step)
        back = opt_state_arrays(opt, model)
        for n in names:
            for k, v in jstate[n].items():
                np.testing.assert_array_equal(back[n][k], v,
                                              err_msg=f"{mdt} {n}.{k}")
        # one more step in each package from the same state
        x, y = case["xs"][0], case["ys"][0]
        tl = float(step(torch.from_numpy(x), torch.from_numpy(y)))
        jmesh.set_mesh(None)
        mesh = jmesh.init_mesh({"dp": 1}, devices=jax.devices()[:1])
        js = JStrategy()
        js.sharding = True
        js.sharding_configs = {"stage": 3, "moment_dtype": mdt}
        jstep = JStep(jm, lambda a, b: JF.cross_entropy(jm(a), b), jopt, js,
                      mesh=mesh)
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))._value)
        assert abs(tl - jl) < 1e-5, (mdt, tl, jl)
        if mdt == "int8":
            codes = jstate
    # int8 codes into an optimizer that keeps f32 slots: decoded
    plain = AdamW(learning_rate=1e-2, parameters=list(model.parameters()))
    load_jax_opt_state(plain, model, codes)
    n0 = names[0]
    assert plain.opt_state()[0]["m"].dtype == torch.float32
    np.testing.assert_array_equal(
        plain.opt_state()[0]["m"].numpy(),
        np.asarray(jds._q8_decode(jnp.asarray(codes[n0]["m"]),
                                  jnp.asarray(codes[n0]["m@scale"]))))


# -- world 2 and 4: gloo ranks -------------------------------------------
